"""frontend package of the PyTorch port."""
