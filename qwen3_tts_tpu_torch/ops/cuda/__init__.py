"""cuda package of the PyTorch port."""
