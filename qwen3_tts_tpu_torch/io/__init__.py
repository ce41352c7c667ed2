"""io package of the PyTorch port."""
