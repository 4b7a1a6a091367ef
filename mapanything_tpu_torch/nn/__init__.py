"""Network modules of the PyTorch port."""
