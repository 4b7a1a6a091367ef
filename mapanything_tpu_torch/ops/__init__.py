"""Attention, resize and quantile operations of the PyTorch port."""
