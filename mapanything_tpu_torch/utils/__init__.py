"""Inference pipeline and weight conversion of the PyTorch port."""
