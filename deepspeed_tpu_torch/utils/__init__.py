"""Utilities of the PyTorch port."""
