"""Inference engine of the PyTorch port."""
