"""Layers of the PyTorch port."""
