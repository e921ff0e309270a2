"""Transformer modules of the PyTorch port."""
