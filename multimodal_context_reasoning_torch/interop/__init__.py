"""Weight interop of the PyTorch port."""
