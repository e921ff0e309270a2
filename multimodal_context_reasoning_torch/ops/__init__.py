"""Attention, mask and chunk operations of the PyTorch port."""
