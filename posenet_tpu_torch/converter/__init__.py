"""Checkpoint readers for the PyTorch port."""
