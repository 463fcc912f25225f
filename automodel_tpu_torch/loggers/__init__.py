"""Logging set-up of the PyTorch port."""
