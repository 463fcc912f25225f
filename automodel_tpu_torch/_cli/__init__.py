"""Command-line entry point of the PyTorch port."""
