"""Launchers of the PyTorch port."""
