"""Checkpointing of the PyTorch port (counterpart of ``repro.checkpoint``)."""
