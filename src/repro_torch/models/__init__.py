"""Dense decoder LM of the PyTorch port (counterpart of ``repro.models``)."""
from .registry import Model, build_model  # noqa: F401
