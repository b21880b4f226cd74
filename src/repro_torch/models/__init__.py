"""Decoder LM families of the PyTorch port (counterpart of
``repro.models``)."""
from .registry import (Model, abstract_params, active_param_count,  # noqa: F401
                       build_model, cache_specs, param_count)
