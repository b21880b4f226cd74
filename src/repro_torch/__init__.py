"""PyTorch/CUDA port of the ENEC reproduction (counterpart of ``repro``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``.  There is no automatic CPU path: on a machine without a
GPU the default device raises instead of carrying on elsewhere.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (or --device cpu) explicitly")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev
