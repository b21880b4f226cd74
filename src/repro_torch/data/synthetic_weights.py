"""Synthetic model-weight generators matching the paper's §III statistics
(port of ``repro/data/synthetic_weights.py``, with the same numpy draws).

The Table II/III datasets are emulated without any download: per-tensor
Gaussian bulk with moderate per-row scale mixing (trained-weight heavy
tails) plus a rare large-outlier population (the red circle of Fig. 3).
Calibrated so the BF16 sets reproduce the paper's searched parameters
(b≈121-123, n=6, m=3, L=16) and ratios (≈1.35).

Each entry mirrors one row of Table III (name, dtype, relative size).
The f32 draws are cast to the set's dtype with round-to-nearest-even, as
the reference's ``jnp.asarray(w32).astype(...)`` does, so both packages
hold the same bytes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class WeightSetSpec:
    name: str
    dtype: str          # bf16 | fp16 | fp32
    n_elems: int
    bulk_scale: float = 0.015
    row_sigma: float = 0.6      # lognormal sigma of per-row scales
    outlier_frac: float = 2e-3  # Fig. 3 red-circle population
    outlier_gain: float = 64.0
    seed: int = 0


# the paper's Table III datasets (sizes scaled down ~2000x; ratios are
# size-independent per Table VI)
PAPER_MODELS = [
    WeightSetSpec("Falcon-7B", "bf16", 4 << 20, seed=1),
    WeightSetSpec("Qwen3-8B", "bf16", 4 << 20, seed=2),
    WeightSetSpec("deepseek-llm-7b-base", "bf16", 4 << 20, seed=3),
    WeightSetSpec("Qwen3-32B", "bf16", 8 << 20, seed=4),
    WeightSetSpec("Llama-3.1-8B-Instruct", "bf16", 4 << 20, seed=5),
    WeightSetSpec("CapybaraHermes-2.5-Mistral-7B", "fp16", 4 << 20, seed=6),
    WeightSetSpec("stable-video-diffusion-img2vid", "fp16", 2 << 20, seed=7,
                  row_sigma=1.0, outlier_frac=5e-3),
    WeightSetSpec("OLMo-1B-hf", "fp32", 2 << 20, seed=8),
    WeightSetSpec("bert-base-uncased", "fp32", 1 << 20, seed=9),
    WeightSetSpec("wav2vec2-large-xlsr-53-english", "fp32", 1 << 20, seed=10),
]

DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
          "fp32": torch.float32}


def generate(spec: WeightSetSpec, device="cuda") -> torch.Tensor:
    """The set's weights: a 1-D tensor of ``spec.n_elems`` elements in its
    dtype on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(spec.seed)
    rows = max(1, spec.n_elems // 4096)
    scales = np.exp(rng.standard_normal(rows) * spec.row_sigma) \
        * spec.bulk_scale
    w = rng.standard_normal((rows, 4096)) * scales[:, None]
    w = w.reshape(-1)[: spec.n_elems]
    out_idx = rng.random(spec.n_elems) < spec.outlier_frac
    w[out_idx] *= spec.outlier_gain
    w32 = torch.from_numpy(w.astype(np.float32))
    return w32.to(DTYPES[spec.dtype]).to(dev)


def by_name(name: str) -> WeightSetSpec:
    for s in PAPER_MODELS:
        if s.name == name:
            return s
    raise KeyError(name)
