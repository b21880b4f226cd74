"""Architecture + shape configuration system.

Each assigned architecture gets one module in this package defining CONFIG
(exact published sizes) and SMOKE (a reduced same-family config for CPU
tests).  Shapes are the four assigned input-shape cells; applicability per
family follows DESIGN.md §6.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# the archs this package carries so far: every family but encoder-decoder
ARCH_IDS = ("llama3_2_1b", "minitron_4b", "phi3_5_moe_42b_a6_6b",
            "qwen3_32b", "qwen3_moe_235b_a22b", "stablelm_3b",
            "xlstm_125m", "jamba_v0_1_52b", "paligemma_3b")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    # SSM / hybrid
    ssm_state: int = 16
    conv_dim: int = 4
    # encoder-decoder
    encoder_layers: int = 0
    # VLM / audio stub frontend: number of prefix embeddings
    prefix_embed: int = 0
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # execution knobs
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots (save matmul outputs)
    moe_combine_dtype: str = "f32"  # f32 | bf16 (halves EP combine traffic)
    moe_dispatch_a2a: bool = False  # reshard x_ec batch->contract via a2a
    decode_score_shard: bool = False  # flash-decoding: pin scores S-sharded
    attn_chunk: int = 2048          # flash KV chunk (train/prefill)
    # decode-prefetch pipeline for streamed weights (runtime/overlap.py):
    # off | on | auto (auto == on whenever streamed leaves are present)
    overlap: str = "auto"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can serve long_500k (O(1)/O(chunk) decode state, no full-attn KV
        explosion at 500k — see DESIGN.md §6)."""
        return self.family in ("ssm", "hybrid")

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs autoregress (whisper via decoder)

    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """(applicable, reason-if-not). long_500k needs sub-quadratic decode."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "SKIP(full-attn): 500k KV decode assigned only to SSM/hybrid"
    return True, ""


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE
