"""Jamba-v0.1-52B [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536, MoE 16 experts top-2 every other layer, Mamba:attn 7:1
interleave (period 8, attention at position 4). O(1)-state Mamba layers +
only 4 attention layers -> runs long_500k. [arXiv:2403.19887; hf]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536, head_dim=128,
    n_experts=16, experts_per_token=2, moe_d_ff=14336, ssm_state=16,
    conv_dim=4, rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=128, moe_d_ff=128, n_experts=4, experts_per_token=2, vocab_size=512,
    ssm_state=4, scan_layers=False, remat=False)
