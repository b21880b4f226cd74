"""Qwen3-32B [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA, head_dim=128. [hf:Qwen/Qwen3-8B; hf]

This is also the paper's own flagship evaluation model (Table II/IV/V and
the Fig. 10 end-to-end inference study use Qwen3-32B).
"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_ff=25600, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, scan_layers=False, remat=False)
