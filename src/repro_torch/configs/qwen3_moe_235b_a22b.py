"""Qwen3-MoE-235B-A22B [moe]: 94L d_model=4096 64H (GQA kv=4)
moe_d_ff=1536, vocab=151936, 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab_size=151936, head_dim=128,
    qk_norm=True, n_experts=128, experts_per_token=8, moe_d_ff=1536,
    rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, moe_d_ff=64, n_experts=8, experts_per_token=2, vocab_size=512,
    scan_layers=False, remat=False)
