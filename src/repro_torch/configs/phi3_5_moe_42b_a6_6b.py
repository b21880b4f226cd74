"""Phi-3.5-MoE-42B-A6.6B [moe]: 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 per expert, vocab=32064, 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064, head_dim=128,
    n_experts=16, experts_per_token=2, moe_d_ff=6400, rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, moe_d_ff=64, n_experts=4, experts_per_token=2, vocab_size=512,
    scan_layers=False, remat=False)
