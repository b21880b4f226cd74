"""Minitron-4B [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron. [arXiv:2407.14679; hf]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=9216, vocab_size=256000, head_dim=128,
    rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, head_dim=32,
    d_ff=192, vocab_size=512, scan_layers=False, remat=False)
