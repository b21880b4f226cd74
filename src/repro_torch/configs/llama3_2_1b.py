"""Llama-3.2-1B [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256. [hf:meta-llama/Llama-3.2-1B; unverified]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense", n_layers=16, d_model=2048, n_heads=32,
    n_kv_heads=8, d_ff=8192, vocab_size=128256, head_dim=64,
    rope_theta=5e5, tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, scan_layers=False, remat=False)
