"""StableLM-3B [dense]: 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=6912, vocab_size=50304, head_dim=80,
    rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, scan_layers=False, remat=False)
