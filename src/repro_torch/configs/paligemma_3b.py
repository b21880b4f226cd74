"""PaliGemma-3B [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP frontend is a STUB (input_specs feeds precomputed
patch embeddings as a bidirectional prefix). [arXiv:2407.07726; hf]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048, n_heads=8,
    n_kv_heads=1, d_ff=16384, vocab_size=257216, head_dim=256,
    prefix_embed=256, tie_embeddings=True, rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512, prefix_embed=8, scan_layers=False, remat=False)
