"""Whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536
vocab=51865 — enc-dec; conv audio frontend is a STUB (input_specs feeds
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384, n_heads=6,
    n_kv_heads=6, d_ff=1536, vocab_size=51865, head_dim=64,
    encoder_layers=4, rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=2,
    n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=512,
    scan_layers=False, remat=False)
