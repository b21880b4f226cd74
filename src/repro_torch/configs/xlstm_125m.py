"""xLSTM-125M [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (3:1), attention-free, O(1) decode state -> runs long_500k.
[arXiv:2405.04517; unverified]"""
import dataclasses
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab_size=50304, head_dim=192, rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    vocab_size=512, scan_layers=False, remat=False)
