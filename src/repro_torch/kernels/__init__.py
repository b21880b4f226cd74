"""Kernels of the PyTorch port: hand-written CUDA for Hopper beside their
plain PyTorch versions (counterpart of ``repro.kernels``)."""
from . import ops, ref  # noqa: F401
from .ops import (compress_kv_prefix, decode_attention_kv_enec, decode_blocks,
                  decompress_matmul, encode_blocks, idd_scan)

__all__ = ["ops", "ref", "decode_blocks", "decompress_matmul",
           "encode_blocks", "idd_scan", "compress_kv_prefix",
           "decode_attention_kv_enec"]
