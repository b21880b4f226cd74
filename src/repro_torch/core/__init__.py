"""ENEC codec core of the PyTorch port (counterpart of ``repro.core``).

The v1 public API is :class:`Codec` / :class:`CodecConfig` with the
plan/execute split (``plan_encode`` / ``plan_decode`` / ``execute``) and
the tree-level methods (``compress_tree`` / ``decompress_tree``,
``compress_stacked``, ``tile_weights_for_fusion``, ``configure``), plus the
stateless utilities below.  The reference's deprecated module-level
wrappers (its ``DEPRECATED_WRAPPERS``) are not part of the port: their
work is done by the codec's methods.
"""
from .api import (CompressedTensor, abstract_compressed, matmul_tiles,
                  precompute_wire_bytes, slice_stacked, tree_ratio)
from .codec import BlockStreams, decode_blocks, encode_blocks
from .codec_api import (BACKENDS, Codec, CodecConfig, DecodeBucket,
                        DecodePlan, EncodeBucket, EncodePlan, current_codec,
                        default_codec, set_default_codec, use_codec)
from .dtypes import BF16, FORMATS, FP16, FP32, FloatFormat, format_for
from .params import (DEFAULT_BLOCK_ELEMS, EnecParams, expected_ratio, search,
                     search_for_array)
from .stats import StackStats, exponent_histogram_device, stack_stats

__all__ = [
    # -- v1 public API: instance-scoped codec + plan/execute --------------
    "BACKENDS", "Codec", "CodecConfig",
    "DecodeBucket", "DecodePlan", "EncodeBucket", "EncodePlan",
    "current_codec", "default_codec", "set_default_codec", "use_codec",
    # -- data model + stateless utilities ---------------------------------
    "CompressedTensor", "abstract_compressed", "matmul_tiles",
    "precompute_wire_bytes", "slice_stacked", "tree_ratio",
    # -- block codec / formats / params / stats ----------------------------
    "BlockStreams", "decode_blocks", "encode_blocks",
    "BF16", "FORMATS", "FP16", "FP32", "FloatFormat", "format_for",
    "DEFAULT_BLOCK_ELEMS", "EnecParams", "expected_ratio", "search",
    "search_for_array",
    "StackStats", "exponent_histogram_device", "stack_stats",
]
