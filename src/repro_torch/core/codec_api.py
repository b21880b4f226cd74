"""The codec object (subset of ``repro/core/codec_api.py``).

:class:`Codec` compresses layer stacks and fused-matmul tile streams and
decompresses tensors.  It encodes one stack per pass with the plain codec
(set-up work, on the tensor's device) and decodes one tensor per launch of
the ENEC decoder (``kernels.ops.decode_blocks``: the CUDA kernel for a
CUDA tensor, the plain version for a CPU one).  ``decode_launches`` counts
this codec's decodes.  The reference's plan/execute bucketing, which
batches many tensors into one launch, is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from . import codec as block_codec
from . import params as params_mod
from . import stats as stats_mod
from .api import (SUPPORTED_FLOAT_DTYPES, CompressedTensor,
                  const_tensor, matmul_tiles, raw_tensor)
from .api import untile_matmul_weight as _untile
from .dtypes import DTYPE_NAMES, format_for, to_bits
from .params import DEFAULT_BLOCK_ELEMS, EnecParams


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Immutable policy of one :class:`Codec`: the default ENEC block
    size (paper §VI-D: 16384 == one 128x128 tile).  Parameters are
    searched per tensor from its exponent histogram."""
    block_elems: int = DEFAULT_BLOCK_ELEMS

    def __post_init__(self):
        if self.block_elems < 1:
            raise ValueError("block_elems must be >= 1")


class Codec:
    """One ENEC codec: config plus its decode launch counter."""

    def __init__(self, config: Optional[CodecConfig] = None, **overrides):
        if config is None:
            config = CodecConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.decode_launches = 0

    def __repr__(self):
        return f"Codec(block_elems={self.config.block_elems})"

    # -- encode -----------------------------------------------------------

    def _compress_stack(self, x: torch.Tensor, p: Optional[EnecParams],
                        block_elems: int, shards: int
                        ) -> Optional[CompressedTensor]:
        if x.ndim < 1 or x.dtype not in SUPPORTED_FLOAT_DTYPES \
                or x.numel() == 0:
            return None
        fmt = format_for(x.dtype)
        bits2d = to_bits(x.reshape(x.shape[0], -1))
        st = stats_mod.stack_stats(bits2d, fmt)
        if st.is_const.any():
            return None      # a constant layer keeps the whole stack dense
        pi = (params_mod.search(st.hist, fmt, block_elems=block_elems)
              if p is None else p)
        pi = params_mod.widen_for_range(pi, *st.bounds())
        blocks, per_layer = block_codec.stacked_blocks(
            bits2d, block_elems, shards, pad_value=pi.b << fmt.mant_bits)
        del bits2d
        streams = block_codec.encode_blocks(blocks, fmt, pi)
        n_layers = x.shape[0]
        lead = ((n_layers, shards, per_layer // shards) if shards > 1
                else (n_layers, per_layer))
        streams = streams.map(lambda a: a.reshape(lead + a.shape[1:]))
        ct = CompressedTensor(
            streams=streams, raw_bytes=None, fmt_name=fmt.name, params=pi,
            shape=tuple(x.shape[1:]), dtype_str=DTYPE_NAMES[x.dtype],
            block_elems=block_elems, shards=shards, mode="enec")
        # never-worse escape: streams that do not beat raw bytes stay dense
        if ct.nbytes_wire() >= n_layers * ct.nbytes_raw():
            return None
        return ct

    def compress_stacked_many(self, stacks: Sequence[torch.Tensor],
                              p: Optional[EnecParams] = None,
                              block_elems: Optional[int] = None,
                              shards: int = 1
                              ) -> List[Optional[CompressedTensor]]:
        """Compress ``(L, ...)`` layer stacks; ``None`` entries must stay
        dense (unsupported dtype, a constant layer, or incompressible).
        ``p`` fixes the parameters (widened to each stack's exponent
        range) instead of searching them."""
        block_elems = block_elems or self.config.block_elems
        return [self._compress_stack(x, p, block_elems, shards)
                for x in stacks]

    def compress_array(self, x: torch.Tensor,
                       p: Optional[EnecParams] = None,
                       block_elems: Optional[int] = None,
                       shards: int = 1) -> CompressedTensor:
        """Compress one tensor; escapes become const / raw tensors."""
        block_elems = block_elems or self.config.block_elems
        if x.dtype not in SUPPORTED_FLOAT_DTYPES or x.numel() == 0:
            return raw_tensor(x, shards)
        fmt = format_for(x.dtype)
        flat = to_bits(x.reshape(1, -1))
        st = stats_mod.stack_stats(flat, fmt)
        if bool(st.is_const[0]):
            return const_tensor(int(st.first[0]), x, fmt, block_elems,
                                shards)
        ct = self._compress_stack(x.reshape(1, -1), p, block_elems, shards)
        if ct is None:
            return raw_tensor(x, shards)
        return dataclasses.replace(ct, streams=ct.streams.map(lambda a: a[0]),
                                   shape=tuple(x.shape))

    def tile_weights_for_fusion_many(self, ws: Sequence[torch.Tensor],
                                     p: Optional[EnecParams] = None,
                                     shards: int = 1
                                     ) -> List[Optional[CompressedTensor]]:
        """Compress (L, K, N) / (K, N) matmul weights tile-wise for the
        fused kernel.  ``shards > 1`` splits each layer's n-major tile axis
        into contiguous ranges; the tile count must divide by ``shards``
        (pad blocks would corrupt the kernel's flat tile order)."""
        tiles = [matmul_tiles(w) for w in ws]
        if shards > 1:
            for w, t in zip(ws, tiles):
                blocks = t.shape[-1] // DEFAULT_BLOCK_ELEMS
                if blocks % shards:
                    raise ValueError(
                        f"fused tile stream of {tuple(w.shape)} has "
                        f"{blocks} tile blocks — not divisible into "
                        f"{shards} shards")
        return self.compress_stacked_many(
            tiles, p=p, block_elems=DEFAULT_BLOCK_ELEMS, shards=shards)

    # -- decode -----------------------------------------------------------

    def decompress_array(self, ct: CompressedTensor) -> torch.Tensor:
        """Exact inverse of compression for one (per-layer or L=1) tensor:
        one decoder launch over all of its blocks."""
        from repro_torch.kernels import ops   # kernels import core
        dtype = getattr(torch, ct.dtype_str)
        if ct.mode == "const":
            return ct.raw_bytes.view(dtype)[0].expand(ct.shape)
        if ct.mode == "raw":
            return ct.raw_bytes.view(dtype).reshape(ct.shape)
        self.decode_launches += 1
        bits = ops.decode_blocks(block_codec.flatten_blocks(ct.streams),
                                 ct.block_elems, ct.fmt, ct.params)
        return block_codec.from_blocks(bits, ct.shape, ct.fmt)

    def untile_matmul_weight(self, ct: CompressedTensor, k: int,
                             n: int) -> torch.Tensor:
        """Dense (k, n) weight of ONE layer slice of a tile-wise tensor."""
        return _untile(self.decompress_array(ct), k, n)


_DEFAULT: Optional[Codec] = None


def default_codec() -> Codec:
    """The process-default codec, used where a caller passes none."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Codec()
    return _DEFAULT
