"""Lossless ENEC gradient sync over a mesh axis (port of
``repro/optim/grad_compress.py``).

Where an axis rides slow links, the gradient all-reduce can carry ENEC
streams instead of dense values.  Because ENEC is lossless, the sync is
bit-identical to a plain rank-ordered sum: no accuracy or convergence
caveat, unlike lossy 1-bit / top-k schemes.

    local gradient
      -> ENEC-encode (block streams; kernel 4 on the card)
      -> gather every rank's streams over the axis (compressed bytes only)
      -> decode all of them in one launch (kernel 1), sum in rank order

:func:`compressed_allreduce` is the primitive, over any one mesh axis: on
the reference's pod-DP layout the sync over "pod" (the slow links
between pods, ``runtime/sharding.py``) is where it applies.  The
reference's train step does not call it (its pjit reduction syncs the
gradients over ("pod", "data")), and neither does the port's
(``runtime/steps.py`` sums them dense, in rank order over the batch's
axes, pod-major).
"""
from __future__ import annotations

import torch

from repro_torch.core import codec as block_codec
from repro_torch.core.codec_api import current_codec
from repro_torch.core.dtypes import format_for, to_bits
from repro_torch.core.params import EnecParams
from repro_torch.kernels import ops
from repro_torch.runtime.collectives import gather_rows


def rank_ordered_sum(parts) -> torch.Tensor:
    """``sum(parts)`` in f32 in the order given, so the bits do not depend
    on the schedule.  It starts from the first part, as the reference's
    jitted sum does (XLA drops its add of zeros): a negative zero stays
    negative."""
    total = parts[0].float()
    for part in parts[1:]:
        total = total + part.float()
    return total


def compressed_allreduce(x: torch.Tensor, mesh, axis: str, p: EnecParams,
                         block_elems: int = 16384, codec=None
                         ) -> torch.Tensor:
    """All-reduce ``x`` over ``axis`` of ``mesh`` with ENEC-compressed
    transport: every rank of the axis calls it with a tensor of the same
    shape and dtype, and the same ``p`` (searched offline on a gradient
    sample).  Returns the rank-ordered f32 sum cast to ``x.dtype``, the
    same bits on every rank.  Counts ``(n - 1) x`` this rank's stream
    bytes on the ``d2d_psum`` link of ``codec`` (the ambient one by
    default), one op a stream array, as the reference counts it."""
    fmt = format_for(x.dtype)
    bits = block_codec.to_blocks(to_bits(x), block_elems)
    streams = ops.encode_blocks(bits, fmt, p)
    n = mesh.shape.get(axis, 1)
    (codec or current_codec()).count_link(
        "d2d_psum", (n - 1) * sum(a.numel() * a.element_size()
                                  for a in streams), ops=len(streams))
    gathered = gather_rows(streams, mesh, axis)
    decoded = ops.decode_blocks(gathered, block_elems, fmt, p)
    parts = decoded.reshape(n, -1)[:, :x.numel()].view(fmt.float_dtype)
    return rank_ordered_sum(parts.reshape(n, *x.shape)).to(x.dtype)


def wire_bytes_saved(x: torch.Tensor, p: EnecParams) -> dict:
    """Estimate of the per-step traffic with and without compression."""
    fmt = format_for(x.dtype)
    raw = x.numel() * x.element_size()
    comp = raw / max(fmt.total_bits /
                     (p.expected_bits + fmt.raw_bits), 1e-9) \
        if p.expected_bits else raw
    return {"raw_bytes": raw, "compressed_bytes": int(comp),
            "ratio": raw / max(comp, 1)}
