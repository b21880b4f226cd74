"""Device routing of the port's kernels (counterpart of
``repro/kernels/ops.py``).

A tensor on the CPU goes to the kernel's plain version; a tensor on CUDA
goes to the kernel, and the kernel's wrapper raises on what it cannot take.
Nothing falls back from one to the other.  A ``meta`` tensor goes to the
kernel's cost route (``kernels/cost.py``): empty outputs of the kernel's
shapes and its launches, FLOPs and bytes added to a record, for the
dry-run; it reaches neither the plain version nor the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import CompressedTensor
from repro_torch.core.codec import BlockStreams
from repro_torch.core.dtypes import FloatFormat, to_container
from repro_torch.core.params import EnecParams

from . import decode_attention_kv as dak
from . import decompress_matmul as dm
from . import cost, enec_decode, enec_encode, ref
from . import idd_scan as scan
from .decode_attention_kv import compress_kv_prefix  # noqa: F401


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def encode_blocks(bits: torch.Tensor, fmt: FloatFormat, p: EnecParams,
                  b_vec=None) -> BlockStreams:
    """Encode (B, N) float bit patterns -> flat (B, ...) streams; ``b_vec``
    ((B,) int32) overrides ``p.b`` per block."""
    if cost.is_meta(bits):
        return cost.encode_blocks(bits, fmt, p, b_vec)
    if _on_cpu(bits):
        return ref.encode_blocks_ref(bits, fmt, p, b_vec)
    if bits.dtype != fmt.bits_dtype:
        bits = to_container(bits, fmt)
    if b_vec is None:
        b_vec = torch.full((bits.shape[0],), p.b, dtype=torch.int32,
                           device=bits.device)
    return enec_encode.encode_blocks_cuda(bits.contiguous(), fmt, p,
                                          b_vec.to(torch.int32).contiguous())


def decode_blocks(streams: BlockStreams, n_elems: int, fmt: FloatFormat,
                  p: EnecParams, b_vec=None, l_vec=None,
                  out=None) -> torch.Tensor:
    """Decode flat (B, ...) streams -> (B, N) bit containers, into ``out``
    when one is given."""
    if cost.is_meta(streams.mask):
        return cost.decode_blocks(streams, n_elems, fmt, out)
    if _on_cpu(streams.mask):
        bits = ref.decode_blocks_ref(streams, n_elems, fmt, p, b_vec, l_vec)
        return bits if out is None else out.copy_(bits)
    nblocks, dev = streams.mask.shape[0], streams.mask.device
    if b_vec is None:
        b_vec = torch.full((nblocks,), p.b, dtype=torch.int32, device=dev)
    if l_vec is None:
        l_vec = torch.full((nblocks,), p.l, dtype=torch.int32, device=dev)
    return enec_decode.decode_blocks_cuda(streams, n_elems, fmt, p, b_vec,
                                          l_vec, out=out)


def decompress_matmul(x: torch.Tensor, ct: CompressedTensor, k: int,
                      n: int) -> torch.Tensor:
    """x @ W with W resident only in ENEC tile streams."""
    if cost.is_meta(x):
        return cost.decompress_matmul(x, ct, k, n)
    if _on_cpu(x):
        return ref.decompress_matmul_ref(x, ct, k, n)
    return dm.decompress_matmul_cuda(x, ct, k, n)


def _tiled(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if cost.is_meta(x):
        return cost.dense_matmul(x, w)
    if _on_cpu(x):
        return ref.tiled_matmul_ref(x, w)
    return dm.dense_matmul_cuda(x, w)


class TiledMatmul(torch.autograd.Function):
    """The canonical tiled matmul with a backward through the same entry
    (the dense-tile kernel on the card, which takes any strides of its
    weight; ``tiled_matmul_ref`` on the CPU): ``dX = dY @ W.T`` and
    ``dW = X.T @ dY``, each with the f32 ``dY`` as it comes (an f32 weight
    operand keeps the kernel's ``fmaf`` chain), cast to the operand's
    dtype as the reference's gradients are."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        # on meta, the steps a time loop's one step stands for
        # (``cost.repeated``): its backward launches count as many
        ctx.repeat = cost.repeat_factor()
        return _tiled(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        with cost.repeated(ctx.repeat):
            if ctx.needs_input_grad[0]:
                dx = _tiled(dy, w.T).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _tiled(x.T.contiguous(), dy).to(w.dtype)
        return dx, dw


# the product tapes of the rematerialised regions being run
# (``models/remat.py``), innermost last
TAPES: list = []


def tiled_matmul(x: torch.Tensor, w: torch.Tensor,
                 saveable: bool = False) -> torch.Tensor:
    """x @ w in the canonical tiled schedule (dense weights); under
    autograd (an operand that requires grad) through :class:`TiledMatmul`,
    whose backward runs the same schedule.  Inside a rematerialised region
    the region's tape runs it (``models/remat.py``); ``saveable`` marks a
    product whose output the ``dots`` policy may keep."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if TAPES:
            return TAPES[-1].product(x, w, saveable)
        return TiledMatmul.apply(x, w)
    return _tiled(x, w)


def idd_scan(x: torch.Tensor) -> torch.Tensor:
    """Batched inclusive prefix sum: (B, N) int32 or bool, N % 128 == 0 ->
    (B, N) int32."""
    scan.check_shape(x)
    if cost.is_meta(x):
        return cost.idd_scan(x)
    if _on_cpu(x):
        return ref.idd_scan_ref(x)
    return scan.idd_scan_cuda(x)


def decode_attention_kv_enec(q: torch.Tensor, k_streams: BlockStreams,
                             v_streams: BlockStreams,
                             p: EnecParams) -> torch.Tensor:
    """q (B, KV, grp, 128) attends over the K/V prefix held as ENEC streams
    (B, KV, C, width) from :func:`compress_kv_prefix` -> (B, KV, grp, 128)
    f32."""
    if cost.is_meta(q):
        return cost.decode_attention_kv(q, k_streams, v_streams)
    if _on_cpu(q):
        return ref.decode_attention_kv_ref(q, k_streams, v_streams, p)
    return dak.decode_attention_kv_enec_cuda(q, k_streams, v_streams, p)
