"""Weight-execution handles (port of ``repro/runtime/weights.py``).

Every big weight leaf is served in one of three modes:

  dense    :class:`DenseWeight`     raw weight resident on the device
  stream   :class:`StreamedWeight`  ENEC streams on the device, decoded to
                                    a dense weight inside the step
  fused    :class:`FusedWeight`     ENEC tile streams decoded inside the
                                    matmul kernel; the dense weight never
                                    exists in device memory

Every mode's ``matmul`` realises the same contraction: on the card the
fused kernel on compressed tiles, or its dense-tile entry on a dense /
just-decoded weight; on the CPU the plain ``tiled_matmul_ref``.  So logits
are bitwise equal across modes on each device.

Handles hold tensors with a leading ``(L,)`` layer dim; the model's layer
loop takes one layer with :meth:`WeightHandle.layer`.  Decodes go through
the ambient codec (``core.codec_api.current_codec``) unless one is passed.
Under an ambient serving mesh (``runtime/collectives.py``) every use of a
compressed handle first gathers its stream shards from the other ranks as
compressed bytes (``maybe_gather_ct``).

:func:`handle_spec` / :func:`handle_from_spec` turn a compressed handle
into the JSON metadata of a checkpoint record and back, around streams
read straight from the wire.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.api import (CompressedTensor, slice_stacked,
                                  tree_map_with_path, untile_matmul_weight)
# the tree walk lives in core (the codec's tree API walks it too); the
# runtime's modules take it from here
from repro_torch.core.api import tree_leaves  # noqa: F401
from repro_torch.core.codec_api import current_codec
from repro_torch.kernels import ops


class WeightHandle:
    """Base of the weight-execution handles: ``matmul(x2d) -> (M, N) f32``
    and ``materialize() -> (K, N)`` (bit-exact: ENEC is lossless)."""

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def materialize(self, codec=None) -> torch.Tensor:
        raise NotImplementedError

    def layer(self, i: int) -> "WeightHandle":
        raise NotImplementedError


@dataclasses.dataclass
class DenseWeight(WeightHandle):
    """Raw weight executed through the canonical serve matmul."""
    w: torch.Tensor        # (..., K, N); leading (L,) when stacked

    def materialize(self, codec=None):
        return self.w

    def matmul(self, x):
        return ops.tiled_matmul(x, self.w)

    def layer(self, i):
        return DenseWeight(w=self.w[i])


@dataclasses.dataclass
class StreamedWeight(WeightHandle):
    """A weight stored as per-layer ENEC streams in the
    ``moveaxis(tp_axis -> 0)`` layout.  ``execution="matmul"`` leaves run
    the canonical contraction on the just-decoded weight; "materialize"
    leaves are decoded before the layer runs.  ``flat`` marks a 2-D leaf
    (embed) stored as an L=1 stack; it is never sliced per layer."""
    ct: CompressedTensor
    tp_axis: int
    layer_shape: tuple
    dtype_str: str
    execution: str = "materialize"
    flat: bool = False

    def materialize(self, codec=None):
        # under a serving mesh the shards are gathered as compressed bytes
        # first, then one local decode runs on every rank
        from repro_torch.runtime.collectives import maybe_gather_ct
        w_perm = (codec or current_codec()).decompress_array(
            maybe_gather_ct(self.ct, codec))
        return torch.movedim(w_perm, 0, self.tp_axis).to(
            getattr(torch, self.dtype_str))

    def matmul(self, x):
        return ops.tiled_matmul(x, self.materialize())

    def layer(self, i):
        return dataclasses.replace(self, ct=slice_stacked(self.ct, i))


@dataclasses.dataclass
class FusedWeight(WeightHandle):
    """A (L, K, N) matmul weight stored as ENEC tile streams, executed by
    the fused decode+matmul kernel.  ``k``/``n`` are the unpadded dims."""
    ct: CompressedTensor
    k: int
    n: int
    dtype_str: str

    def matmul(self, x):
        from repro_torch.runtime.collectives import maybe_gather_ct
        return ops.decompress_matmul(x, maybe_gather_ct(self.ct), self.k,
                                     self.n)

    def materialize(self, codec=None):
        from repro_torch.runtime.collectives import maybe_gather_ct
        w = (codec or current_codec()).untile_matmul_weight(
            maybe_gather_ct(self.ct, codec), self.k, self.n)
        return w.to(getattr(torch, self.dtype_str))

    def layer(self, i):
        return dataclasses.replace(self, ct=slice_stacked(self.ct, i))


def is_handle(x) -> bool:
    return isinstance(x, WeightHandle)


def handle_kind(leaf) -> str:
    """"dense" / "stream" / "fused" for handles, "expert" for an expert
    store's handle (``runtime.experts.ExpertRef``), "raw" for tensors."""
    if isinstance(leaf, DenseWeight):
        return "dense"
    if isinstance(leaf, StreamedWeight):
        return "stream"
    if isinstance(leaf, FusedWeight):
        return "fused"
    if isinstance(leaf, WeightHandle):
        # lazy: experts.py imports this module
        from repro_torch.runtime.experts import ExpertRef
        if isinstance(leaf, ExpertRef):
            return "expert"
    return "raw"


# ---------------------------------------------------------------------------
# checkpoint (de)serialization: spec <-> handle
# ---------------------------------------------------------------------------

def handle_spec(handle: WeightHandle) -> dict:
    """JSON-able metadata of a compressed handle: what a checkpoint
    manifest needs to rebuild it around a deserialized stream bundle."""
    if isinstance(handle, StreamedWeight):
        spec = {"kind": "stream", "tp_axis": handle.tp_axis,
                "layer_shape": list(handle.layer_shape),
                "dtype": handle.dtype_str, "execution": handle.execution}
        if handle.flat:
            spec["flat"] = True
        return spec
    if isinstance(handle, FusedWeight):
        return {"kind": "fused", "k": handle.k, "n": handle.n,
                "dtype": handle.dtype_str}
    raise TypeError(f"no spec for handle type {type(handle).__name__}")


def handle_from_spec(spec: dict, ct: CompressedTensor) -> WeightHandle:
    """Inverse of :func:`handle_spec`: the handle around ``ct``."""
    kind = spec["kind"]
    if kind == "stream":
        return StreamedWeight(ct=ct, tp_axis=int(spec["tp_axis"]),
                              layer_shape=tuple(spec["layer_shape"]),
                              dtype_str=spec["dtype"],
                              execution=spec.get("execution", "materialize"),
                              flat=bool(spec.get("flat", False)))
    if kind == "fused":
        return FusedWeight(ct=ct, k=int(spec["k"]), n=int(spec["n"]),
                           dtype_str=spec["dtype"])
    raise ValueError(f"unknown handle spec kind {kind!r}")


def finish_materialize(handle, w_stacked: torch.Tensor) -> torch.Tensor:
    """Stacked decode result -> the handle's original dense ``(L, ...)``
    leaf (un-permute / un-tile the storage layout)."""
    if isinstance(handle, StreamedWeight):
        w = torch.movedim(w_stacked, 1, 1 + handle.tp_axis)
        if handle.flat:        # L=1 stack of a 2-D leaf
            w = w[0]
        return w.to(getattr(torch, handle.dtype_str))
    if isinstance(handle, FusedWeight):
        w = torch.stack([untile_matmul_weight(layer, handle.k, handle.n)
                         for layer in w_stacked.reshape(
                             w_stacked.shape[0], -1)])
        return w.to(getattr(torch, handle.dtype_str))
    raise TypeError(f"not a compressed handle: {type(handle).__name__}")


def materialize_full(handle, codec=None) -> torch.Tensor:
    """One stacked handle back to its dense ``(L, ...)`` leaf, in one
    decode launch (``materialize`` works on one layer's slice)."""
    return materialize_full_many([handle], codec)[0]


def materialize_full_many(handles, codec=None) -> list:
    """Every handle's dense ``(L, ...)`` leaf, with O(#decode buckets)
    launches (``Codec.decompress_stacked_many``)."""
    from repro_torch.runtime.collectives import maybe_gather_ct
    codec = codec or current_codec()
    decs = codec.decompress_stacked_many(
        [None if isinstance(h, DenseWeight) else maybe_gather_ct(h.ct, codec)
         for h in handles])
    return [h.w if isinstance(h, DenseWeight) else finish_materialize(h, d)
            for h, d in zip(handles, decs)]


def resolve(tree, codec=None, *, prefetched=None):
    """Per-layer resolution: storage-only handles (StreamedWeight in
    "materialize" execution) become dense tensors; matmul-capable handles
    and expert handles (fetched inside ``moe_block``) pass through.

    ``prefetched`` maps flatten slots (:func:`tree_leaves` positions) to
    weights already decoded by the prefetch pipeline
    (``runtime/overlap.py``): a "materialize" handle at that slot becomes
    the decoded tensor, a "matmul" handle a :class:`DenseWeight` around
    it (the same canonical contraction, so the bits do not change)."""
    pre = prefetched or {}
    slots = iter(range(1 << 62))

    def one(_, leaf):
        slot = next(slots)
        if slot in pre:
            if not isinstance(leaf, StreamedWeight):
                raise TypeError(f"prefetched slot {slot} is not a "
                                f"StreamedWeight: {type(leaf).__name__}")
            w = pre[slot]
            return DenseWeight(w=w) if leaf.execution == "matmul" else w
        if isinstance(leaf, StreamedWeight) and leaf.execution != "matmul":
            return leaf.materialize(codec)
        return leaf

    return tree_map_with_path(one, tree)
