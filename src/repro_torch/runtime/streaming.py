"""Weight-execution policy (port of ``repro/runtime/streaming.py``): which
leaves are served dense, streamed (decoded inside the step) or fused
(decoded inside the matmul kernel), and their compression.

  raw      small / non-stacked leaves: untouched tensors
  dense    big matmul weights in DenseWeight (the baseline)
  stream   StreamedWeight: ENEC streams in the ``moveaxis(tp_axis -> 0)``
           layout, decoded inside the step
  fused    FusedWeight: tile-wise ENEC streams for the fused kernel

Only leaves of at least ``min_bytes`` are compressed.  Trees are nested
dicts and lists; a leaf's path joins its keys with "/" as the reference
does ("period/0/attn/wq"), and trees are walked in the reference's
flatten order (dict keys sorted, list items in order), so checkpoint
record names, their order and the encode plans match it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.api import (DEFAULT_BLOCK_ELEMS, MATMUL_TILE,
                                  SUPPORTED_FLOAT_DTYPES, CompressedTensor,
                                  abstract_compressed, matmul_tiles)
from repro_torch.core.codec_api import current_codec
from repro_torch.core.params import EnecParams
from repro_torch.runtime.overlap import (OVERLAP_MODES,  # noqa: F401
                                         overlap_enabled)
from repro_torch.runtime.weights import (DenseWeight, FusedWeight,
                                         StreamedWeight, handle_kind,
                                         is_handle, materialize_full_many,
                                         resolve, tree_leaves,
                                         tree_map_with_path)

MIN_STREAM_BYTES = 1 << 20  # 1 MiB
STREAM_SHARDS = 16          # production TP width (divisors also work)

WEIGHT_MODES = ("dense", "stream", "fused")

MATMUL_LEAF_NAMES = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


def stream_eligible(pstr: str, shape, dtype,
                    min_bytes: int = MIN_STREAM_BYTES) -> bool:
    """A leaf is compressible iff it is big enough and is either a stacked
    (L, ...) float stack or a plain 2-D float weight (embed)."""
    if dtype not in SUPPORTED_FLOAT_DTYPES:
        return False
    numel = 1
    for d in shape:
        numel *= d
    if numel * dtype.itemsize < min_bytes:
        return False
    if len(shape) == 2:
        return True
    stacked = "period" in pstr or "stack" in pstr
    return stacked and len(shape) >= 3


def _tp_axis_for(path: str, shape) -> int:
    """Which axis is model-sharded at serve time."""
    name = path.rsplit("/", 1)[-1]
    if name == "embed":
        return 0
    if name in ("wo", "w_down", "out_proj"):
        return len(shape) - 2
    if name in ("e_gate", "e_up", "e_down"):
        return len(shape) - 3
    return len(shape) - 1


def fused_shards(k: int, n: int, shards: int) -> int:
    """``shards`` when the n-major tile count divides by it (each shard a
    contiguous range of flat tiles), else 1: pad blocks would corrupt the
    kernel's flat tile order."""
    t = MATMUL_TILE
    blocks = (-(-k // t)) * (-(-n // t))
    return shards if shards > 1 and blocks % shards == 0 else 1


def _is_matmul_pos(pstr: str, ndim: int) -> bool:
    """Is this leaf executed through ``models.layers.weight_matmul``?"""
    parts = pstr.split("/")
    return (parts[-1] in MATMUL_LEAF_NAMES and ndim == 3
            and len(parts) >= 2 and parts[-2] in ("attn", "mlp"))


def serving_job(pstr: str, leaf: torch.Tensor, mode: str,
                min_bytes: int = MIN_STREAM_BYTES) -> Optional[dict]:
    """Per-leaf compression plan for "stream" / "fused": the layout to
    encode (``arr``) and the handle metadata; ``None`` keeps the leaf."""
    if not stream_eligible(pstr, leaf.shape, leaf.dtype, min_bytes):
        return None
    if leaf.ndim == 2:
        tp_axis = _tp_axis_for(pstr, leaf.shape)
        return dict(kind="stream", leaf=leaf,
                    arr=torch.movedim(leaf, tp_axis, 0)[None],
                    tp_axis=tp_axis, layer_shape=tuple(leaf.shape),
                    matmul_pos=False, flat=True)
    matmul_pos = _is_matmul_pos(pstr, leaf.ndim)
    if mode == "fused" and matmul_pos:
        return dict(kind="fused", leaf=leaf, arr=matmul_tiles(leaf),
                    k=leaf.shape[1], n=leaf.shape[2], matmul_pos=True)
    tp_axis = _tp_axis_for(pstr, leaf.shape[1:])
    return dict(kind="stream", leaf=leaf,
                arr=torch.movedim(leaf, 1 + tp_axis, 1),
                tp_axis=tp_axis, layer_shape=tuple(leaf.shape[1:]),
                matmul_pos=matmul_pos)


def build_serving_handle(job: dict, ct):
    """Handle (or fallback leaf) from a compression result; ``ct=None``
    (const / incompressible) falls back to DenseWeight at matmul positions
    and to the raw tensor elsewhere."""
    leaf = job["leaf"]
    dtype_str = str(leaf.dtype).split(".")[-1]
    if job["kind"] == "fused":
        # tile accounting runs on the zero-padded layout; re-check the
        # escape against the true (unpadded) raw bytes
        if ct is not None and ct.nbytes_wire() >= leaf.numel() \
                * leaf.element_size():
            ct = None
        return (DenseWeight(w=leaf) if ct is None else
                FusedWeight(ct=ct, k=job["k"], n=job["n"],
                            dtype_str=dtype_str))
    if ct is None:
        return DenseWeight(w=leaf) if job["matmul_pos"] else leaf
    return StreamedWeight(
        ct=ct, tp_axis=job["tp_axis"], layer_shape=job["layer_shape"],
        dtype_str=dtype_str,
        execution="matmul" if job["matmul_pos"] else "materialize",
        flat=job.get("flat", False))


def _serving_jobs(params, mode: str, min_bytes: int, shards: int):
    """The tree with dense-mode wraps, and a compression job for every
    leaf to compress (keyed by path)."""
    if mode not in WEIGHT_MODES:
        raise ValueError(f"unknown weight mode {mode!r}; "
                         f"expected one of {WEIGHT_MODES}")
    jobs = {}

    def plan(pstr, leaf):
        if is_handle(leaf):
            return leaf
        if mode == "dense":
            eligible = stream_eligible(pstr, leaf.shape, leaf.dtype,
                                       min_bytes)
            return (DenseWeight(w=leaf)
                    if eligible and _is_matmul_pos(pstr, leaf.ndim)
                    else leaf)
        job = serving_job(pstr, leaf, mode, min_bytes)
        if job is None:
            return leaf
        job["shards"] = (fused_shards(job["k"], job["n"], shards)
                         if job["kind"] == "fused" else shards)
        jobs[pstr] = job
        return leaf

    return tree_map_with_path(plan, params), jobs


def _encode_plans(jobs: dict, codec):
    """``(paths, plan)``: one encode plan per shard width, built lazily so
    each can run before the next stages its blocks."""
    by_shards: dict = {}
    for pstr, job in jobs.items():
        by_shards.setdefault(job["shards"], []).append(pstr)
    for job_shards, names in sorted(by_shards.items()):
        yield names, codec.plan_encode(
            [jobs[n].pop("arr") for n in names], stacked=True,
            shards=job_shards)


def serving_encode_plans(params, *, mode: str = "fused",
                         min_bytes: int = MIN_STREAM_BYTES,
                         shards: int = STREAM_SHARDS, codec=None):
    """The encode plans :func:`assign_weight_modes` executes for
    ``params`` under the same arguments, built on ``codec`` (default: the
    ambient codec) and not executed."""
    _, jobs = _serving_jobs(params, mode, min_bytes, shards)
    for _, plan in _encode_plans(jobs, codec or current_codec()):
        yield plan


def assign_weight_modes(params, *, mode: str = "fused",
                        min_bytes: int = MIN_STREAM_BYTES,
                        shards: int = STREAM_SHARDS, codec=None):
    """Assign every leaf a weight-execution mode and compress the
    compressible ones on their device.

    mode="dense":  matmul positions wrapped in DenseWeight, rest raw.
    mode="stream": eligible leaves become StreamedWeight.
    mode="fused":  matmul positions become FusedWeight tile streams
                   (TP-sharded when the tile count allows it, see
                   :func:`fused_shards`); other eligible leaves stream.
    A leaf whose streams would not beat raw bytes stays dense / raw.
    Leaves that are already handles pass through.  The leaves compress
    through ``codec``'s encode plans (default: the ambient codec), one plan
    per shard width: O(#buckets) encoder launches for the whole tree.
    """
    codec = codec or current_codec()
    tree, jobs = _serving_jobs(params, mode, min_bytes, shards)
    handles = {}
    for names, plan in _encode_plans(jobs, codec):
        for n, ct in zip(names, codec.execute(plan)):
            handles[n] = build_serving_handle(jobs[n], ct)
    return tree_map_with_path(lambda p, leaf: handles.get(p, leaf), tree)


# ---------------------------------------------------------------------------
# the reference's stream-everything entry points: every eligible leaf one
# materialize-mode StreamedWeight, decoded before its layer runs
# ---------------------------------------------------------------------------

def compress_params_for_streaming(params, *,
                                  shared_params: Optional[EnecParams] = None,
                                  min_bytes: int = MIN_STREAM_BYTES,
                                  shards: int = STREAM_SHARDS,
                                  codec=None, plan=None):
    """``params`` with every eligible leaf replaced by a materialize-mode
    StreamedWeight (``resolve`` decodes it before its layer runs, so the
    served logits are bitwise the raw tree's).  The eligible stacks
    compress in one ``execute``: one encoder launch per bucket.  ``plan``
    takes the :func:`streaming_encode_plan` built for the same
    (params, min_bytes, shards), so an inspected plan is not built twice;
    one that does not match raises.  A leaf whose streams would not beat
    raw bytes stays the raw tensor."""
    jobs = _stream_jobs(params, min_bytes)
    codec = codec or current_codec()
    if plan is None:
        plan = codec.plan_encode([j["arr"] for j in jobs], stacked=True,
                                 p=shared_params, shards=shards)
    elif not plan.stacked or plan.n_inputs != len(jobs) \
            or plan.shards != shards:
        raise ValueError(
            f"plan does not match this tree/policy: stacked={plan.stacked} "
            f"n_inputs={plan.n_inputs} (expected {len(jobs)}) "
            f"shards={plan.shards} (expected {shards})")
    handles = {j["pstr"]: build_serving_handle(j, ct)
               for j, ct in zip(jobs, codec.execute(plan))}
    return tree_map_with_path(lambda p, leaf: handles.get(p, leaf), params)


def _stream_jobs(params, min_bytes):
    """The eligibility walk shared by :func:`compress_params_for_streaming`
    and :func:`streaming_encode_plan`: the stream-mode
    :func:`serving_job` of every eligible leaf, in the reference's flatten
    order, with no matmul position (every leaf is decoded before its layer
    runs, and an escaped one stays the raw tensor)."""
    jobs = []
    for pstr, leaf in tree_leaves(params):
        job = (serving_job(pstr, leaf, "stream", min_bytes)
               if isinstance(leaf, torch.Tensor) else None)
        if job is not None:
            jobs.append(dict(job, pstr=pstr, matmul_pos=False))
    return jobs


def streaming_encode_plan(params, *,
                          shared_params: Optional[EnecParams] = None,
                          min_bytes: int = MIN_STREAM_BYTES,
                          shards: int = STREAM_SHARDS, codec=None):
    """The encode plan :func:`compress_params_for_streaming` would execute
    over ``params``, not executed: ``len(plan.buckets)`` encoder launches
    for the whole tree."""
    return (codec or current_codec()).plan_encode(
        [j["arr"] for j in _stream_jobs(params, min_bytes)], stacked=True,
        p=shared_params, shards=shards)


def decompress_sliced(p_sliced):
    """The reference's name for :func:`~repro_torch.runtime.weights.
    resolve`: every storage-only handle of a layer slice decoded."""
    return resolve(p_sliced)


def materialize_weight_tree(tree, codec=None):
    """Every handle of ``tree`` back to its dense ``(L, ...)`` leaf, in
    one decode launch per decoder bucket of the whole tree
    (``materialize_full_many``); bitwise each handle materialised
    alone."""
    named = [(p, h) for p, h in tree_leaves(tree) if is_handle(h)]
    dense = dict(zip((p for p, _ in named),
                     materialize_full_many([h for _, h in named], codec)))
    return tree_map_with_path(lambda p, leaf: dense.get(p, leaf), tree)


def _abstract_stack(n_layers: int, layer_shape, dtype, p, block_elems: int,
                    shards: int) -> CompressedTensor:
    """The stacked CompressedTensor that an encode of ``n_layers`` layers
    of ``layer_shape`` would give, on ``meta`` tensors: one layer's
    :func:`~repro_torch.core.api.abstract_compressed` with a leading
    ``(L,)`` on every stream."""
    one = abstract_compressed(layer_shape, dtype, p, block_elems, shards)
    streams = one.streams.map(lambda a: torch.empty(
        (n_layers,) + tuple(a.shape), dtype=a.dtype, device="meta"))
    return CompressedTensor(
        streams=streams, raw_bytes=None, fmt_name=one.fmt_name,
        params=one.params, shape=one.shape, dtype_str=one.dtype_str,
        block_elems=one.block_elems, shards=one.shards, mode="enec")


def abstract_serving_params(cfg, p, *, mode: str = "stream",
                            min_bytes: int = MIN_STREAM_BYTES,
                            shards: int = STREAM_SHARDS):
    """The tree :func:`assign_weight_modes` would give ``cfg``'s parameters
    under ``mode``, on ``meta`` tensors and with every eligible leaf
    compressed under ``p``: the dry-run serves it without allocating
    anything.  Shares :func:`serving_job` / :func:`fused_shards` with the
    concrete path, so the two cannot drift."""
    from repro_torch.models.registry import abstract_params
    params = abstract_params(cfg)
    tree, jobs = _serving_jobs(params, mode, min_bytes, shards)
    handles = {}
    for pstr, job in jobs.items():
        arr = job.pop("arr")
        ct = _abstract_stack(arr.shape[0], tuple(arr.shape[1:]), arr.dtype,
                             p, DEFAULT_BLOCK_ELEMS, job["shards"])
        if job["kind"] == "fused":
            # no never-worse escape: a meta stream has no size to weigh
            handles[pstr] = FusedWeight(
                ct=ct, k=job["k"], n=job["n"],
                dtype_str=str(arr.dtype).split(".")[-1])
        else:
            handles[pstr] = build_serving_handle(job, ct)
    return tree_map_with_path(lambda q, leaf: handles.get(q, leaf), tree)


def abstract_streamed_params(cfg, p, *, min_bytes: int = MIN_STREAM_BYTES,
                             shards: int = STREAM_SHARDS):
    """The reference's ``abstract_streamed_params``: the stream-mode tree
    of ``cfg`` on ``meta`` tensors (:func:`abstract_serving_params`)."""
    return abstract_serving_params(cfg, p, mode="stream",
                                   min_bytes=min_bytes, shards=shards)


def mode_mix(tree) -> dict:
    """Handle-kind census of a weight tree (``weights.handle_kind``: an
    expert store's handle counts as "expert")."""
    mix: dict = {}
    for _, leaf in tree_leaves(tree):
        k = handle_kind(leaf)
        mix[k] = mix.get(k, 0) + 1
    return mix


def stream_stats(tree) -> dict:
    """Bytes and handle counts of a weight-execution tree.
    ``overlap_eligible_tensors`` counts the streamed leaves inside the layer
    loop, which the decode-prefetch pipeline (``runtime/overlap.py``)
    decodes a layer ahead; ``flat_stream_tensors`` the L=1 streams of plain
    2-D leaves (embed, untied head), decoded once a step.  An expert
    store's handle (``expert_tensors``) counts its stack's raw bytes and no
    device bytes: its records live in host memory and the device holds
    only the store's decode cache (the reference counts its ``(L,)``
    int32 layer-id vector there, which the port does not have)."""
    from repro_torch.runtime.experts import ExpertRef
    total_raw = total_dev = 0
    counts = {"streamed_tensors": 0, "fused_tensors": 0, "dense_handles": 0,
              "flat_stream_tensors": 0, "overlap_eligible_tensors": 0,
              "expert_tensors": 0}
    for _, leaf in tree_leaves(tree):
        if isinstance(leaf, ExpertRef):
            counts["expert_tensors"] += 1
            total_raw += leaf.raw_nbytes()
        elif isinstance(leaf, StreamedWeight):
            counts["streamed_tensors"] += 1
            counts["flat_stream_tensors"] += int(leaf.flat)
            counts["overlap_eligible_tensors"] += int(not leaf.flat)
            n_layers = leaf.ct.streams.mask.shape[0]
            per_layer = 1
            for d in leaf.layer_shape:
                per_layer *= d
            total_raw += n_layers * per_layer * leaf.ct.itemsize
            total_dev += leaf.ct.nbytes_device()
        elif isinstance(leaf, FusedWeight):
            counts["fused_tensors"] += 1
            n_layers = leaf.ct.streams.mask.shape[0]
            total_raw += n_layers * leaf.k * leaf.n * leaf.ct.itemsize
            total_dev += leaf.ct.nbytes_device()
        elif isinstance(leaf, DenseWeight):
            counts["dense_handles"] += 1
            total_raw += leaf.w.numel() * leaf.w.element_size()
            total_dev += leaf.w.numel() * leaf.w.element_size()
        elif isinstance(leaf, torch.Tensor):
            total_raw += leaf.numel() * leaf.element_size()
            total_dev += leaf.numel() * leaf.element_size()
    return {**counts, "raw_bytes": total_raw, "device_bytes": total_dev,
            "hbm_ratio": total_raw / max(total_dev, 1)}
