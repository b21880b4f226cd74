"""The port's dry-run tooling against the JAX package and against its own
CPU path: ``registry.input_specs`` equal to the reference's keys, shapes
and dtypes in all 40 cells; ``streaming.abstract_streamed_params`` equal
to the reference's leaf modes and stream shapes; the kernels' ``meta``
cost route (never the plain version, never a CUDA wrapper; CPU results
unchanged); the dry-run's kernel launches on a 2x2 abstract mesh equal to
the wrapper calls of the same program run on the CPU, for the smoke config
of one arch of every family; full-width llama3_2_1b's train step under
remat (435 launches of kernel 2') and decode step (113 launches of
kernel 2' dense, 112 of kernel 2 and 1 of 2' fused, 17 of kernel 1 in
stream mode with the prefetch) and its FLOPs against 2 N tokens; the
reference's 8 skips and the ``remat_dots`` variant run;
``moe_block(dispatch_a2a=True)`` bitwise equal to ``False`` and, under
the abstract mesh with the experts placed, recording the same exchange
as ``False``, its bytes the expert layout's formula; ``serve --dense``
bitwise equal to ``--mode dense``.
"""
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs import shape_applicable as ref_applicable
from repro.core.params import EnecParams as RefEnecParams
from repro.models import registry as ref_registry
from repro.runtime import streaming as ref_streaming
from repro.runtime.weights import StreamedWeight as RefStreamedWeight
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.codec_api import Codec, use_codec
from repro_torch.kernels import cost, ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import build_model, moe, registry
from repro_torch.models.lm import block_program
from repro_torch.optim import adamw
from repro_torch.runtime import collectives, sharding, streaming
from repro_torch.runtime.steps import (build_decode_step, build_prefill_step,
                                       build_train_step)
from repro_torch.runtime.weights import StreamedWeight

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
TABLE_IV = dict(b=122, n=6, m=3, L=16, l=96)
# the smoke cells: shapes small enough for the CPU run they are held to
# one arch of each family (dense, moe, ssm, hybrid, audio, vlm)
FAMILY_ARCHS = ("llama3_2_1b", "phi3_5_moe_42b_a6_6b", "xlstm_125m",
                "jamba_v0_1_52b", "whisper_tiny", "paligemma_3b")
SMOKE_SHAPES = {"train": ShapeSpec("train_4k", 16, 2, "train"),
                "prefill": ShapeSpec("prefill_32k", 16, 2, "prefill"),
                "decode": ShapeSpec("decode_32k", 32, 2, "decode")}
SMOKE_MIN_BYTES = 1024          # so that the smoke configs' leaves stream
KERNELS = ("enec_decode", "decompress_matmul", "dense_tile_matmul",
           "enec_encode", "idd_scan", "decode_attention_kv")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, path=""):
    """(path, shape, dtype name) of every leaf of nested dicts / lists of
    ``jax.ShapeDtypeStruct`` or tensors."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_references(arch, shape):
    want = ref_registry.input_specs(ref_config(arch), REF_SHAPES[shape])
    got = registry.input_specs(get_config(arch), SHAPES[shape])
    assert list(_flat(got)) == list(_flat(want))
    assert all(t.device.type == "meta" for _, t in _leaves(got))


def _leaves(tree):
    from repro_torch.core.api import tree_leaves
    return list(tree_leaves(tree))


def _ref_leaves(tree):
    import jax
    return jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, RefStreamedWeight))[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_streamed_params_equal_the_references(arch):
    """Leaf modes, stream shapes, TP axes and layer shapes, on the smoke
    config (at the default 1 MiB, where its leaves stay plain, and at 1
    KiB, where they stream) and, for llama3_2_1b, on the full config."""
    from repro_torch.core.params import EnecParams
    cases = [((ref_smoke_config, get_smoke_config),
              ref_streaming.MIN_STREAM_BYTES),
             ((ref_smoke_config, get_smoke_config), 1024)]
    if arch == "llama3_2_1b":       # the chip check's tree
        cases.append(((ref_config, get_config),
                      ref_streaming.MIN_STREAM_BYTES))
    for cfgs, min_bytes in cases:
        want = _ref_leaves(ref_streaming.abstract_streamed_params(
            cfgs[0](arch), RefEnecParams(**TABLE_IV), min_bytes=min_bytes))
        got = [leaf for _, leaf in _leaves(
            streaming.abstract_streamed_params(
                cfgs[1](arch), EnecParams(**TABLE_IV), min_bytes=min_bytes))]
        assert len(got) == len(want)
        streamed = 0
        for w, g in zip(want, got):
            if isinstance(w, RefStreamedWeight):
                streamed += 1
                assert isinstance(g, StreamedWeight)
                assert [tuple(a.shape) for a in g.ct.streams] \
                    == [tuple(a.shape) for a in w.ct.streams]
                assert (g.tp_axis, tuple(g.layer_shape), g.ct.shape,
                        g.ct.shards, g.flat) == (
                    w.tp_axis, tuple(w.layer_shape), tuple(w.ct.shape),
                    w.ct.shards, w.flat)
                assert g.ct.streams.mask.device.type == "meta"
            else:
                assert isinstance(g, torch.Tensor)
                assert tuple(g.shape) == tuple(w.shape)
        assert streamed > 0 or min_bytes > 1024


# ---------------------------------------------------------------------------
# the meta route
# ---------------------------------------------------------------------------

def test_meta_route_reaches_neither_plain_nor_card(monkeypatch):
    """A meta input goes to the cost route: the plain versions and the CUDA
    wrappers are never called, the outputs have the kernel's shapes, and
    the record counts one launch a call with 2 M K N FLOPs; a CPU input
    gives the same bits as before."""
    import importlib
    dm = importlib.import_module("repro_torch.kernels.decompress_matmul")
    from repro_torch.core.api import abstract_compressed
    from repro_torch.core.dtypes import BF16
    from repro_torch.core.params import EnecParams

    def refuse(*_, **__):
        raise AssertionError("the meta route reached a plain version or "
                             "a CUDA wrapper")

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 256), generator=gen).bfloat16()
    w = torch.randn((256, 384), generator=gen).bfloat16()
    want = ops.tiled_matmul(x, w)
    p = EnecParams(**TABLE_IV)
    dense_entry = dm.dense_matmul_cuda
    for name in ("tiled_matmul_ref", "decode_blocks_ref", "encode_blocks_ref",
                 "decompress_matmul_ref", "idd_scan_ref",
                 "decode_attention_kv_ref"):
        monkeypatch.setattr(ref, name, refuse)
    for mod, name in ((dm, "dense_matmul_cuda"),
                      (dm, "decompress_matmul_cuda"),
                      (ops.enec_decode, "decode_blocks_cuda"),
                      (ops.enec_encode, "encode_blocks_cuda"),
                      (ops.scan, "idd_scan_cuda"),
                      (ops.dak, "decode_attention_kv_enec_cuda")):
        monkeypatch.setattr(mod, name, refuse)
    cost.reset()
    y = ops.tiled_matmul(x.to("meta"), w.to("meta"))
    assert (y.device.type, tuple(y.shape), y.dtype) == ("meta", (3, 384),
                                                        torch.float32)
    ct = abstract_compressed((256 * 384,), torch.bfloat16, p)
    bits = ops.decode_blocks(ct.streams, 16384, BF16, p)
    assert tuple(bits.shape) == (ct.streams.mask.shape[0], 16384)
    streams = ops.encode_blocks(bits, BF16, p)
    assert [tuple(a.shape) for a in streams] \
        == [tuple(a.shape) for a in ct.streams]
    tiles = abstract_compressed((2 * 3 * 16384,), torch.bfloat16, p)
    z = ops.decompress_matmul(torch.empty((4, 256), dtype=torch.bfloat16,
                                          device="meta"), tiles, 256, 384)
    assert tuple(z.shape) == (4, 384)
    assert tuple(ops.idd_scan(torch.empty((2, 256), dtype=torch.int32,
                                          device="meta")).shape) == (2, 256)
    assert tuple(dense_entry(x.to("meta"), w.to("meta")).shape) == (3, 384)
    rec = cost.snapshot()
    assert rec["dense_tile_matmul"] == {
        "launches": 2, "flops": 2 * 2 * 3 * 256 * 384,
        "bytes": 2 * (3 * 256 * 2 + 256 * 384 * 2 + 3 * 384 * 4)}
    assert rec["decompress_matmul"]["flops"] == 2 * 4 * 256 * 384
    assert {k: v["launches"] for k, v in rec.items()} == {
        "dense_tile_matmul": 2, "enec_decode": 1, "enec_encode": 1,
        "decompress_matmul": 1, "idd_scan": 1}
    monkeypatch.undo()
    assert torch.equal(ops.tiled_matmul(x, w).view(torch.int32),
                       want.view(torch.int32))


# ---------------------------------------------------------------------------
# the dry-run against the same program on the CPU
# ---------------------------------------------------------------------------

def _cpu_run(cfg, shape, mode, monkeypatch) -> tuple:
    """One device's program for the cell run on the CPU with real tensors:
    ``(calls, tree)``, the kernel wrapper calls of the step (the launches
    the card would make) and the serving tree it ran (compressed with
    1024-element blocks, so the smoke leaves stream; None for a train
    step)."""
    model = build_model(cfg)
    specs = registry.input_specs(cfg, shape, device="cpu")
    params = model.init(seed=0, device="cpu")
    codec = Codec(block_elems=1024)
    tree = None
    if shape.kind != "train":
        tree = streaming.assign_weight_modes(
            params, mode=mode, min_bytes=SMOKE_MIN_BYTES, codec=codec)
    calls = dict.fromkeys(KERNELS, 0)
    inside = []     # a plain version's own calls are no launch of the card

    for name, fn in (("dense_tile_matmul", "_tiled"),
                     ("enec_decode", "decode_blocks"),
                     ("decompress_matmul", "decompress_matmul"),
                     ("idd_scan", "idd_scan"),
                     ("decode_attention_kv", "decode_attention_kv_enec")):
        orig = getattr(ops, fn)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += not inside
            inside.append(_name)
            try:
                return _orig(*a, **k)
            finally:
                inside.pop()
        monkeypatch.setattr(ops, fn, counted)
    with use_codec(codec):
        if shape.kind == "train":
            step = build_train_step(model, adamw.AdamWConfig())
            step(params, adamw.init(params), specs)
        else:
            import copy
            run_tree = copy.copy(tree)
            if shape.kind == "prefill":
                build_prefill_step(model, shape.seq_len)(run_tree, specs)
            else:
                build_decode_step(model)(run_tree, specs["cache"],
                                         specs["tokens"])
    monkeypatch.undo()
    return {k: v for k, v in calls.items() if v}, tree


def _smoke_cells():
    out = []
    for arch in FAMILY_ARCHS:
        out += [(arch, "train", "dense"), (arch, "prefill", "dense")]
        out += [(arch, "decode", m) for m in ("dense", "stream", "fused")]
    return out


@pytest.mark.parametrize("arch,kind,mode", _smoke_cells())
def test_dryrun_launches_equal_the_cpu_programs(arch, kind, mode,
                                                monkeypatch):
    """On a 2x2 abstract mesh (rank 0) the dry-run's launches a kernel
    equal the wrapper calls of one device's program on the CPU: the mesh
    moves bytes, never kernel work (every rank runs the dense math whole;
    a training rank its rows), but for the MoE experts of a serving cell:
    the rank multiplies only its own (``sharding.expert_layout``: half of
    them on the model axis of 2), three products an expert fewer for each
    of the others.  The serving cells run the tree the CPU run compressed
    (``dryrun.meta_tree``): its escapes and decoder buckets are a real
    encode's."""
    cfg = get_smoke_config(arch)
    shape = SMOKE_SHAPES[kind]
    want, tree = _cpu_run(cfg, shape, mode, monkeypatch)
    if kind != "train" and cfg.n_experts:
        program = block_program(cfg)
        moe_layers = sum(d.ffn == "moe" for d in program) * (
            cfg.n_layers // len(program))
        want["dense_tile_matmul"] -= 3 * cfg.n_experts // 2 * moe_layers
    mesh = AbstractMesh((2, 2), ("data", "model"))
    rec = dryrun.lower_cell(cfg, shape, mesh, mode=mode, tree=tree)
    got = {k: v["launches"] for k, v in rec["kernels"].items()}
    assert got == want
    if kind == "train":
        # every product forward, dX and dW (but sLSTM's first recurrent
        # product, whose input, the zero state, needs no gradient)
        assert got["dense_tile_matmul"] % 3 == (
            -(cfg.n_layers // 4) % 3 if cfg.family == "ssm" else 0)
        assert rec["collectives"]["broadcast"]["count"] > 0
    if mode != "dense" and "enec_decode" in got:
        assert rec["collectives"]["all-gather"]["count"] > 0
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] \
        >= rec["memory"]["argument_size_in_bytes"] > 0


def test_cost_mode_keeps_an_output_live_until_its_storage_dies():
    """CostMode counts an op's new output until its storage dies: a
    ``detach()`` of it kept past the output itself (as remat's ``dots``
    policy keeps its products) stays live for later ops' peak; dropping it
    frees the bytes."""
    nbytes = 256 * 256 * 4
    x = torch.empty((256, 256), device="meta")
    with dryrun.CostMode() as mode:
        y = x * 2
        kept = y.detach()
        del y
        z = x + 1
        assert mode.live == 2 * nbytes
        del kept, z
        assert mode.live == 0
    assert mode.peak == 2 * nbytes


def test_llama_train_step_launches_the_codes_count():
    """A full-width llama3_2_1b train step on a 1x1 mesh under the config's
    remat (policy ``nothing``): 435 launches of kernel 2' (113 products,
    forward, dX and dW; the recompute of each layer's products but
    ``w_down``), as chip_smoke.py's ``train_step_launches`` reads the
    code."""
    shape = ShapeSpec("train_4k", 128, 8, "train")
    rec = dryrun.lower_cell(get_config("llama3_2_1b"), shape,
                            AbstractMesh((1, 1), ("data", "model")))
    assert {k: v["launches"] for k, v in rec["kernels"].items()} \
        == {"dense_tile_matmul": 3 * (16 * 7 + 1) + 16 * 6}
    assert rec["collectives"]["total_count"] == 0


@pytest.mark.parametrize("mode,want", [
    ("dense", {"dense_tile_matmul": 113}),
    ("stream", {"enec_decode": 17, "dense_tile_matmul": 113}),
    ("fused", {"enec_decode": 1, "decompress_matmul": 112,
               "dense_tile_matmul": 1})])
def test_full_width_llama_decode_step(mode, want):
    """llama3_2_1b at full width, decode at batch 4 over a cache of 128 on
    a 1x1 mesh (nothing is allocated on meta): the launches of a step as
    PERF.md's kernel table counts them (stream mode with the prefetch: one
    decode of the embed and one a layer), its FLOPs within 5 % of 2 N
    tokens, no collective, and a peak above the tree it serves."""
    cfg = get_config("llama3_2_1b")
    rec = dryrun.lower_cell(cfg, ShapeSpec("decode", 128, 4, "decode"),
                            AbstractMesh((1, 1), ("data", "model")),
                            mode=mode)
    assert {k: v["launches"] for k, v in rec["kernels"].items()} == want
    n = registry.active_param_count(cfg)
    assert abs(rec["cost"]["flops"] / (2 * n * 4) - 1) < 0.05
    assert rec["collectives"]["total_count"] == 0
    assert rec["memory"]["peak_memory_in_bytes"] \
        > rec["memory"]["argument_size_in_bytes"]


def test_skips_carry_the_references_reasons(tmp_path):
    """The 8 cells the reference skips, with its reasons; ``flash_decode``
    run (a decode cell of llama smoke with a 2048-position cache on a 2x2
    mesh: the ring sequence-sharded, the flash-decoding gathers
    recorded); ``remat_dots`` run (a train cell of llama smoke on a 2x2
    mesh), its peak at least the baseline's (``dots`` keeps product
    outputs beside each period's input)."""
    skipped = {}
    for arch, shape in CELLS:
        ok, reason = ref_applicable(ref_config(arch), shape)
        if not ok:
            skipped[(arch, shape)] = reason
    assert len(skipped) == 8
    for (arch, shape), reason in skipped.items():
        rec = dryrun.run_cell(arch, shape, tmp_path, ["single"])
        assert (rec["status"], rec["reason"]) == ("skipped", reason)
    rec = dryrun.run_cell("llama3_2_1b", "decode_32k", tmp_path, ["single"],
                          variant="flash_decode", mesh_shape=(2, 2),
                          cfg=get_smoke_config("llama3_2_1b"),
                          shape=ShapeSpec("decode_32k", 2048, 2, "decode"))
    assert rec["status"] == "ok", rec
    full = rec["single"]["full"]
    assert "flash-decoding" in full["program"]
    assert full["collectives"]["broadcast"]["count"] > 0
    assert sorted(p.name for p in tmp_path.iterdir())[0] \
        == "llama3_2_1b__decode_32k__flash_decode__mesh2x2.json"
    peaks = {}
    for variant in ("baseline", "remat_dots"):
        rec = dryrun.run_cell("llama3_2_1b", "train_4k", tmp_path,
                              ["single"], variant=variant, mesh_shape=(2, 2),
                              cfg=get_smoke_config("llama3_2_1b"),
                              shape=SMOKE_SHAPES["train"])
        assert rec["status"] == "ok", rec
        peaks[variant] = rec["single"]["full"]["memory"][
            "peak_memory_in_bytes"]
    assert peaks["remat_dots"] >= peaks["baseline"]
    assert (tmp_path / "llama3_2_1b__train_4k__remat_dots__mesh2x2.json"
            ).exists()


def test_dryrun_record_reads_into_the_roofline(tmp_path):
    """One full-size cell through ``main`` (single pod), read back by the
    port's roofline: the reference's record schema."""
    from repro_torch.launch import roofline
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "xlstm_125m", "--shape", "long_500k",
                     "--single-only", "--out", str(tmp_path / "d")])
    assert done.value.code == 0
    rows = roofline.main(["--dryrun-dir", str(tmp_path / "d"),
                          "--out", str(tmp_path / "r.json")])
    assert [r["status"] for r in rows] == ["ok"]
    assert rows[0]["layers_mode"] == "unroll"
    assert rows[0]["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert (tmp_path / "r.md").read_text().count("xlstm_125m") == 1


# ---------------------------------------------------------------------------
# the all-to-all dispatch and serve --dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi3_5_moe_42b_a6_6b",
                                  "qwen3_moe_235b_a22b"])
def test_moe_a2a_dispatch_bitwise_equal_and_recorded(arch):
    """``dispatch_a2a=True`` gives ``False``'s bits on one device, and on
    the 2x2 abstract mesh (rank 0, its rows of the batch on "data", its
    share of the expert stacks placed by ``sharding.expert_layout``) both
    record the same exchange: the own experts' ``x_ec`` gathered over
    "data", ``h`` over "data", ``y`` returned by one all-to-all over
    "data", the combine over "model", the ledger's bytes the layout's
    formula."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(1)
    p = moe.init_moe(1, cfg.d_model, cfg.moe_d_ff, cfg.n_experts, gen, "cpu")
    p = {k: v[0] for k, v in p.items()}
    x = (torch.randn((2, 8, cfg.d_model), generator=gen) * 0.5).bfloat16()
    k = cfg.experts_per_token
    base, aux = moe.moe_block(p, x, k)
    a2a, aux2 = moe.moe_block(p, x, k, dispatch_a2a=True)
    assert torch.equal(a2a.view(torch.int16), base.view(torch.int16))
    for key in aux:
        assert torch.equal(aux[key], aux2[key])
    records = {}
    for flag in (False, True):
        mesh = AbstractMesh((2, 2), ("data", "model"))
        meta = {}
        for name, t in p.items():
            layout = collectives.leaf_expert_layout(name, t.to("meta"), mesh)
            meta[name] = t.to("meta") if layout is None else \
                collectives.place_expert(t.to("meta"), layout, mesh)
        before = collectives.expert_exchange_bytes()
        with collectives.use_serving_mesh(mesh, rows="data"):
            moe.moe_block(meta, x[:1].to("meta"), k, dispatch_a2a=flag)
        records[flag] = (mesh.records,
                         collectives.expert_exchange_bytes() - before)
    assert records[True] == records[False]
    kinds = [kind for kind, _, _ in records[True][0]]
    assert kinds.count("all-to-all") == 1
    assert kinds.count("broadcast") == 3 * 2     # x, h, combine; 2 owners
    c = moe.capacity_for(8, cfg.n_experts, k)
    layout = sharding.expert_layout(mesh, cfg.n_experts, cfg.d_model,
                                    cfg.moe_d_ff)
    assert layout.local_experts == cfg.n_experts // 2
    assert records[True][1] == layout.exchange_bytes(1, c, 4,
                                                     rows_sharded=True)


def test_serve_dense_alias_bitwise_equal_to_mode_dense():
    from repro_torch.launch import serve
    base = ["--smoke", "--device", "cpu", "--tokens", "3", "--batch", "2",
            "--prompt-len", "8"]
    alias = serve.main(base + ["--dense"])
    mode = serve.main(base + ["--mode", "dense"])
    assert torch.equal(alias["tokens"], mode["tokens"])
    assert torch.equal(alias["logits"].view(torch.int32),
                       mode["logits"].view(torch.int32))
    assert alias["mode_mix"] == mode["mode_mix"]
    with pytest.raises(SystemExit):
        serve.parse_args(base + ["--dense", "--mode", "fused"])
    assert serve.parse_args(base).mode == "fused"
    assert np.isfinite(alias["logits"].numpy()).all()
