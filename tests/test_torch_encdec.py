"""Whisper's encoder-decoder in the port against the JAX package on the
smoke config, with the JAX weights carried over by
``convert.params_from_jax`` and frames and prompts made from a numpy
seed (T_a = 24 frames):

* ``encode``, the prefill logits and three ``decode_fn`` steps against the
  reference's raw-parameter path within a stated number of bf16 ulps,
  greedy tokens equal;
* dense, stream and fused serving bitwise equal to the unassigned tree;
* a row served alone bitwise equal to the same row in a batch of 2;
* ``decode_step`` on fixed buffers bitwise equal to ``decode_fn``;
* packs byte-identical to the reference's in every layout, and the
  dense checkpoint moved both ways;
* the abstract trees equal to the reference's, and ``launch/serve.py``
  refusing whisper with the registry path named.

The reference runs once, in a module fixture, and never in fused mode
(its Pallas kernel runs in interpret mode on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models import registry as jax_registry
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.codec_api import Codec, use_codec
from repro_torch.launch import serve
from repro_torch.models import build_model, encdec, registry
from repro_torch.runtime.streaming import (assign_weight_modes, mode_mix,
                                           tree_leaves)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core: the smoke models' small ops spend
    more time synchronising a pool of threads than computing.  The bits
    compared here come from runs under the same setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "whisper_tiny"
FRAMES, PROMPT, STEPS = 24, 8, 3
MAX_LEN = PROMPT + STEPS + 1
# Both packages differ by the f32 sum order inside each 128-term tile
# product and each norm's mean (XLA and torch order them differently), and
# the decode step's cross attention sums in a fixed pairwise order where
# the reference runs its flash attention; where that moves a bf16 cast of
# a residual, one element rounds the other way, and later layers carry it
# on.  Each bound is a number of bf16 ulps (2**-8 relative) of the larger
# of 1 and the reference output's magnitude: the largest gap measured over
# frame / prompt seeds 1-8 (2 rows; prefill + 3 steps), rounded up to a
# power of two.  Measured: encoder 4.0 ulps (one element of a bf16 output
# a binade above the bound's), logits 4.21 (seed 8).  Greedy tokens are
# equal at every seed but 3, where the reference's top two logits at step
# 1 lie 0.0147 apart, less than the logit gap (0.029 teacher-forced): a
# tie either package may break.  The test runs seed 1.
ULP = 2.0 ** -8
ENC_ULPS, LOGIT_ULPS = 4, 8
MIN_BYTES, SHARDS = 1024, 2
LAYOUTS = [None, "stream", "fused"]


def _within_ulps(got: np.ndarray, want: np.ndarray, ulps: int):
    bound = ulps * ULP * 2.0 ** np.floor(np.log2(max(1.0,
                                                     np.abs(want).max())))
    gap = np.abs(got - want).max()
    assert gap <= bound, (gap, bound)


def _inputs(seed: int, cfg, rows: int = 2):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((rows, FRAMES, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (rows, PROMPT))
    return frames, tokens


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_smoke_config(ARCH)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_smoke_config(ARCH)
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    frames, tokens = _inputs(1, cfg)
    jframes = jnp.asarray(frames).astype(jnp.bfloat16)
    enc = np.asarray(jax_encdec.encode(jparams, jcfg, jframes)
                     .astype(jnp.float32))
    logits, cache = jmodel.prefill_fn(
        jparams, {"frames": jframes,
                  "tokens": jnp.asarray(tokens, jnp.int32)}, MAX_LEN)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want, toks = [np.asarray(logits)], [np.asarray(tok)]
    for _ in range(STEPS):
        logits, cache = jmodel.decode_fn(jparams, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    batch = {"frames": torch.from_numpy(frames).bfloat16(),
             "tokens": torch.from_numpy(tokens)}
    return {"jcfg": jcfg, "jparams": jparams, "cfg": cfg,
            "model": build_model(cfg), "params": params, "batch": batch,
            "enc": enc, "want": np.stack(want), "want_toks": np.stack(toks)}


def _serve(model, tree, batch, codec=None):
    with use_codec(codec or Codec()):
        logits, cache = model.prefill_fn(tree, batch, MAX_LEN)
        tok = torch.argmax(logits, -1)
        out, toks = [logits], [tok]
        for _ in range(STEPS):
            logits, cache = model.decode_fn(tree, cache, tok)
            tok = torch.argmax(logits, -1)
            out.append(logits)
            toks.append(tok)
    return torch.stack(out), torch.stack(toks)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 \
        else t.view(torch.int16)


def test_encode_matches_reference(ref):
    got = encdec.encode(ref["params"], ref["cfg"], ref["batch"]["frames"])
    assert got.dtype == torch.bfloat16
    _within_ulps(got.float().numpy(), ref["enc"], ENC_ULPS)


def test_prefill_and_decode_match_reference(ref):
    logits, toks = _serve(ref["model"], ref["params"], ref["batch"])
    assert logits.shape == ref["want"].shape
    _within_ulps(logits.numpy(), ref["want"], LOGIT_ULPS)
    np.testing.assert_array_equal(toks.numpy(), ref["want_toks"])


def test_modes_bitwise_equal(ref):
    base, base_toks = _serve(ref["model"], ref["params"], ref["batch"])
    for mode in ("dense", "stream", "fused"):
        codec = Codec(block_elems=1024)
        with use_codec(codec):
            tree = assign_weight_modes(ref["params"], mode=mode,
                                       min_bytes=MIN_BYTES, shards=SHARDS,
                                       codec=codec)
        mix = mode_mix(tree)
        assert mix.get("dense" if mode == "dense" else "stream", 0) > 0, \
            (mode, mix)
        logits, toks = _serve(ref["model"], tree, ref["batch"], codec)
        assert torch.equal(_bits(logits), _bits(base)), mode
        assert torch.equal(toks, base_toks), mode


def test_row_alone_equals_row_in_batch(ref):
    both, _ = _serve(ref["model"], ref["params"], ref["batch"])
    for row in range(2):
        alone = {k: v[row:row + 1] for k, v in ref["batch"].items()}
        one, _ = _serve(ref["model"], ref["params"], alone)
        assert torch.equal(_bits(one[:, 0]), _bits(both[:, row])), row


def test_decode_step_on_buffers_equals_decode_fn(ref):
    model, params, batch = ref["model"], ref["params"], ref["batch"]
    want, want_toks = _serve(model, params, batch)
    state = model.init_step_state(2, MAX_LEN, enc_len=FRAMES, device="cpu")
    for row in range(2):
        _, cache = model.prefill_fn(
            params, {k: v[row:row + 1] for k, v in batch.items()}, MAX_LEN)
        encdec.load_prefill(state, cache, row)
    state["tokens"].copy_(torch.from_numpy(ref["want_toks"][0]))
    for step in range(STEPS):
        model.decode_step(params, state, 2)
        assert torch.equal(_bits(state["logits"]), _bits(want[step + 1]))
        assert torch.equal(state["tokens"], want_toks[step + 1])
    assert state["lengths"].tolist() == [PROMPT + STEPS] * 2


@pytest.mark.parametrize("layout", LAYOUTS)
def test_checkpoint_both_ways_packs_identical(ref, tmp_path, layout):
    kw = dict(serving_layout=layout, serving_min_bytes=MIN_BYTES,
              serving_shards=SHARDS)
    CheckpointManager(tmp_path / "port", device="cpu", **kw).save(
        3, {"params": ref["params"]}, blocking=True)
    JaxCheckpointManager(tmp_path / "ref", **kw).save(
        3, {"params": ref["jparams"]}, blocking=True)
    step = "step_000000000003"
    names = sorted(p.name for p in (tmp_path / "ref" / step).iterdir())
    assert sorted(p.name for p in (tmp_path / "port" / step).iterdir()) \
        == names
    packs = [n for n in names if n.startswith("pack-")]
    assert packs
    for name in packs:
        assert (tmp_path / "port" / step / name).read_bytes() == \
            (tmp_path / "ref" / step / name).read_bytes(), name
    if layout is not None:
        return
    # each package restores the other's dense tree exactly
    back, _ = CheckpointManager(tmp_path / "ref", device="cpu").load(
        {"params": registry.abstract_params(ref["cfg"])})
    for (path, got), (_, want) in zip(tree_leaves(back["params"]),
                                      tree_leaves(ref["params"])):
        assert torch.equal(_bits(got), _bits(want)), path
    jback, _ = JaxCheckpointManager(tmp_path / "port").load(
        {"params": ref["jparams"]})
    for (path, got), (_, want) in zip(
            jax.tree_util.tree_flatten_with_path(jback["params"])[0],
            jax.tree_util.tree_flatten_with_path(ref["jparams"])[0]):
        np.testing.assert_array_equal(
            np.asarray(got).view(np.uint16), np.asarray(want).view(np.uint16))


def test_abstract_trees_match_reference(ref):
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    got = dict(tree_leaves(registry.abstract_params(cfg)))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax_registry.abstract_params(jcfg))[0]}
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path
    specs = registry.cache_specs(cfg, 3, 16)
    jspecs = jax_registry.cache_specs(jcfg, 3, 16)
    assert set(specs) == set(jspecs)
    for k in specs:
        assert tuple(specs[k].shape) == tuple(jspecs[k].shape), k
        assert str(specs[k].dtype).split(".")[-1] == str(jspecs[k].dtype), k


def test_serve_refuses_whisper_naming_the_registry():
    with pytest.raises(ValueError, match="models.registry.build_model"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
