"""The port's five examples (``examples_torch/``) on the CPU at their
reference's smoke sizes, held against the JAX package's examples
(``examples/``) on the same weights: ``quickstart``'s stdout line for
line; ``compress_checkpoint``'s manifest (but ``save_s``) and packs byte
for byte on the reference's JAX-made params; ``serve_compressed`` and
``serve_moe_streaming`` through their self-checks with greedy tokens equal
to the reference's (and the expert records and bytes equal);
``train_lm`` at a patched tiny preset resumed bitwise; every example
refusing to run without CUDA unless asked for the CPU.
"""
import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import synthetic_weights as jsw
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.runtime.experts import install_expert_store as jax_install
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "compress_checkpoint", "serve_compressed",
            "serve_moe_streaming", "train_lm")


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


def _load(folder: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str):
    return _load("examples_torch", name)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_cuda_and_raises_without_it(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _port(name).main([])


def test_quickstart_stdout_equals_reference(capsys):
    _load("examples", "quickstart").main()
    want = capsys.readouterr().out
    _port("quickstart").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 7


def _jax_llama_smoke():
    return jax_build_model(jax_smoke_config("llama3_2_1b")).init(
        jax.random.key(0))


def test_compress_checkpoint_equals_reference(tmp_path, capsys):
    """The reference example's state (its JAX-made params) saved by both
    packages: the same manifest but for the save's seconds, the same
    packs byte for byte; the port's restore check passes."""
    jparams = _jax_llama_smoke()
    w = jsw.generate(dataclasses.replace(jsw.PAPER_MODELS[3],
                                         n_elems=1 << 21))
    jstate = {"params": jparams, "realistic_block": w.reshape(1024, 2048),
              "opt": jadamw.init({"w": w[: 1 << 20]})}
    JaxCheckpointManager(tmp_path / "ref", keep_last=2).save(
        1234, jstate, blocking=True)

    ex = _port("compress_checkpoint")
    params = params_from_jax(jax.device_get(jparams), "cpu",
                             cfg=get_smoke_config("llama3_2_1b"))
    manifest = ex.save_and_verify(ex.make_state(params, "cpu"),
                                  tmp_path / "port", "cpu")
    assert "restore verified bit-identical" in capsys.readouterr().out
    step = "step_000000001234"
    want = json.loads((tmp_path / "ref" / step / "manifest.json")
                      .read_text())
    assert manifest.pop("save_s") >= 0 and want.pop("save_s") >= 0
    assert manifest == want
    for pack in want["packs"]:
        assert (tmp_path / "port" / step / pack).read_bytes() == \
            (tmp_path / "ref" / step / pack).read_bytes(), pack


def test_serve_compressed_self_checks_and_tokens_match_reference(capsys):
    """The reference example's model, params and prompts: the port's
    streamed serve passes its bitwise check, and its greedy tokens are the
    reference's (served eagerly from the dense tree, which the reference
    example holds bitwise equal to its streamed tree)."""
    ex = _port("serve_compressed")
    cfg = ex.config()
    jcfg = dataclasses.replace(
        jax_smoke_config("qwen3_32b"), n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, head_dim=32, d_ff=1024, vocab_size=4096,
        scan_layers=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    batch, prompt_len, tokens = 4, 32, 16
    jprompts = jax.random.randint(jax.random.key(1), (batch, prompt_len), 0,
                                  jcfg.vocab_size)
    logits, cache = jmodel.prefill_fn(jparams, {"tokens": jprompts},
                                      prompt_len + tokens)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(tokens - 1):
        logits, cache = jmodel.decode_fn(jparams, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))

    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    out = ex.serve(build_model(cfg), params,
                   torch.from_numpy(np.array(jprompts)), tokens)
    assert "verified bit-identical" in capsys.readouterr().out
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.stack(want, axis=1))
    # the reference example's counts: 9 streams, 2 of them flat
    assert out["stream_stats"]["streamed_tensors"] == 9
    assert out["stream_stats"]["flat_stream_tensors"] == 2
    assert out["encode_buckets"] == 2


def test_serve_moe_streaming_self_checks_and_matches_reference(capsys):
    """The reference example's params and prompts: the port's store both
    hits and evicts, every step bitwise the dense serve, its tokens the
    reference's, and the same expert records and bytes."""
    ex = _port("serve_moe_streaming")
    cfg = ex.config()
    jmodel = jax_build_model(dataclasses.replace(
        jax_smoke_config("phi3_5_moe_42b_a6_6b"), scan_layers=True))
    jparams = jmodel.init(jax.random.key(0))
    batch, prompt_len, tokens = 2, 8, 8
    jprompts = jax.random.randint(jax.random.key(1), (batch, prompt_len), 0,
                                  cfg.vocab_size)
    logits, cache = jmodel.prefill_fn(jparams, {"tokens": jprompts},
                                      prompt_len + tokens + 2)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(tokens - 1):
        logits, cache = jmodel.decode_fn(jparams, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    _, jstore = jax_install(jparams)

    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    out = ex.serve(build_model(cfg), params,
                   torch.from_numpy(np.array(jprompts)), tokens, 0.75)
    assert "verified bit-identical to dense" in capsys.readouterr().out
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.stack(want, axis=1))
    assert out["stats"]["records"] == jstore.stats()["records"] == 24
    assert out["total_expert_bytes"] == jstore.total_expert_bytes()
    assert out["stats"]["hits"] > 0 and out["stats"]["evictions"] > 0


TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512, seq=16, batch=2)


def test_train_lm_resumes_bitwise(tmp_path, monkeypatch, capsys):
    """``small`` patched to a tiny width: 2 steps, then a second call on
    the same directory resumes to 4; its losses, gradient norms and final
    state equal an uninterrupted 4-step run's bitwise."""
    ex = _port("train_lm")
    monkeypatch.setitem(ex.PRESETS, "small", TINY)
    args = ["--device", "cpu", "--ckpt-dir"]
    first = ex.main(args + [str(tmp_path / "a"), "--steps", "2"])
    assert [r["step"] for r in first["history"]] == [0, 1]
    resumed = ex.main(args + [str(tmp_path / "a"), "--steps", "4"])
    assert "resumed from step 2" in capsys.readouterr().out
    whole = ex.main(args + [str(tmp_path / "b"), "--steps", "4"])
    assert [r["step"] for r in resumed["history"]] == [2, 3]
    for got, want in zip(resumed["history"], whole["history"][2:]):
        assert (got["step"], got["loss"], got["grad_norm"]) == \
            (want["step"], want["loss"], want["grad_norm"])
    for name in ("params", "opt_state"):
        for (pa, a), (pb, b) in zip(_leaves(resumed[name]),
                                    _leaves(whole[name])):
            assert pa == pb and torch.equal(a.view(torch.uint8),
                                            b.view(torch.uint8)), pa
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == \
        ["LATEST", "step_000000000002", "step_000000000004"]


def _leaves(tree):
    from repro_torch.core.api import tree_leaves
    return [(p, t.reshape(-1)) for p, t in tree_leaves(tree)]
