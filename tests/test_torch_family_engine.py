"""The port's own contracts on the recurrent and prefix families (xLSTM,
the Jamba hybrid, PaliGemma), on their smoke configs with the port's
seeded weights (tests/test_torch_families.py holds the same models
against the JAX package):

* the engine's logits bitwise equal to each request served alone by the
  one-shot loop, under a staggered join (buckets 1, 2 and 4) in which a
  slot is reused after its request finished;
* a bucket's capture on the card (warm-up, capture, replay) leaves the
  recurrent state as it found it, modelled on the CPU;
* xLSTM's recurrent state handed from a prefill to the decode step
  bitwise;
* Jamba served with an expert store bitwise equal to serving its stacks;
* a strict save -> restore -> serve of each family bitwise;
* a decode step's attention rows independent of the batch.
"""
import contextlib
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.codec_api import Codec, use_codec
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.streaming import assign_weight_modes

ARCHS = ("xlstm_125m", "jamba_v0_1_52b", "paligemma_3b")
PROMPT = 8


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


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    cfg = get_smoke_config(request.param)
    model = build_model(cfg)
    return {"arch": request.param, "cfg": cfg, "model": model,
            "params": model.init(seed=0, device="cpu")}


def _one_shot(model, params, prompt, n_new, max_len):
    """The port's batch-1 one-shot loop: prefill, then argmax decode."""
    logits, cache = model.prefill_fn(
        params, {"tokens": torch.from_numpy(prompt[None, :]).long()},
        max_len)
    tok = torch.argmax(logits, -1)
    outs = [logits[0]]
    for _ in range(n_new - 1):
        logits, cache = model.decode_fn(params, cache, tok)
        tok = torch.argmax(logits, -1)
        outs.append(logits[0])
    return outs


def test_engine_bitwise_to_one_shot_under_a_staggered_join(fam):
    """Request 0 alone (bucket 1), then 1 (bucket 2), then 2, 3 and 4
    (bucket 4); request 0 finishes first, so a later request prefills into
    its slot: the prefill must install the whole state, K/V and recurrent,
    leaving nothing of request 0 in the slot.  Stream mode: the recurrent
    blocks' leaves are streamed (through the prefetch pipeline for xLSTM's
    three periods, serially for Jamba's one); the modes are held bitwise
    to each other above, and on the card through the engine."""
    model, cfg = fam["model"], fam["cfg"]
    # 1024-element blocks: the smoke leaves are smaller than one default
    # block (16384), which would leave them all raw
    codec = Codec(block_elems=1024)
    with use_codec(codec):
        tree = assign_weight_modes(fam["params"], mode="stream",
                                   min_bytes=1024, shards=2, codec=codec)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (5, PROMPT)).astype(np.int32)
    n_new = [3, 4, 4, 4, 4]
    ecfg = EngineConfig(max_slots=4, max_prompt_len=PROMPT,
                        max_new_tokens=4, collect_logits=True)
    # a clock that stands still: the overload governor must not shed a
    # request because a worker of a loaded test run was slow
    engine = Engine(model, tree, ecfg, codec=codec, device="cpu",
                    clock=lambda: 0.0)
    reqs = [engine.submit(prompts[0], n_new[0], name="r0")]
    engine.step()                        # r0 in slot 0: bucket 1
    reqs.append(engine.submit(prompts[1], n_new[1], name="r1"))
    engine.step()                        # r0, r1: bucket 2; r0 finishes
    assert reqs[0].state == "done"
    reqs += [engine.submit(prompts[i], n_new[i], name=f"r{i}")
             for i in (2, 3, 4)]         # r2 reuses slot 0: bucket 4
    engine.run_until_idle()
    assert engine.counters["prefills"] == 5 > ecfg.max_slots
    assert engine.step_buckets[:3] == [1, 2, 4]
    with use_codec(codec):
        for i, req in enumerate(reqs):
            assert req.state == "done", (i, req.state)
            alone = _one_shot(model, tree, prompts[i], n_new[i],
                              ecfg.max_len)
            assert len(req.logits) == len(alone) == n_new[i]
            for t, (got, want) in enumerate(zip(req.logits, alone)):
                assert torch.equal(_bits(got), _bits(want)), (i, t)


def test_xlstm_state_handoff_exact():
    """The reference's ``test_ssm_state_handoff_exact`` on the port:
    prefill(P) then one decode of token t against the prefill of P + [t].
    Both run the same cells on row-independent products, so the logits and
    every recurrent state are bitwise equal (the reference holds its
    logits within 1e-4).  The hybrid and the VLM have no such identity:
    a prefill's MoE capacity drops tokens a one-token step never does, and
    flash attention's prefill sums in another order than a decode step."""
    cfg = get_smoke_config("xlstm_125m")
    model = build_model(cfg)
    params = model.init(seed=3, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, PROMPT),
                            generator=torch.Generator().manual_seed(3))
    logits, cache = model.prefill_fn(params, {"tokens": prompts}, 32)
    tok = torch.argmax(logits, -1)
    dec, cache = model.decode_fn(params, cache, tok)
    tf_logits, tf_cache = model.prefill_fn(
        params, {"tokens": torch.cat([prompts, tok[:, None]], 1)}, 33)
    assert torch.equal(_bits(dec), _bits(tf_logits))
    for e, tf_e in zip(cache["entries"], tf_cache["entries"]):
        assert set(e) in ({"c", "n", "m"}, {"c", "n", "h", "m"})
        for k in e:
            assert torch.equal(e[k], tf_e[k]), k


def test_jamba_expert_store_serves_bitwise():
    """``launch.serve`` on the Jamba smoke config, fused, with and without
    ``--expert-cache-mb``: the store holds the MoE positions' experts only
    (every odd position of the period), and the logits are equal."""
    base = ["--arch", "jamba_v0_1_52b", "--smoke", "--device", "cpu",
            "--tokens", "3", "--batch", "2", "--prompt-len", "6",
            "--min-bytes", "1024", "--mode", "fused"]
    ref = serve.main(base)
    for mb in ("0",):
        got = serve.main(base + ["--expert-cache-mb", mb])
        assert got["stream_stats"]["expert_tensors"] == 3 * 4
        assert got["experts"]["misses"] > 0
        assert torch.equal(got["tokens"], ref["tokens"]), mb
        assert torch.equal(_bits(got["logits"]), _bits(ref["logits"])), mb


@pytest.mark.parametrize("arch", ARCHS)
def test_strict_save_restore_serve_bitwise(arch):
    """``launch.serve`` fused with ``--save-ckpt`` (it serves the tree it
    saved), then ``--ckpt --strict``: the restored run bitwise equal."""
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--tokens", "3",
            "--batch", "2", "--prompt-len", "6", "--min-bytes", "1024",
            "--mode", "fused"]
    with tempfile.TemporaryDirectory() as d:
        saved = serve.main(base + ["--save-ckpt", d])
        restored = serve.main(base + ["--ckpt", d, "--strict"])
    assert restored["health"] == "ready"
    assert restored["restore"]["h2d_dense_bytes"] \
        < restored["restore"]["h2d_compressed_bytes"]
    assert torch.equal(restored["tokens"], saved["tokens"])
    assert torch.equal(_bits(restored["logits"]), _bits(saved["logits"]))


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeEvent:
    def __init__(self, **_):
        pass

    def record(self, *_):
        pass

    def elapsed_time(self, _):
        return 0.0


class _ModelGraph:
    """A CUDA graph's contract on the CPU: capturing runs nothing, each
    replay runs the captured step once."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _fake_card(monkeypatch, engine):
    """Route ``engine.captured`` through its card path (warm-up, capture,
    replay) on the CPU, with the graph modelled by :class:`_ModelGraph`."""
    from repro_torch.runtime import captured
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda *_: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(captured, "record", lambda graph, capture, fn:
                        captured.Replay(_ModelGraph(fn), {}))
    step = engine.captured
    step.device, step.stream, step.side, step.pool = (
        torch.device("cuda"), _FakeStream(), None, None)


@pytest.mark.parametrize("arch", ["xlstm_125m", "jamba_v0_1_52b"])
def test_capture_warm_up_leaves_the_recurrent_state(monkeypatch, arch):
    """A bucket's first step on the card runs the step once eagerly (the
    warm-up) before capturing it, then replays the graph.  The warm-up
    advances the recurrent state in place; the engine's captured step puts
    it back, so the replay's logits equal the request served alone (on
    the card without that, phase families' bucket-4 replays differed from
    the eager step)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(seed=1, device="cpu")
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    ecfg = EngineConfig(max_slots=2, max_prompt_len=PROMPT,
                        max_new_tokens=3, collect_logits=True)
    engine = Engine(model, params, ecfg, device="cpu", clock=lambda: 0.0)
    _fake_card(monkeypatch, engine)
    reqs = [engine.submit(p, 3) for p in prompts]
    engine.run_until_idle()
    assert engine.step_captured[0] and set(engine.captured.graphs) == {2}
    for prompt, req in zip(prompts, reqs):
        alone = _one_shot(model, params, prompt, 3, ecfg.max_len)
        for got, want in zip(req.logits, alone):
            assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("s_len", [80, 1500])
@pytest.mark.parametrize("heads", [(8, 1, 256), (32, 8, 64), (24, 8, 128)],
                         ids=["paligemma", "llama", "minitron"])
def test_decode_attention_rows_independent_of_batch(s_len, heads):
    """A row of ``layers.decode_attention`` has the same bits alone as in
    a batch of 4 (ragged lengths): every sum is a fixed-order sum.  The
    einsum form it replaced gave PaliGemma's single-KV-head rows other
    bits at batch 1 than at batch 4, on the card and here (llama's at a
    1500-position cache on the card)."""
    from repro_torch.models.layers import decode_attention
    h, kv, hd = heads
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(4, 1, h, hd, generator=gen).bfloat16()
    k = torch.randn(4, s_len, kv, hd, generator=gen).bfloat16()
    v = torch.randn(4, s_len, kv, hd, generator=gen).bfloat16()
    lengths = torch.tensor([s_len - 3, 40, 7, s_len])
    full = decode_attention(q, k, v, lengths)
    for i in range(4):
        row = decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                               lengths[i:i + 1])
        assert torch.equal(_bits(row), _bits(full[i:i + 1])), i
    # against f32 attention on the visible positions (the probabilities
    # round to bf16 before P.V, as in the reference: 2**-8 relative each)
    for i in range(4):
        n = int(lengths[i])
        qf = q[i, 0].float().reshape(kv, h // kv, hd)
        kf, vf = k[i, :n].float(), v[i, :n].float()
        w = torch.softmax(torch.einsum("kgh,skh->kgs", qf, kf)
                          / hd ** 0.5, -1)
        want = torch.einsum("kgs,skh->kgh", w, vf).reshape(h, hd)
        np.testing.assert_allclose(full[i, 0].numpy(), want.numpy(),
                                   atol=2e-2, rtol=0)
