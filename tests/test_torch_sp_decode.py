"""The sequence-sharded K/V ring of the serving mesh and its decode
attention (``runtime/sharding.py:kv_layout``, ``models/layers.py:
rank_decode_attention``), on the CPU:

  * every rank's part of the decode attention, run for A in {1, 2, 4}
    ranks in one process (each part's gathers answered by the
    concatenation of the A parts' requests), in both routes (the scores
    gathered; ``decode_score_shard``'s flash-decoding), bitwise equal to
    ``layers.decode_attention`` on the whole cache and within the KV
    attention tolerance of the reference's ``decode_attention`` on the
    same numpy inputs; lengths that stay in rank 0, cross a rank boundary
    and reach the last position;
  * the layout rule: the sequence sharded where a rank's slice is a whole
    number of ``DECODE_CHUNK`` positions, the ring whole otherwise, and
    the pin refused on a ring that cannot be sharded; the ring's shapes,
    offsets and specs that follow from it; the owner-only decode write
    and the prefill's kept positions;
  * the dry-run of llama3_2_1b x decode_32k on the 16x16 mesh on
    ``meta``: rank 0's cache 1/256 of the whole, its peak under 8 GiB, and
    the ``flash_decode`` variant run with fewer gathered bytes.

``serve --tp 2`` over a sharded ring in a gloo world is in
tests/test_torch_mesh.py's world.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import layers, lm
from repro_torch.models.registry import cache_specs
from repro_torch.runtime import sharding

# tests/test_torch_kv_attention.py's tolerance: f32 sums of the same
# products in another order, through exp and one division
ATOL, RTOL = 2e-5, 1e-4
C = layers.DECODE_CHUNK
B, KV, GRP, HD = 3, 2, 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(rng, shape, scale=0.3) -> np.ndarray:
    return np.asarray(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32) * scale).astype(
            jnp.bfloat16))


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _inputs(A: int, k: int, seed: int):
    S = A * k * C
    rng = np.random.default_rng(seed)
    q = _bf16(rng, (B, 1, KV * GRP, HD))
    kc, vc = _bf16(rng, (B, S, KV, HD)), _bf16(rng, (B, S, KV, HD))
    # one row in rank 0's slice, one past a rank boundary (a chunk
    # boundary on one rank), one at the last position
    cross = S // A + 5 if A > 1 else C + 5 if k > 1 else C - 1
    lengths = np.array([7, cross, S], np.int32)
    return q, kc, vc, lengths


def run_ranks(parts) -> list:
    """Drive A ranks' :func:`layers.rank_decode_attention` generators in
    lockstep: each round's requests, concatenated in rank order along
    their dim, answer every rank (what the ranks' gathers deliver)."""
    requests = [next(p) for p in parts]
    while True:
        dim = requests[0][1]
        whole = torch.cat([t for t, _ in requests], dim=dim)
        out, done = [], []
        for p in parts:
            try:
                out.append(p.send(whole))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            assert len(done) == len(parts) and not out
            return done
        requests = out


@pytest.mark.parametrize("score_shard", [False, True],
                         ids=["scores", "flash"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("A", [1, 2, 4])
def test_rank_parts_are_the_whole_cache_bitwise(A, k, score_shard):
    q, kc, vc, lengths = _inputs(A, k, seed=10 * A + k)
    tq, tk, tv = _torch(q), _torch(kc), _torch(vc)
    tl = torch.from_numpy(lengths).long()
    want = layers.decode_attention(tq, tk, tv, tl)
    n = tk.shape[1] // A
    outs = run_ranks([layers.rank_decode_attention(
        tq, tk[:, r * n:(r + 1) * n], tv[:, r * n:(r + 1) * n], tl, r * n,
        score_shard) for r in range(A)])
    for r, got in enumerate(outs):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), r
    # the reference's pin is a sharding constraint, the same math: it
    # runs unpinned here (one device, no mesh to pin on)
    ref = np.asarray(ref_layers.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths)))
    np.testing.assert_allclose(outs[0].numpy(), ref, atol=ATOL, rtol=RTOL)


def _mesh(A: int, rank: int = 0, data: int = 1) -> AbstractMesh:
    return AbstractMesh((data, A), ("data", "model"), rank=rank)


@pytest.mark.parametrize("A,length,sharded", [
    (2, 2048, True), (4, 8192, True), (2, 4096, True), (4, 2048, False),
    (2, 1536, False), (2, 3072, False), (1, 2048, False), (4, 16, False)])
def test_kv_layout_rule(A, length, sharded):
    """Sharded where length % (A x DECODE_CHUNK) == 0, whole otherwise;
    the pin raises, naming the rule, where a sequence axis exists but the
    rule keeps the ring whole."""
    for rank in range(A):
        layout = sharding.kv_layout(_mesh(A, rank), length)
        assert layout.sharded == sharded
        if sharded:
            assert layout.axes == ("model",) and layout.count == A
            assert layout.local_length == length // A
            assert layout.offset == rank * length // A
            assert layout.local_length % C == 0
        else:
            assert layout.spec() is None and layout.why
    if A > 1 and not sharded:
        with pytest.raises(ValueError, match="DECODE_CHUNK"):
            sharding.kv_layout(_mesh(A), length, pin=True)
    else:
        assert sharding.kv_layout(_mesh(A), length, pin=True).sharded \
            == sharded


def test_kv_layout_follows_cache_pspecs_axes():
    """Beside a sharded batch the sequence goes on "model"; beside a batch
    that does not divide, on ("pod", "model"), each rank's block major to
    minor; the engine's (no batch) also on ("pod", "model")."""
    pods = AbstractMesh((2, 2, 2), ("pod", "data", "model"), rank=5)
    assert sharding.kv_layout(pods, 4096, batch=4).axes == ("model",)
    wide = sharding.kv_layout(pods, 4096, batch=1)
    assert wide.axes == ("pod", "model") and wide.count == 4
    # rank 5 is pod 1, data 0, model 1: block 1 * 2 + 1
    assert wide.index == 3 and wide.offset == 3 * 1024
    assert sharding.kv_layout(pods, 4096).axes == ("pod", "model")
    cache = cache_specs(get_smoke_config("jamba_v0_1_52b"), 1, 4096)
    ref = dict(sharding.spec_leaves(sharding.cache_pspecs(cache, pods, 1)))
    port = dict(sharding.spec_leaves(sharding.port_cache_pspecs(
        cache, pods, 1, wide)))
    for path, spec in port.items():
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v"):
            assert spec == ref[path] == (None, None, ("pod", "model"),
                                         None, None)
        else:       # lengths and the Mamba states: the reference's
            assert spec == ref[path], path
    assert any(s[-1] == "model" for p, s in port.items()
               if p.endswith(("/h", "/conv")))


@pytest.mark.parametrize("arch", ["llama3_2_1b", "jamba_v0_1_52b",
                                  "whisper_tiny"])
def test_init_cache_holds_the_ranks_positions(arch):
    from repro_torch.models import build_model
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    for length, want in ((4096, 2048), (3072, 3072)):
        for rank in range(2):
            cache = model.init_cache(2, length, device="meta",
                                     mesh=_mesh(2, rank))
            layout = cache["kv_layout"]
            rings = [cache["k"], cache["v"]] if cfg.is_encdec else [
                e[k] for e in cache["entries"] for k in ("k", "v")
                if k in e]
            assert rings and all(r.shape[2] == want for r in rings)
            assert layout.offset == (rank * want if want < length else 0)
            if cfg.is_encdec:       # the memory's 4096 positions: 2 x 2048
                whole = cache_specs(cfg, 2, length)["mem_k"].shape
                memory = cache["mem_layout"]
                assert memory.sharded and memory.offset == rank * 2048
                assert cache["mem_k"].shape == cache["mem_v"].shape == \
                    whole[:2] + (whole[2] // 2,) + whole[3:]
    assert "kv_layout" not in model.init_cache(2, 4096, device="meta")
    with pytest.raises(ValueError, match="cannot be sharded"):
        import dataclasses
        lm.init_cache(dataclasses.replace(get_smoke_config("llama3_2_1b"),
                                          decode_score_shard=True),
                      2, 3072, device="meta", mesh=_mesh(2))


def test_decode_write_lands_on_the_owner_only():
    """``write_owned`` writes a row's new K/V on the rank whose slice holds
    its position (no host sync: a where on a clamped index); the ranks'
    rings together are one device's ring after the same write."""
    gen = torch.Generator().manual_seed(0)
    whole = torch.randn((3, 2048, 2, 8), generator=gen).bfloat16()
    new = torch.randn((3, 2, 8), generator=gen).bfloat16()
    lengths = torch.tensor([3, 1024, 2047])
    rings = [whole[:, r * 1024:(r + 1) * 1024].clone() for r in range(2)]
    bidx = torch.arange(3)
    for r, ring in enumerate(rings):
        layers.write_owned(ring, bidx, lengths, new, r * 1024)
    one = whole.clone()
    one[bidx, lengths] = new
    assert torch.equal(torch.cat(rings, dim=1).view(torch.int16),
                       one.view(torch.int16))


def test_prefill_keeps_the_ranks_positions():
    """A one-layer smoke llama's prompt of 1100 positions prefilled on each
    of 2 ranks of a 2048-position ring: the ranks' rings together are one
    device's ring (the prompt crosses the ranks' boundary at 1024), their
    logits one device's."""
    import dataclasses
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), n_layers=1)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 1100),
                           generator=torch.Generator().manual_seed(2))
    want_logits, want = model.prefill_fn(params, {"tokens": tokens}, 2048)
    got = [model.prefill_fn(params, {"tokens": tokens}, 2048,
                            mesh=_mesh(2, r)) for r in range(2)]
    for logits, _ in got:
        assert torch.equal(logits.view(torch.int32),
                           want_logits.view(torch.int32))
    for pos, entry in enumerate(want["entries"]):
        for k in ("k", "v"):
            rings = [cache["entries"][pos][k] for _, cache in got]
            assert all(r.shape[2] == 1024 for r in rings)
            assert torch.equal(torch.cat(rings, dim=2).view(torch.int16),
                               entry[k].view(torch.int16))


def test_llama_decode_32k_dry_run_holds_the_ranks_share(tmp_path):
    """Full-width llama3_2_1b x decode_32k on the 16x16 mesh on ``meta``:
    rank 0's cache is 1/256 of the whole (8 of 128 rows x 2048 of 32768
    positions), its peak under 8 GiB; the ``flash_decode`` variant runs
    and gathers fewer bytes than the scores-gathering baseline."""
    cfg = get_config("llama3_2_1b")
    shape = SHAPES["decode_32k"]
    whole = cache_specs(cfg, shape.global_batch, shape.seq_len)
    mesh = dryrun.production_mesh()
    layout = sharding.kv_layout(mesh, shape.seq_len,
                                batch=shape.global_batch)
    local = dryrun.rank_cache(whole, mesh, shape.global_batch, layout)
    rings = [dryrun.tensors_bytes(c["entries"]) for c in (whole, local)]
    assert rings[1] * 256 == rings[0] == 137438953472
    recs = {v: dryrun.run_cell("llama3_2_1b", "decode_32k", tmp_path,
                               ["single"], variant=v)
            for v in ("baseline", "flash_decode")}
    for v, rec in recs.items():
        assert rec["status"] == "ok", (v, rec)
        full = rec["single"]["full"]
        assert full["memory"]["peak_memory_in_bytes"] < 8 * 2 ** 30
        assert "sequence-sharded over model" in full["program"]
        assert full["collectives"]["broadcast"]["count"] > 0
    got = {v: r["single"]["full"]["collectives"]["broadcast"]
           ["result_bytes"] for v, r in recs.items()}
    assert got["flash_decode"] < got["baseline"] / 4
    assert "flash-decoding" in recs["flash_decode"]["single"]["full"][
        "program"]
