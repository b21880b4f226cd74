"""The port's wire format against ``repro.core.wire`` on the same inputs:
frames and records byte-identical, each package reading what the other
wrote, exact ``nbytes_wire`` accounting, and the same rejections of
truncated, flipped, foreign and over-long records.  Every comparison is
exact (bytes or bits): the format is lossless.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as jax_wire
from repro.core.codec_api import Codec as JaxCodec
from repro.core.params import EnecParams
from repro_torch.core import api, wire
from repro_torch.core.codec_api import Codec

BLOCK = 2048


def _weights(shape, seed, outlier=2e-3):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape) * 0.015
    w[rng.random(shape) < outlier] *= 64
    return np.asarray(jnp.asarray(w.astype(np.float32)).astype(jnp.bfloat16))


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _fixed_m_equals_n(a):
    exp = (a.view(np.uint16).astype(np.int64) >> 7) & 0xFF
    lo, hi = int(exp.min()), int(exp.max())
    n = max((hi - lo).bit_length(), 1)
    return EnecParams(b=hi, n=n, m=n, L=16, l=lo)


def _pair(kind):
    """(reference ct, port ct, stacked) of one case."""
    jc, tc = JaxCodec(block_elems=BLOCK), Codec(block_elems=BLOCK)
    if kind == "enec":
        a = _weights(40_000, seed=1)
        return jc.compress_array(jnp.asarray(a)), tc.compress_array(
            _torch(a)), False
    if kind == "width0":
        a = _weights(9000, seed=2)
        p = _fixed_m_equals_n(a)
        return (jc.compress_array(jnp.asarray(a), p=p),
                tc.compress_array(_torch(a), p=p), False)
    if kind == "raw":
        a = np.arange(100, dtype=np.int32)
        return jc.compress_array(jnp.asarray(a)), tc.compress_array(
            _torch(a)), False
    if kind == "const":
        a = np.full((64, 40), 0.5, np.float32)
        return jc.compress_array(jnp.asarray(a)), tc.compress_array(
            _torch(a)), False
    shards = int(kind[-1])       # "stacked1" / "stacked2"
    a = _weights((3, 96, 200), seed=3)
    [jct] = jc.compress_stacked_many([jnp.asarray(a)], shards=shards)
    [tct] = tc.compress_stacked_many([_torch(a)], shards=shards)
    return jct, tct, True


KINDS = ["enec", "width0", "raw", "const", "stacked1", "stacked2"]


def _dense(ct, stacked, codec):
    out = codec.decompress_stacked(ct) if stacked else \
        codec.decompress_array(ct)
    return np.asarray(out).view(np.uint8) if not isinstance(
        out, torch.Tensor) else out.contiguous().view(torch.uint8).numpy()


def test_frame_bytes_and_iteration_match_reference():
    payloads = [b"", b"x", b"hello world" * 100]
    pack = b"".join(wire.frame(p) for p in payloads)
    assert pack == b"".join(jax_wire.frame(p) for p in payloads)
    got = [(off, bytes(p)) for off, p in wire.iter_frames(pack)]
    assert got == [(off, bytes(p)) for off, p in jax_wire.iter_frames(pack)]
    for off, p in got:
        q, _ = wire.read_frame(pack, off)
        assert bytes(q) == p


@pytest.mark.parametrize("kind", KINDS)
def test_records_byte_identical_and_read_both_ways(kind):
    jct, tct, stacked = _pair(kind)
    assert tct.mode == jct.mode
    if kind == "width0":
        assert tct.streams.high.shape[-1] == 0
    blob = wire.to_wire(tct, stacked=stacked)
    ref_blob = jax_wire.to_wire(jct, stacked=stacked)
    assert blob == ref_blob
    assert wire.frame(blob) == jax_wire.frame(ref_blob)
    # exact accounting: nbytes_wire is the framed record's length
    assert tct.nbytes_wire() == len(wire.frame(blob))
    want = _dense(jct, stacked, JaxCodec(block_elems=BLOCK))
    # the port reads what the reference wrote ...
    back = wire.from_wire(ref_blob, device="cpu")
    assert back.nbytes_wire() == len(wire.frame(ref_blob))
    np.testing.assert_array_equal(_dense(back, stacked, Codec()), want)
    if back.mode == "enec":
        for name in tct.streams._fields:
            assert torch.equal(getattr(back.streams, name),
                               getattr(tct.streams, name)), name
        assert wire.wire_stack(back) == (3 if stacked else 0)
    # ... and the reference reads what the port wrote
    jback = jax_wire.from_wire(blob)
    np.testing.assert_array_equal(
        _dense(jback, stacked, JaxCodec(block_elems=BLOCK)), want)


def test_from_wire_counts_h2d_on_the_given_codec():
    _, tct, _ = _pair("enec")
    codec = Codec()
    back = wire.from_wire(wire.to_wire(tct), codec, device="cpu")
    h2d = codec.link_stats()["h2d"]
    assert h2d["dense_bytes"] == 0 and h2d["ops"] == 5
    # exactly the record's stream bytes: its exact high stream crosses as
    # it is on the wire, not in the padded device layout
    streams = back.nbytes_wire() - api.record_overhead_bytes(
        "enec", len(back.shape))
    assert h2d["compressed_bytes"] == streams < back.nbytes_device()
    _, raw, _ = _pair("raw")
    wire.from_wire(wire.to_wire(raw), codec, device="cpu")
    assert codec.link_stats()["h2d"]["dense_bytes"] == 400
    totals = codec.transfer_stats()
    assert totals["h2d_arrays"] == 6
    assert totals["h2d_bytes"] == streams + 400
    assert totals["links"] == codec.link_stats()


def test_frame_rejects_truncation_bitflip_and_bad_magic():
    fr = wire.frame(b"some payload bytes")
    with pytest.raises(wire.WireError, match="truncated"):
        wire.read_frame(fr[:-3])
    with pytest.raises(wire.WireError, match="header truncated"):
        wire.read_frame(fr[: jax_wire.FRAME_HEADER_BYTES - 2])
    flipped = bytearray(fr)
    flipped[jax_wire.FRAME_HEADER_BYTES + 4] ^= 0x20
    with pytest.raises(wire.WireError, match="CRC"):
        wire.read_frame(bytes(flipped))
    with pytest.raises(wire.WireError, match="magic"):
        wire.read_frame(b"\x00" * len(fr))
    err = pytest.raises(wire.WireError, wire.read_frame, fr[:-3],
                        record="embed", pack="pack-00001.bin",
                        base_offset=96)
    assert "record=embed" in str(err.value)
    assert "pack=pack-00001.bin" in str(err.value)
    assert "offset=96" in str(err.value)


def test_record_truncation_garbage_and_raw_length_rejected():
    _, tct, _ = _pair("enec")
    blob = wire.to_wire(tct)
    with pytest.raises(wire.WireError):
        wire.from_wire(blob[:-3], device="cpu")     # truncated high stream
    with pytest.raises(wire.WireError):
        wire.from_wire(blob[:20], device="cpu")     # truncated header
    with pytest.raises(wire.WireError, match="trailing"):
        wire.from_wire(blob + b"\x00\x00", device="cpu")
    with pytest.raises(wire.WireError, match="magic"):
        wire.from_wire(b"\xff" * len(blob), device="cpu")
    _, raw, _ = _pair("raw")
    rblob = wire.to_wire(raw)
    with pytest.raises(wire.WireError, match="payload bytes"):
        wire.from_wire(rblob[:-4], device="cpu")
    # the reference rejects the same corruptions
    for bad in (blob[:-3], blob[:20], blob + b"\x00\x00"):
        with pytest.raises(jax_wire.WireError):
            jax_wire.from_wire(bad)


# the exact high-stream bit strings: every width the wire can carry, a
# count that is not a multiple of 8 lanes, and the empty stream
@pytest.mark.parametrize("width", [0, 1, 3, 7, 8, 13, 24])
def test_exact_bit_strings_byte_identical_to_reference(width):
    from repro.core import bitio as jax_bitio
    from repro_torch.core import bitio
    rng = np.random.default_rng(width)
    counts = np.array([0, 1, 13, 1000, 37])
    lanes = 1024
    vals = rng.integers(0, 1 << max(width, 1), (len(counts), lanes)) \
        * (np.arange(lanes)[None, :] < counts[:, None]) * (width > 0)
    # save: straight rows -> each block's exact bytes, the reference's
    straight = bitio.pack_straight(torch.from_numpy(vals), width).numpy()
    nbytes = (counts * width + 7) // 8
    exact = bitio.exact_from_straight(straight, nbytes)
    assert exact == b"".join(
        jax_bitio.np_pack_bits_exact(v[:c].astype(np.uint64), width)
        for v, c in zip(vals, counts))
    # load: exact bytes -> straight rows -> lanes, the reference's values
    back = bitio.unpack_straight(bitio.straight_from_exact(
        torch.from_numpy(np.frombuffer(exact, np.uint8).copy()),
        torch.from_numpy(nbytes), bitio.straight_nbytes(lanes, width)),
        lanes, width).numpy()
    np.testing.assert_array_equal(back, vals)
    starts = np.concatenate([[0], np.cumsum(nbytes)])
    for b, c in enumerate(counts):
        np.testing.assert_array_equal(
            back[b, :c], jax_bitio.np_unpack_bits_exact(
                exact[starts[b]:starts[b + 1]], int(c), width))


def test_retry_policy_counts_like_the_reference():
    from repro.runtime.retry import RetryPolicy as JaxRetryPolicy
    from repro_torch.runtime.retry import RetryPolicy
    attempts = []
    for policy in (RetryPolicy(max_attempts=4, base_delay_s=0.0),
                   JaxRetryPolicy(max_attempts=4, base_delay_s=0.0,
                                  sleep=lambda s: None)):
        tries = []
        fails = iter([OSError("one"), OSError("two")])

        def flaky():
            tries.append("flaky")
            err = next(fails, None)
            if err is not None:
                raise err
            return "ok"

        def always(exc):
            def fn():
                tries.append(type(exc).__name__)
                raise exc
            return fn

        assert policy.call(flaky) == "ok"
        with pytest.raises(OSError):
            policy.call(always(OSError("always")))
        with pytest.raises(ValueError):      # not retried
            policy.call(always(ValueError("bad")))
        attempts.append(tries)
    assert attempts[0] == attempts[1]
    assert attempts[0] == ["flaky"] * 3 + ["OSError"] * 4 + ["ValueError"]
    # the same seeded jitter schedule
    port, ref = RetryPolicy(seed=7), JaxRetryPolicy(seed=7)
    assert [port.backoff_s(a) for a in range(1, 6)] == \
        [ref.backoff_s(a) for a in range(1, 6)]
