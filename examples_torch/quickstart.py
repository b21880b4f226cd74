"""Quickstart: losslessly compress a model's weights with ENEC on the card.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The PyTorch port's counterpart of ``examples/quickstart.py``: construct a
``Codec``, compress realistic BF16 weights, verify bit-identical
reconstruction and the wire round trip, inspect an encode plan (bucket
assignment + launch count), and print the searched (b, n, m, L)
parameters and the compression ratio.  On ``cuda`` (the default) the
encoder and decoder are the port's CUDA kernels; ``--device cpu`` runs
their plain versions.  Every printed line equals the JAX example's: both
packages draw the same weights and compress them to the same bytes.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import BF16, Codec, search_for_array, tree_ratio
from repro_torch.core.wire import from_wire, to_wire
from repro_torch.data.synthetic_weights import PAPER_MODELS, generate


def _bits(x: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bit patterns on the host."""
    return x.cpu().view(torch.int16).numpy().view(np.uint16)


def _check(cond, msg: str):
    if not cond:
        raise AssertionError(msg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = next(s for s in PAPER_MODELS if s.name == "Qwen3-32B")
    print(f"== ENEC quickstart: {spec.name} ({spec.dtype}) ==")
    x = generate(spec, device=dev)
    bits_in = _bits(x)
    p = search_for_array(bits_in, BF16)
    print(f"searched params   : (b, n, m, L) = {p.astuple()}  "
          f"(paper Table IV: (122, 6, 3, 16))")

    codec = Codec()   # instance-scoped caches/counters; no process globals
    ct = codec.compress_array(x, p)
    y = codec.decompress_array(ct)
    _check((bits_in == _bits(y)).all(), "decompressed bits differ")
    print(f"lossless          : True (bit-identical, {x.numel():,} "
          f"elements)")
    print(f"compression ratio : {ct.ratio():.3f}x  (paper Table II: 1.35)")

    blob = to_wire(ct)
    ct2 = from_wire(blob, codec=codec, device=dev)
    _check((_bits(codec.decompress_array(ct2)) == bits_in).all(),
           "the wire round trip changed the bits")
    print(f"wire format       : {len(blob):,} bytes "
          f"(raw {x.numel() * 2:,}); round-trips exactly")

    tree = {"layer0": {"w": x[: 1 << 20].reshape(1024, 1024)},
            "scale": torch.ones((16,), dtype=torch.float32, device=dev)}
    # plan/execute split: the bucket assignment is inspectable data — one
    # encoder launch per bucket, known before anything runs
    plan = codec.plan_encode(tree)
    print(f"encode plan       : {len(plan.buckets)} dispatch(es) for "
          f"{plan.n_inputs} leaves, ~{plan.predicted_wire_bytes:,} "
          f"predicted wire bytes")
    ctree = codec.execute(plan)
    _check(codec.encode_cache_stats()["dispatches"] >= len(plan.buckets),
           "fewer encoder launches than the plan's buckets")
    stats = tree_ratio(ctree)
    print(f"pytree API        : {stats}")


if __name__ == "__main__":
    main()
