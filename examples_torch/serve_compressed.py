"""Batched serving with ENEC weight streaming (the paper's §VI-C scenario).

Weights live ONLY in compressed form; each layer's streams are decoded to
a dense weight just before the layer runs (on ``cuda`` by the port's
decode kernel).  Outputs are bit-identical to dense serving — ENEC is
lossless.  The PyTorch port's counterpart of
``examples/serve_compressed.py``; the port runs every layer eagerly.

    PYTHONPATH=src python examples_torch/serve_compressed.py --batch 4 \\
        --tokens 16 [--device cpu]
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core import Codec, use_codec
from repro_torch.models import build_model
from repro_torch.runtime.streaming import (compress_params_for_streaming,
                                           stream_stats,
                                           streaming_encode_plan)


def config():
    """The example's model: the qwen3_32b smoke config widened as the
    reference example does (its ``scan_layers`` is read by no port
    module)."""
    return dataclasses.replace(get_smoke_config("qwen3_32b"),
                               n_layers=4, d_model=256, n_heads=8,
                               n_kv_heads=4, head_dim=32, d_ff=1024,
                               vocab_size=4096, scan_layers=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model, params, prompts, tokens: int) -> dict:
    """Compress ``params`` for streaming, serve ``prompts`` greedily for
    ``tokens`` tokens from the streamed tree and check the prefill's
    logits bitwise against the dense tree's.  Returns the tokens,
    ``stream_stats`` and TTFT / TPOT in seconds."""
    dev = prompts.device
    # this server's explicit Codec instance: its caches and counters are
    # isolated from any other model in the process
    codec = Codec()
    plan = streaming_encode_plan(params, min_bytes=4096, shards=2,
                                 codec=codec)
    print(f"[serve] encode plan: {len(plan.buckets)} dispatch(es), "
          f"~{plan.predicted_wire_bytes / 1e6:.2f} MB predicted wire")
    # hand the inspected plan back: it runs as planned, not re-planned
    streamed = compress_params_for_streaming(params, min_bytes=4096,
                                             shards=2, codec=codec,
                                             plan=plan)
    stats = stream_stats(streamed)
    print("[serve] stream stats:", stats)
    max_len = prompts.shape[1] + tokens

    # StreamedWeight handles resolve inside the model; the decodes run on
    # THIS codec (the ambient one under use_codec)
    with use_codec(codec):
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(streamed, {"tokens": prompts},
                                         max_len)
        _sync(dev)
        ttft = time.perf_counter() - t0
        # cross-check against dense weights: lossless -> bit-identical
        logits_dense, _ = model.prefill_fn(params, {"tokens": prompts},
                                           max_len)
        if not torch.equal(logits_dense.view(torch.int32),
                           logits.view(torch.int32)):
            raise AssertionError("streamed prefill logits differ from "
                                 "the dense tree's")
        tok = torch.argmax(logits, -1)

        out_tokens = [tok]
        t0 = time.perf_counter()
        for _ in range(tokens - 1):
            logits, cache = model.decode_fn(streamed, cache, tok)
            tok = torch.argmax(logits, -1)
            out_tokens.append(tok)
        _sync(dev)
        tpot = (time.perf_counter() - t0) / max(tokens - 1, 1)

    gen = torch.stack(out_tokens, dim=1)
    print(f"[serve] batch={prompts.shape[0]} TTFT={ttft*1e3:.1f} ms "
          f"TPOT={tpot*1e3:.1f} ms/token")
    print("[serve] generated token ids (first sequence):",
          gen[0].tolist())
    print("[serve] streamed outputs verified bit-identical to dense weights")
    return {"tokens": gen, "stream_stats": stats, "ttft_s": ttft,
            "tpot_s": tpot, "encode_buckets": len(plan.buckets)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    return serve(model, params, prompts, args.tokens)


if __name__ == "__main__":
    main()
