"""MoE serving with compressed expert streaming + an LRU decode cache.

Expert stacks never sit dense in memory: each expert is a per-expert
compressed wire record in an ``ExpertStore``, and a routing step
materializes only the experts it routed to, through a byte-budgeted LRU
of decoded experts.  The budget is deliberately constrained here so the
cache both hits AND evicts — and the logits stay bit-identical to dense
serving at any budget, because ENEC is lossless and unrouted slots are
masked to exact zeros.  The PyTorch port's counterpart of
``examples/serve_moe_streaming.py`` (on ``cuda`` the store's misses and
the streamed leaves decode through the port's decode kernel).

    PYTHONPATH=src python examples_torch/serve_moe_streaming.py --tokens 8 \\
        [--device cpu]
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
from repro_torch.models import build_model
from repro_torch.runtime.experts import install_expert_store
from repro_torch.runtime.streaming import assign_weight_modes, mode_mix


def config():
    """The phi3.5-MoE smoke config (its ``scan_layers`` is read by no port
    module)."""
    return dataclasses.replace(get_smoke_config("phi3_5_moe_42b_a6_6b"),
                               scan_layers=True)


def _serve(model, tree, pb, max_len, n_tokens):
    dev = pb["tokens"].device
    logits, cache = model.prefill_fn(tree, pb, max_len)
    tok = torch.argmax(logits, -1)
    outs = [logits]
    gen = [tok]
    t0 = time.perf_counter()
    for _ in range(n_tokens - 1):
        dec, cache = model.decode_fn(tree, cache, tok)
        tok = torch.argmax(dec, -1)
        outs.append(dec)
        gen.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tpot = (time.perf_counter() - t0) / max(n_tokens - 1, 1)
    return outs, torch.stack(gen, dim=1), tpot


def serve(model, params, prompts, tokens: int, budget_frac: float) -> dict:
    """Serve ``prompts`` from the dense tree, then from an expert store at
    ``budget_frac`` of the expert bytes with the rest streamed; check every
    step's logits bitwise and the tokens equal.  Returns the tokens, the
    store's ``stats()`` and ``total_expert_bytes``."""
    pb = {"tokens": prompts}
    max_len = prompts.shape[1] + tokens + 2

    # dense reference first: the streamed serve must reproduce these bits
    ref, ref_gen, _ = _serve(model, params, pb, max_len, tokens)

    tree, store = install_expert_store(params)
    store.budget_bytes = int(budget_frac * store.total_expert_bytes())
    tree = assign_weight_modes(tree, mode="stream", min_bytes=1024)
    print(f"[moe] {store.stats()['records']} expert records, "
          f"{store.total_expert_bytes() / 1e3:.0f} KB dense-equivalent, "
          f"budget {store.budget_bytes / 1e3:.0f} KB "
          f"({budget_frac:.0%}); mode_mix={mode_mix(tree)}")

    got, gen, tpot = _serve(model, tree, pb, max_len, tokens)
    for i, (r, g) in enumerate(zip(ref, got)):
        if not torch.equal(r.view(torch.int32), g.view(torch.int32)):
            raise AssertionError(f"step {i}: streamed-expert logits differ "
                                 f"from the dense tree's")
    if not torch.equal(gen, ref_gen):
        raise AssertionError("streamed-expert tokens differ from dense")

    st = store.stats()
    hit_rate = st["hits"] / max(1, st["hits"] + st["misses"])
    print(f"[moe] experts: hits={st['hits']} misses={st['misses']} "
          f"evictions={st['evictions']} hit_rate={hit_rate:.2f} "
          f"fetches={st['fetches']} buckets={st['fetch_buckets']} "
          f"resident={st['resident_bytes'] / 1e3:.0f} KB")
    print(f"[moe] TPOT={tpot * 1e3:.1f} ms/token; miss-decode total "
          f"{st['decode_s'] * 1e3:.1f} ms")
    if st["evictions"] == 0 or st["hits"] == 0:
        raise SystemExit("budget did not constrain the cache "
                         f"(hits={st['hits']} evictions={st['evictions']})")
    print("[moe] generated token ids (first sequence):", gen[0].tolist())
    print("[moe] streamed-expert outputs verified bit-identical to dense")
    return {"tokens": gen, "stats": st,
            "total_expert_bytes": store.total_expert_bytes(),
            "tpot_s": tpot}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--budget-frac", type=float, default=0.75,
                    help="expert-cache budget as a fraction of the fully-"
                         "resident expert bytes (0.75 sits between one "
                         "layer's working set and full residency, so the "
                         "LRU both hits and evicts)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    return serve(model, params, prompts, args.tokens, args.budget_frac)


if __name__ == "__main__":
    main()
