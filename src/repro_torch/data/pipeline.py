"""Deterministic, shardable synthetic LM data pipeline.

Produces an infinite stream of (tokens, targets) batches from a seeded
Zipf-ish token source (more realistic loss curves than uniform).  Every
batch is a pure function of (seed, step, host_shard), so any host can
regenerate any slice — restart/elastic-friendly by construction.  A
background prefetch thread keeps one batch ahead of the training loop.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    shard_index: int = 0     # this host's shard
    shard_count: int = 1
    prefix_embed: int = 0    # modality stub width (VLM/audio)
    d_model: int = 0


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                 a: float) -> np.ndarray:
    # bounded zipf via inverse-CDF on a truncated power law
    u = rng.random(shape)
    ranks = np.floor(np.exp(u * np.log(vocab))).astype(np.int64)  # log-uniform
    return np.clip(ranks - 1, 0, vocab - 1).astype(np.int32)


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Materialize this host's slice of batch ``step`` (pure function)."""
    assert cfg.global_batch % cfg.shard_count == 0
    local = cfg.global_batch // cfg.shard_count
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard_index]))
    tokens = _zipf_tokens(rng, (local, cfg.seq_len + 1), cfg.vocab_size,
                          cfg.zipf_a)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    if cfg.prefix_embed:
        out["prefix_embeds"] = rng.standard_normal(
            (local, cfg.prefix_embed, cfg.d_model)).astype(np.float32) * 0.02
    return out


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1


class Prefetcher:
    """One-batch-ahead background prefetch (host-side)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(cfg, start_step), daemon=True)
        self._thread.start()

    def _run(self, cfg, start_step):
        for batch in iterate(cfg, start_step):
            if self._stop.is_set():
                return
            self._q.put(batch)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
