"""The engine's decode step, one CUDA graph per batch bucket (the port's
counterpart of the ``jax.jit`` step of ``repro/runtime/engine.py``, whose
cache is donated).

The eager step costs the host ≈ 2000 kernel launches; a graph replays them
in one.  :class:`CapturedStep` captures the step for a bucket on its first
use and replays it from then on:

* It warms up first: the step runs once, eagerly, on the capture stream,
  so the kernels are built, their attributes set and each kernel's
  per-stream arrival counters made before the capture (the wrappers
  refuse to make those inside one).  The warm-up writes the same K/V at
  the same positions as the replay that follows, from the same inputs;
  the state a step carries over in place and ``load`` does not renew
  (the recurrent families' states, ``carried``) is saved before the
  warm-up and put back after it, so the first replay starts from the
  state the warm-up found.
* Every bucket's graph draws on one memory pool
  (``torch.cuda.graph_pool_handle``): a stream-mode step decodes a
  layer's weights inside the step, and minitron_4b a 1.57 GB embed, so
  the buckets must not each keep a pool.  Replays run one at a time on
  one stream, and nothing a step allocates outlives it.
* At most ``ceil(log2(max_slots)) + 1`` graphs exist (one per bucket).
* Whatever the step reads from the host is read once, at capture: weight
  handles resolve then, and the codec's decode counters count then.
  Tokens, lengths and the slot ring live at fixed addresses and are
  loaded with ``copy_`` before each run.
* The launch counters (``kernels/build.py``) count in Python, so they
  count at capture and not at replay: :func:`record` takes their delta
  over a capture back out and each :meth:`Replay.replay` adds it.  That
  holds for the launches of both streams below.
* A stream-mode step prefetches each layer's weights on a side stream
  (``runtime/overlap.py``).  Each step owns one (:attr:`side`), made
  ambient around the warm-up, the capture and every eager run
  (``overlap.use_side_stream``): the warm-up runs the decode on it before
  the capture, and inside the capture the pipeline forks it from the
  capture stream and joins it back through events, so the graph holds the
  launches of both streams.  Allocations of either stream during the
  capture come from the one pool.

On the CPU the same step runs eagerly: that follows the device, it is not
a fallback.  A capture that fails raises; nothing runs the eager step on
the card in its place.  A step that must bring data to the host in its
middle (an MoE step fetching routed experts from an expert store,
``runtime/experts.py``) cannot be one graph; ``CapturedStep(eager=True)``
runs it eagerly on the card, every time, and says so (:attr:`eager`).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.kernels import build
from repro_torch.runtime.overlap import use_side_stream


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


class Replay:
    """A captured graph and the kernel launches its capture counted."""

    def __init__(self, graph, launches: dict):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        build.add(self.launches)


def record(graph, capture, fn: Callable[[], None]) -> Replay:
    """Run ``fn`` inside ``capture``, the context that captures it into
    ``graph``: the launch counters count what ``fn`` enqueues, are set
    back (a capture launches nothing), and the returned :class:`Replay`
    adds that count on every replay.  A failed capture raises, with the
    counters set back."""
    before = build.counts()
    try:
        with capture:
            fn()
        launches = _delta(build.counts(), before)
    finally:
        build.restore(before)
    return Replay(graph, launches)


class CapturedStep:
    """``step(bucket)`` (e.g. ``lm.decode_step`` on fixed buffers) run
    through one CUDA graph per bucket on ``device``, eagerly on the CPU."""

    def __init__(self, step: Callable[[int], None], device,
                 max_slots: int, eager: bool = False,
                 carried: Optional[Callable[[], list]] = None):
        self.step = step
        # the tensors the step advances in place that ``load`` does not
        # renew; a warm-up must leave them as it found them
        self.carried = carried
        self.device = torch.device(device)
        self.eager = eager               # run every step eagerly
        self.max_graphs = (max_slots - 1).bit_length() + 1
        self.graphs: dict = {}           # bucket -> Replay (None on CPU)
        self.warmup_launches: dict = {}  # bucket -> launches of its warm-up
        self.capture_s: dict = {}        # bucket -> warm-up + capture s
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            self.side = torch.cuda.Stream(self.device)

    def _run_step(self, bucket: int) -> None:
        """The step on the card, with this step's side stream ambient."""
        with use_side_stream(self.side):
            self.step(bucket)

    @property
    def buckets(self) -> list:
        """The buckets captured (on the CPU or eager: the buckets run)."""
        return sorted(self.graphs)

    def _capture(self, bucket: int) -> Replay:
        if len(self.graphs) >= self.max_graphs:
            raise RuntimeError(f"bucket {bucket}: already {self.max_graphs} "
                               f"graphs ({self.buckets})")
        t0 = time.perf_counter()
        before = build.counts()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            carried = self.carried() if self.carried is not None else []
            saved = [t.clone() for t in carried]
            self._run_step(bucket)                   # the warm-up
            for t, old in zip(carried, saved):
                t.copy_(old)
            del carried, saved
        current.wait_stream(self.stream)
        self.warmup_launches[bucket] = _delta(build.counts(), before)
        graph = torch.cuda.CUDAGraph()
        replay = record(graph, torch.cuda.graph(graph, pool=self.pool,
                                                stream=self.stream),
                        lambda: self._run_step(bucket))
        self.capture_s[bucket] = time.perf_counter() - t0
        return replay

    def run(self, bucket: int, load: Callable[[], None]) -> Optional[tuple]:
        """One step over ``bucket`` rows; ``load()`` copies the step's
        inputs into its buffers (again after a warm-up, which advanced
        them).  On the card returns the CUDA events recorded around the
        replay, or around the eager step (their ``elapsed_time`` is the
        step's device time once it has finished); on the CPU None."""
        load()
        if self.device.type != "cuda":
            self.step(bucket)
            self.graphs.setdefault(bucket, None)
            return None
        if self.eager:
            self.graphs.setdefault(bucket, None)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self._run_step(bucket)
            end.record()
            return start, end
        if bucket not in self.graphs:
            self.graphs[bucket] = self._capture(bucket)
            load()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graphs[bucket].replay()
        end.record()
        return start, end
