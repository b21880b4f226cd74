"""Retry with exponential backoff and jitter (port of
``repro/runtime/retry.py``; pure Python).

One :class:`RetryPolicy` rides on each ``CheckpointManager`` and on each
serving :class:`~repro_torch.runtime.engine.Engine`: every pack write, every
pack or manifest read and every engine step-fault probe goes through
:meth:`RetryPolicy.call`, so a transient failure (an ``OSError``; the
injected faults of ``runtime/faults.py`` subclass it on purpose) is absorbed
by backoff instead of failing the save, the restore or the request.
Validation failures (a frame's CRC, a ``WireError``) are not retried:
re-reading the same corrupt bytes cannot heal them, so they reach the caller
at once.  The jitter draws from a ``random.Random(seed)`` owned by the
instance, so a schedule repeats, and the attempt counters (:meth:`stats`)
are exact.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Tuple, Type


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    ``max_attempts`` counts the first try: the default absorbs up to three
    consecutive transient failures.  ``base_delay_s`` doubles per retry up
    to ``max_delay_s``; each sleep is scaled by ``1 + jitter * U[0, 1)``.

    ``max_elapsed_s`` bounds the total time a call may spend inside
    :meth:`call` (tries and backoff sleeps): once the next backoff would
    pass it, the call gives up at once and re-raises.  The serving engine
    passes each request's remaining deadline this way.  ``sleep`` and
    ``clock`` are injectable, so tests never sleep through a schedule and
    can drive the budget from a fake clock.
    """
    max_attempts: int = 4
    base_delay_s: float = 0.002
    max_delay_s: float = 0.25
    jitter: float = 0.5
    seed: int = 0
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    max_elapsed_s: float = None   # None: bounded by attempts only
    sleep: Callable = time.sleep
    clock: Callable = time.monotonic

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        self._rng = random.Random(self.seed)
        self._stats = {"calls": 0, "attempts": 0, "retries": 0,
                       "gave_up": 0}

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retrying after failed attempt ``attempt``
        (1-based): exponential in the attempt number, capped, jittered."""
        base = min(self.base_delay_s * (2 ** (attempt - 1)),
                   self.max_delay_s)
        return base * (1.0 + self.jitter * self._rng.random())

    def call(self, fn: Callable, *, describe: str = "io",
             max_elapsed_s: float = None):
        """Run ``fn()``; exceptions in ``retry_on`` retry up to
        ``max_attempts`` tries in all, and the last failure, like any other
        exception, propagates.  ``describe`` names the call for the reader
        of a traceback.  ``max_elapsed_s`` tightens the instance's budget
        for this call: when the time spent plus the next backoff would
        exceed it, the call gives up now rather than sleep through a
        deadline the caller has already missed."""
        self._stats["calls"] += 1
        budgets = [b for b in (self.max_elapsed_s, max_elapsed_s)
                   if b is not None]
        budget = min(budgets) if budgets else None
        t0 = self.clock() if budget is not None else None
        attempt = 0
        while True:
            attempt += 1
            self._stats["attempts"] += 1
            try:
                return fn()
            except self.retry_on:
                if attempt >= self.max_attempts:
                    self._stats["gave_up"] += 1
                    raise
                delay = self.backoff_s(attempt)
                if budget is not None and \
                        (self.clock() - t0) + delay > budget:
                    self._stats["gave_up"] += 1
                    raise
                self._stats["retries"] += 1
                self.sleep(delay)

    def stats(self) -> dict:
        """Exact counters: calls entered, attempts made, retries slept
        through, and calls that exhausted every attempt or their budget."""
        return dict(self._stats)

    def reset_stats(self) -> None:
        for k in self._stats:
            self._stats[k] = 0
