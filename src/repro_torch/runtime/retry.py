"""Retry with exponential backoff and jitter for checkpoint I/O (the
attempt-bounded core of ``repro/runtime/retry.py``; pure Python).

One :class:`RetryPolicy` rides on each ``CheckpointManager``: every pack
write and every pack or manifest read goes through :meth:`call`, so a
transient filesystem error (an ``OSError``) is absorbed by backoff instead
of failing the save or restore.  Validation failures (a frame's CRC, a
``WireError``) are not retried: re-reading the same corrupt bytes cannot
heal them, so they reach the caller at once.  The jitter draws from a
``random.Random(seed)`` owned by the instance, so a schedule repeats.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Tuple, Type


@dataclasses.dataclass
class RetryPolicy:
    """``max_attempts`` counts the first try: the default absorbs up to
    three consecutive transient failures.  ``base_delay_s`` doubles per
    retry up to ``max_delay_s``; each sleep is scaled by
    ``1 + jitter * U[0, 1)``."""
    max_attempts: int = 4
    base_delay_s: float = 0.002
    max_delay_s: float = 0.25
    jitter: float = 0.5
    seed: int = 0
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        self._rng = random.Random(self.seed)

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retrying after failed attempt ``attempt``
        (1-based): exponential in the attempt number, capped, jittered."""
        base = min(self.base_delay_s * (2 ** (attempt - 1)),
                   self.max_delay_s)
        return base * (1.0 + self.jitter * self._rng.random())

    def call(self, fn: Callable):
        """Run ``fn()``; exceptions in ``retry_on`` retry up to
        ``max_attempts`` tries in all, and the last failure, like any
        other exception, propagates."""
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except self.retry_on:
                if attempt == self.max_attempts:
                    raise
                time.sleep(self.backoff_s(attempt))
