"""Admission control for the continuous-batching serving engine (port of
``repro/runtime/admission.py``; pure Python).

Three pieces, free of torch so they are testable with a fake clock:

:class:`Request`
    One generation request and its whole observable lifecycle: prompt,
    token budget, priority, absolute deadlines (TTFT and total), state
    machine, timestamps, and the emitted tokens and logits.

:class:`AdmissionQueue`
    A bounded FIFO with explicit backpressure.  ``offer()`` accepts or
    rejects with a reason (``queue_full`` / ``overloaded`` /
    ``draining``): the queue never grows past its depth, so overload shows
    as counted rejections at the front door instead of unbounded latency
    inside.  Requests whose TTFT deadline expires while queued are shed
    before they cost a prefill, and the overload governor may shed the
    lowest-priority queued work when a step misbehaves.

:class:`OverloadGovernor`
    The step watchdog and overload state machine.  It learns a baseline
    step time during warm-up, flags steps that are stuck (over the
    absolute watchdog) or slow (over ``overload_factor`` x baseline), and
    while violations persist holds the engine ``overloaded``: admission
    degrades (new low-priority work is rejected) so the latency of
    admitted requests is kept.  ``recovery_steps`` healthy steps in a row
    return it to ``nominal``.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import deque
from typing import List, Optional, Tuple

# offer() rejection reasons (Request.detail of a "rejected" request)
REJECT_QUEUE_FULL = "queue_full"
REJECT_OVERLOADED = "overloaded"
REJECT_DRAINING = "draining"

# terminal request states and what they mean:
#   done       all requested tokens emitted within deadline
#   timed_out  all tokens emitted, but the last one landed past the total
#              deadline (the eviction check runs at step granularity, so a
#              deadline expiring mid-step can complete late — accounted
#              honestly, never reported as "done")
#   rejected   refused at the front door (detail = reason above)
#   shed       dropped from the queue before any prefill ran
#              (detail = "deadline" | "overload" | "drain")
#   evicted    removed mid-flight, KV slot reclaimed
#              (detail = "deadline" | "fault" | "abort")
TERMINAL_STATES = ("done", "timed_out", "rejected", "shed", "evicted")

_rid_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request moving through the engine."""
    prompt: object                      # 1-D int32 array of prompt tokens
    max_new_tokens: int
    priority: int = 0                   # higher = more important
    ttft_deadline_s: Optional[float] = None   # absolute clock() time
    deadline_s: Optional[float] = None        # absolute clock() time
    name: str = ""
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    # lifecycle (engine-owned)
    state: str = "new"
    detail: str = ""
    submit_s: Optional[float] = None
    admit_s: Optional[float] = None     # prefill started
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    logits: list = dataclasses.field(default_factory=list)
    retries: int = 0                    # step-fault retries absorbed

    def __post_init__(self):
        if not self.name:
            self.name = f"req-{self.rid}"

    @property
    def key(self) -> str:
        """The fault-injection match target (FaultSpec kind="step")."""
        return self.name

    @property
    def finished(self) -> bool:
        return self.state in TERMINAL_STATES

    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None or self.submit_s is None:
            return None
        return self.first_token_s - self.submit_s

    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first (None for <2 tokens)."""
        if (self.finish_s is None or self.first_token_s is None
                or len(self.tokens) < 2):
            return None
        return (self.finish_s - self.first_token_s) / (len(self.tokens) - 1)


class AdmissionQueue:
    """Bounded FIFO admission queue with reject-with-reason backpressure.

    Thread-safe: ``offer()`` may be called from any thread while the
    engine loop drains the queue.  All mutation happens under one lock;
    the counters are exact.
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._closed = False
        self.counters = {"offered": 0, "accepted": 0,
                         "rejected_queue_full": 0, "rejected_overloaded": 0,
                         "rejected_draining": 0, "shed_deadline": 0,
                         "shed_overload": 0, "shed_drain": 0}
        self.max_depth_seen = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop accepting new work (graceful drain): every later ``offer``
        is rejected with ``draining``."""
        with self._lock:
            self._closed = True

    def offer(self, req: Request, *,
              overloaded: bool = False) -> Tuple[bool, str]:
        """Try to enqueue.  Returns ``(accepted, reason)`` where ``reason``
        is "" on success.  Rejections are explicit and counted — the queue
        NEVER grows past ``depth``.  Under overload only priority > 0
        requests are admitted (admission degrades, admitted-request
        latency does not)."""
        with self._lock:
            self.counters["offered"] += 1
            if self._closed:
                reason = REJECT_DRAINING
            elif overloaded and req.priority <= 0:
                reason = REJECT_OVERLOADED
            elif len(self._q) >= self.depth:
                reason = REJECT_QUEUE_FULL
            else:
                self._q.append(req)
                self.counters["accepted"] += 1
                self.max_depth_seen = max(self.max_depth_seen, len(self._q))
                req.state = "queued"
                return True, ""
            self.counters[f"rejected_{reason}"] += 1
            req.state, req.detail = "rejected", reason
            return False, reason

    def shed_expired(self, now: float) -> List[Request]:
        """Remove queued requests whose TTFT deadline has already passed —
        they are shed BEFORE consuming a prefill.  Returns the shed
        requests (already marked)."""
        shed = []
        with self._lock:
            keep = deque()
            for req in self._q:
                if req.ttft_deadline_s is not None \
                        and now > req.ttft_deadline_s:
                    req.state, req.detail = "shed", "deadline"
                    self.counters["shed_deadline"] += 1
                    shed.append(req)
                else:
                    keep.append(req)
            self._q = keep
        return shed

    def shed_lowest_priority(self, n: int = 1,
                             reason: str = "overload") -> List[Request]:
        """Drop up to ``n`` queued requests, lowest priority first (ties:
        newest arrival first, so the oldest viable work keeps its place).
        Called by the engine when the governor trips."""
        shed = []
        with self._lock:
            for _ in range(n):
                if not self._q:
                    break
                victim = min(enumerate(self._q),
                             key=lambda iv: (iv[1].priority, -iv[0]))[0]
                req = self._q[victim]
                del self._q[victim]
                req.state, req.detail = "shed", reason
                self.counters[f"shed_{reason}"] += 1
                shed.append(req)
        return shed

    def drain_all(self, reason: str = "drain") -> List[Request]:
        """Empty the queue (shutdown: queued-but-never-admitted work is
        shed, in-flight work finishes)."""
        with self._lock:
            shed = list(self._q)
            self._q.clear()
        for req in shed:
            req.state, req.detail = "shed", reason
            with self._lock:
                self.counters[f"shed_{reason}"] += 1
        return shed

    def take(self) -> Optional[Request]:
        """Pop the oldest queued request (FIFO), or None."""
        with self._lock:
            return self._q.popleft() if self._q else None

    def peek_viable(self) -> bool:
        with self._lock:
            return bool(self._q)


class OverloadGovernor:
    """Step watchdog + overload state machine.

    States: ``warmup`` (learning the baseline) -> ``nominal`` <->
    ``overloaded``.  A step is a *violation* when it exceeds the absolute
    ``watchdog_s`` (stuck) or ``overload_factor`` x the learned baseline
    (slow).  Every violation trips (returns True from ``observe_step``) so
    the engine sheds lowest-priority queued work immediately; the state
    stays ``overloaded`` — degrading admission — until ``recovery_steps``
    consecutive healthy steps pass.  The baseline EMA only updates on
    healthy steps, so a long overload episode cannot drag the baseline up
    and mask itself.
    """

    def __init__(self, *, watchdog_s: float = 5.0,
                 overload_factor: float = 4.0, warmup_steps: int = 3,
                 recovery_steps: int = 8):
        self.watchdog_s = watchdog_s
        self.overload_factor = overload_factor
        self.warmup_steps = max(1, warmup_steps)
        self.recovery_steps = max(1, recovery_steps)
        self.baseline_s: Optional[float] = None
        self._warm: List[float] = []
        self._healthy = 0
        self.state = "warmup"
        self.counters = {"steps": 0, "stuck_steps": 0, "slow_steps": 0,
                         "trips": 0, "recoveries": 0}

    @property
    def overloaded(self) -> bool:
        return self.state == "overloaded"

    def observe_step(self, dt_s: float) -> bool:
        """Record one step's wall time.  Returns True when the step is a
        violation (the engine should shed queued low-priority work)."""
        self.counters["steps"] += 1
        stuck = dt_s > self.watchdog_s
        if self.baseline_s is None:
            # warmup: even before a baseline exists, the absolute watchdog
            # still catches a stuck step
            if stuck:
                self.counters["stuck_steps"] += 1
                self.counters["trips"] += 1
                self.state = "overloaded"
                self._healthy = 0
                return True
            self._warm.append(dt_s)
            if len(self._warm) >= self.warmup_steps:
                self.baseline_s = sorted(self._warm)[len(self._warm) // 2]
                if self.state == "warmup":
                    self.state = "nominal"
            return False
        slow = dt_s > self.overload_factor * self.baseline_s
        if stuck or slow:
            self.counters["stuck_steps" if stuck else "slow_steps"] += 1
            self.counters["trips"] += 1
            self.state = "overloaded"
            self._healthy = 0
            return True
        self.baseline_s = 0.9 * self.baseline_s + 0.1 * dt_s
        self._healthy += 1
        if self.state == "overloaded" and self._healthy >= self.recovery_steps:
            self.state = "nominal"
            self.counters["recoveries"] += 1
        return False

    def stats(self) -> dict:
        return dict(self.counters, state=self.state,
                    baseline_s=self.baseline_s)
