"""Continuous-batching serving engine (port of ``repro/runtime/engine.py``).

Requests enter a bounded :class:`~repro_torch.runtime.admission.
AdmissionQueue`, join a fixed ring of KV slots at token granularity,
decode together as one batched step, and leave one by one: completion,
deadline eviction and fault eviction all happen per request while the rest
of the batch goes on.

* **Slot ring, not per-request caches.**  One cache of ``max_slots``
  slots (the KV ring and, for the recurrent families, each block's state)
  and the step's token, length and logits buffers are allocated once
  (``model.init_step_state``).  A request joins by prefilling alone (batch
  1, eagerly) and copying its whole cache into its slot, and leaves by
  having the slot marked free, its length reset to 0.  A row's bits do
  not depend on the rows beside it, so engine logits are bitwise equal to
  the one-shot path (tests/test_torch_engine.py in all three weight
  modes, tests/test_torch_families.py for the recurrent families).
* **Batch buckets bound the graphs.**  The decode step runs on the slot
  prefix ``[0, bucket)``, ``bucket`` the smallest power of two covering
  the highest occupied slot (capped at ``max_slots``).  On the card each
  bucket's step is one CUDA graph (``runtime/captured.py``), so at most
  ``ceil(log2(max_slots)) + 1`` are captured; free rows inside a bucket
  decode at length 0 and are ignored.  With an MoE expert store
  (``expert_store``) the step brings each layer's routed expert ids to
  the host to fetch those experts, so it cannot be a graph: it runs
  eagerly on the card (``CapturedStep(eager=True)``), every step, and
  ``stats()["experts"]`` carries the store's counters.  So does a step
  under a serving mesh (``extra_context`` installing
  ``runtime.collectives.use_serving_mesh``): its shard gathers are
  collectives between processes, which a CUDA graph cannot hold.
* **The ring on a serving mesh.**  Under a serving mesh every rank keeps
  every request (on every ``"data"`` coordinate) and its share of the
  ring's sequence where ``runtime/sharding.py:kv_layout`` allows it
  (``model.init_step_state(mesh=)``): a prefill keeps the rank's
  positions (``model.prefill_fn(mesh=)``) and is copied into the slot as
  it is; a step's decode attention gathers over the sequence axes
  (``models/layers.py:rank_decode_attention``), its logits one device's
  bits.  A Mamba state holds the rank's blocks of ``h``'s d_state and
  ``conv``'s channels, an sLSTM state its block of ``h``'s D
  (``runtime/sharding.py:state_layout``), copied into the slot as the
  prefill kept them.  Its MoE blocks compute only
  the rank's own experts and exchange their activations
  (``models/moe.py``; ``step_ep_bytes``).
* **Deadlines at every stage.**  Requests whose TTFT deadline passes in the
  queue are shed before a prefill; in-flight requests past their total
  deadline are evicted at step granularity and their slot reclaimed; a
  request completing past its deadline is counted ``timed_out``, never
  ``done``.
* **Step watchdog and overload governor.**  Each step's time on the host
  clock, taken after its tokens reach the host, feeds the
  :class:`~repro_torch.runtime.admission.OverloadGovernor`: a stuck or slow
  step sheds the lowest-priority queued work, and sustained overload
  degrades admission rather than the latency of admitted requests.
* **Step faults.**  Before each prefill and decode step the engine probes
  ``runtime.faults.check_step(request.key)`` for each active request under
  its :class:`~repro_torch.runtime.retry.RetryPolicy`, budgeted by the
  request's remaining deadline: transient faults are absorbed, a permanent
  one evicts only its request, and health goes ``degraded``, not
  ``failed``.
* **Graceful drain.**  ``shutdown(deadline_s)`` refuses new work, sheds the
  queue, finishes in-flight requests until the deadline and evicts the
  rest as ``abort``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import build
from repro_torch.runtime import faults as rt_faults
from repro_torch.runtime.admission import (AdmissionQueue, OverloadGovernor,
                                           Request)
from repro_torch.runtime.captured import CapturedStep
from repro_torch.runtime.collectives import (expert_exchange_bytes,
                                             serving_mesh)
from repro_torch.runtime.retry import RetryPolicy


class EngineError(RuntimeError):
    """Unrecoverable engine failure (invalid request, failed state)."""


class ServerHealth:
    """Readiness state of a serving process, the answer to a load
    balancer's probe.

    States: ``initializing`` -> ``restoring`` -> ``ready`` | ``degraded``
    (serving after a fault eviction) | ``draining`` (shutdown in progress:
    in-flight work finishes, new work is refused) -> ``stopped`` |
    ``failed``.  Thread-safe: every change goes through
    :meth:`transition` under a lock.
    """

    STATES = ("initializing", "restoring", "ready", "degraded", "draining",
              "stopped", "failed")

    def __init__(self, state: str = "initializing", detail: str = ""):
        self._lock = threading.Lock()
        self.state = state
        self.detail = detail

    def transition(self, state: str, detail: str = "") -> None:
        if state not in self.STATES:
            raise ValueError(f"unknown health state {state!r}; "
                             f"expected one of {self.STATES}")
        with self._lock:
            self.state, self.detail = state, detail

    def reset(self) -> None:
        self.transition("initializing", "")

    def ready(self) -> bool:
        """Should a load balancer route traffic here?  Degraded serving is
        still correct serving: yes.  Draining, stopped, failed: no."""
        return self.state in ("ready", "degraded")


@dataclasses.dataclass
class EngineConfig:
    """Static policy of one :class:`Engine`."""
    max_slots: int = 4            # concurrency: slots of the KV ring
    queue_depth: int = 16         # bounded admission queue depth
    max_prompt_len: int = 32
    max_new_tokens: int = 8       # per-request cap (requests may ask less)
    default_ttft_deadline_s: Optional[float] = None
    default_deadline_s: Optional[float] = None
    watchdog_s: float = 5.0       # absolute stuck-step threshold
    overload_factor: float = 4.0  # slow-step threshold (x baseline)
    warmup_steps: int = 3
    recovery_steps: int = 8
    shed_per_trip: int = 1        # queued requests shed per governor trip
    collect_logits: bool = False  # keep per-token logits on each request

    @property
    def max_len(self) -> int:
        return self.max_prompt_len + self.max_new_tokens


def _next_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at ``cap`` (the final bucket)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


class Engine:
    """Continuous-batching scheduler over the weight handles of
    ``runtime/weights.py``.

    Single-driver: one thread calls :meth:`step` / :meth:`run_until_idle`
    / :meth:`shutdown`; :meth:`submit` is thread-safe.  Prefill and step
    run under ``codec`` (``use_codec``) when one is given.  The model runs
    on ``device`` (default ``cuda``; the step is captured there).
    """

    def __init__(self, model, params, config: EngineConfig, *,
                 codec=None, retry: Optional[RetryPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 health: Optional[ServerHealth] = None, device="cuda",
                 expert_store=None,
                 extra_context: Optional[Callable] = None):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.config = config
        self.codec = codec
        # more ambient context for prefill and step (the launcher's serving
        # mesh: ``runtime.collectives.use_serving_mesh``)
        self.extra_context = extra_context
        # the MoE expert store behind any ExpertRef handles in ``params``
        # (runtime/experts.py): observed for its counters and each step's
        # miss-decode seconds; its fetches happen inside moe_block
        self.expert_store = expert_store
        self.device = resolve_device(device)
        self.clock = clock
        self.sleep = sleep
        self.retry = retry if retry is not None \
            else RetryPolicy(sleep=sleep, clock=clock)
        self.health = health if health is not None else ServerHealth()

        self.queue = AdmissionQueue(config.queue_depth)
        self.governor = OverloadGovernor(
            watchdog_s=config.watchdog_s,
            overload_factor=config.overload_factor,
            warmup_steps=config.warmup_steps,
            recovery_steps=config.recovery_steps)

        s = config.max_slots
        if s < 1:
            raise ValueError(f"max_slots must be >= 1, got {s}")
        self._slots: List[Optional[Request]] = [None] * s
        self._lengths = np.zeros((s,), np.int32)   # host-authoritative
        self._tokens = np.zeros((s,), np.int64)
        self._state = None                         # step buffers (lazy)
        # the captured step holds the engine weakly: a bound method would
        # make a cycle, and a dropped engine would keep its tree and graph
        # pool on the card until the cycle collector ran
        engine = weakref.ref(self)
        with self._ctx():
            ambient = serving_mesh()
        # the serving mesh the slot ring's sequence is shared over (or
        # None); a step under it gathers shards through collectives, which
        # a CUDA graph cannot hold
        self._mesh = None if ambient is None else ambient[0]
        self.captured = CapturedStep(
            lambda bucket: engine()._step_body(bucket), self.device, s,
            eager=expert_store is not None or self._mesh is not None,
            carried=lambda: engine()._carried())

        self.counters = {"submitted": 0, "admitted": 0, "done": 0,
                         "timed_out": 0, "rejected": 0, "shed": 0,
                         "evicted_deadline": 0, "evicted_fault": 0,
                         "evicted_abort": 0, "steps": 0, "prefills": 0,
                         "fault_retries": 0}
        self.step_times_s: List[float] = []
        # per decode step: its bucket, whether it captured a graph, its
        # kernel launches (a replay's, the warm-up's taken out) and its
        # device ms (CUDA events around the replay; None on the CPU)
        self.step_buckets: List[int] = []
        self.step_captured: List[bool] = []
        self.step_launches: List[dict] = []
        self.step_device_ms: List[Optional[float]] = []
        # per decode step: the expert store's miss-decode seconds (0.0 on
        # a step that hit every expert, and without a store) and the bytes
        # the run's codec moved host to device, and the compressed bytes it
        # gathered between the ranks of a serving mesh (d2d_allgather), and
        # the dense bytes its decode attention gathered over the sequence
        # axes of a sharded ring (d2d_allgather's dense bytes), and the
        # activation bytes its MoE blocks' expert-parallel exchanges
        # received (``collectives.expert_exchange_bytes``)
        self.step_decode_s: List[float] = []
        self.step_h2d_bytes: List[int] = []
        self.step_gather_bytes: List[int] = []
        self.step_kv_bytes: List[int] = []
        self.step_ep_bytes: List[int] = []
        self.prefill_launches = dict.fromkeys(build.counts(), 0)
        self._draining = False
        if not self.health.ready():
            self.health.transition("ready")

    # -- context, buffers, the step -----------------------------------------

    def _ctx(self):
        stack = contextlib.ExitStack()
        if self.codec is not None:
            from repro_torch.core.codec_api import use_codec
            stack.enter_context(use_codec(self.codec))
        if self.extra_context is not None:
            stack.enter_context(self.extra_context())
        return stack

    def _ensure_state(self):
        if self._state is None:
            self._state = self.model.init_step_state(
                self.config.max_slots, self.config.max_len,
                device=self.device, mesh=self._mesh)

    def ring_bytes(self) -> int:
        """Bytes of this rank's K/V rings (0 before the first request)."""
        if self._state is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for e in self._state["entries"] for k, t in e.items()
                   if k in ("k", "v"))

    def state_bytes(self) -> int:
        """Bytes of this rank's recurrent states (0 before the first
        request; its blocks of them on a serving mesh)."""
        return sum(self.state_leaf_bytes().values())

    def state_leaf_bytes(self) -> dict:
        """:meth:`state_bytes` by leaf name (``h``, ``c``, ...), summed
        over every layer."""
        out: dict = {}
        for e in self._state["entries"] if self._state is not None else ():
            for k, t in e.items():
                if k not in ("k", "v"):
                    out[k] = out.get(k, 0) + t.numel() * t.element_size()
        return out

    def _step_body(self, bucket: int) -> None:
        self.model.decode_step(self.params, self._state, bucket)

    def _carried(self) -> list:
        """The state a step advances in place and ``_load`` does not
        renew: every recurrent state tensor of the slot cache (a step
        rewrites the K/V rings at the same positions, so they need
        nothing)."""
        return [t for e in self._state["entries"] for k, t in e.items()
                if k not in ("k", "v")]

    def _h2d_bytes(self) -> int:
        return (self.codec.transfer_stats()["h2d_bytes"]
                if self.codec is not None else 0)

    def _gather_bytes(self, kind: str = "compressed_bytes") -> int:
        return (self.codec.link_stats()["d2d_allgather"][kind]
                if self.codec is not None else 0)

    def _load(self) -> None:
        """The host's tokens and lengths into the step's buffers (freed
        slots at length 0)."""
        self._state["tokens"].copy_(torch.from_numpy(self._tokens))
        self._state["lengths"].copy_(torch.from_numpy(self._lengths))

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               priority: int = 0, ttft_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               name: str = "") -> Request:
        """Offer one request.  Deadlines are relative seconds from now
        (None falls back to the config's defaults).  Returns the Request:
        ``.state`` is "queued" on admission, "rejected" with ``.detail``
        naming the reason on backpressure.  Invalid shapes (a prompt too
        long for the ring) raise :class:`EngineError`: a caller's bug, not
        load."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n_new = self.config.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        if not 1 <= n_new <= self.config.max_new_tokens:
            raise EngineError(f"max_new_tokens {n_new} outside [1, "
                              f"{self.config.max_new_tokens}]")
        if not 1 <= prompt.size <= self.config.max_prompt_len:
            raise EngineError(f"prompt length {prompt.size} outside [1, "
                              f"{self.config.max_prompt_len}]")
        now = self.clock()
        if ttft_deadline_s is None:
            ttft_deadline_s = self.config.default_ttft_deadline_s
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        req = Request(
            prompt=prompt, max_new_tokens=n_new, priority=priority,
            ttft_deadline_s=None if ttft_deadline_s is None
            else now + ttft_deadline_s,
            deadline_s=None if deadline_s is None else now + deadline_s,
            name=name)
        req.submit_s = now
        self.counters["submitted"] += 1
        ok, _ = self.queue.offer(req, overloaded=self.governor.overloaded)
        if not ok:
            self.counters["rejected"] += 1
        return req

    # -- lifecycle helpers --------------------------------------------------

    def _active(self) -> List[Request]:
        return [r for r in self._slots if r is not None]

    def _free_slot(self, req: Request) -> None:
        slot = req.slot
        if slot is not None and self._slots[slot] is req:
            self._slots[slot] = None
            self._lengths[slot] = 0   # slot reclaimed; its row decodes at 0
            self._tokens[slot] = 0
        req.slot = None

    def _finish(self, req: Request, state: str, detail: str = "") -> None:
        req.state, req.detail = state, detail
        req.finish_s = self.clock()
        self._free_slot(req)
        if state == "evicted":
            self.counters[f"evicted_{detail}"] += 1
        elif state in self.counters:
            self.counters[state] += 1

    def _complete(self, req: Request) -> None:
        """All tokens emitted: a finish past the total deadline is
        ``timed_out``, not ``done``."""
        now = self.clock()
        late = req.deadline_s is not None and now > req.deadline_s
        self._finish(req, "timed_out" if late else "done")

    def _probe(self, req: Request, now: float) -> Optional[Exception]:
        """One request's step-fault probe under the retry policy, budgeted
        by its remaining deadline; returns the fault that outlived the
        retries, if any."""
        budget = None if req.deadline_s is None \
            else max(0.0, req.deadline_s - now)
        before = self.retry.stats()["retries"]
        try:
            self.retry.call(lambda: rt_faults.check_step(req.key),
                            describe=f"step:{req.key}", max_elapsed_s=budget)
            return None
        except rt_faults.InjectedFault as e:
            return e
        finally:
            absorbed = self.retry.stats()["retries"] - before
            req.retries += absorbed
            self.counters["fault_retries"] += absorbed

    def _probe_step_faults(self, now: float) -> None:
        """Per active request: a permanent fault evicts only its request
        and degrades health; the others keep decoding."""
        if rt_faults.active() is None:
            return
        for req in self._active():
            err = self._probe(req, now)
            if err is not None:
                self._finish(req, "evicted", "fault")
                self.health.transition(
                    "degraded", f"step fault evicted {req.name}: {err}")

    def _shed_and_evict(self, now: float) -> None:
        for req in self.queue.shed_expired(now):
            self.counters["shed"] += 1
            req.finish_s = now
        for req in self._active():
            if req.deadline_s is not None and now > req.deadline_s:
                self._finish(req, "evicted", "deadline")

    def _admit(self) -> int:
        """Fill free slots from the queue (lowest slot first, FIFO); each
        admission is one batch-1 prefill copied into the ring."""
        admitted = 0
        while not self._draining and self.queue.peek_viable():
            try:
                slot = self._slots.index(None)
            except ValueError:
                break
            req = self.queue.take()
            if req is None:
                break
            now = self.clock()
            if req.deadline_s is not None and now > req.deadline_s:
                req.state, req.detail = "shed", "deadline"
                req.finish_s = now
                self.queue.counters["shed_deadline"] += 1
                self.counters["shed"] += 1
                continue
            # the step-fault probe runs before the prefill costs anything
            if rt_faults.active() is not None:
                err = self._probe(req, now)
                if err is not None:
                    req.finish_s = self.clock()
                    req.state, req.detail = "evicted", "fault"
                    self.counters["evicted_fault"] += 1
                    self.health.transition(
                        "degraded",
                        f"step fault evicted {req.name} at admission: {err}")
                    continue
            req.admit_s = self.clock()
            req.slot = slot
            self._slots[slot] = req
            req.state = "running"
            self.counters["admitted"] += 1
            self._run_prefill(req, slot)
            admitted += 1
            if req.finished:
                continue
            if len(req.tokens) >= req.max_new_tokens:
                self._complete(req)
        return admitted

    def _run_prefill(self, req: Request, slot: int) -> None:
        self._ensure_state()
        self.counters["prefills"] += 1
        before = build.counts()
        prompt = torch.from_numpy(req.prompt).to(self.device,
                                                 torch.int64)[None, :]
        with self._ctx():
            logits, cache = self.model.prefill_fn(
                self.params, {"tokens": prompt}, self.config.max_len,
                mesh=self._mesh)
            # every tensor of every entry, the K/V ring's whole row (the
            # rank's positions of it on a serving mesh) and each recurrent
            # state: a reused slot keeps nothing of its last request
            for ring, part in zip(self._state["entries"], cache["entries"]):
                for k, t in part.items():
                    ring[k][:, slot].copy_(t[:, 0])
            t = int(torch.argmax(logits[0], dim=-1))
        for k, n in _delta(build.counts(), before).items():
            self.prefill_launches[k] += n
        req.first_token_s = self.clock()
        req.tokens.append(t)
        self._tokens[slot] = t
        self._lengths[slot] = req.prompt.size
        if self.config.collect_logits:
            req.logits.append(logits[0])

    def _decode_step(self) -> None:
        active = self._active()
        bucket = _next_bucket(max(r.slot for r in active) + 1,
                              self.config.max_slots)
        captured = (bucket not in self.captured.graphs
                    and not self.captured.eager)
        before = build.counts()
        dec0 = (self.expert_store.decode_seconds()
                if self.expert_store is not None else 0.0)
        h2d0, gather0 = self._h2d_bytes(), self._gather_bytes()
        kv0 = self._gather_bytes("dense_bytes")
        ep0 = expert_exchange_bytes()
        t0 = self.clock()
        with self._ctx():
            # a transient runtime error rides the same retry policy as
            # checkpoint I/O (the step reloads its inputs, so a retry
            # repeats it exactly); a lasting one evicts the batch and
            # degrades health instead of failing the server
            try:
                events = self.retry.call(
                    lambda: self.captured.run(bucket, self._load),
                    describe=f"decode_step:b{bucket}")
                toks = self._state["tokens"][:bucket].tolist()
            except OSError as e:
                for req in active:
                    self._finish(req, "evicted", "fault")
                self.health.transition(
                    "degraded", f"decode step failed, batch evicted: {e}")
                return
        dt = self.clock() - t0
        launches = _delta(build.counts(), before)
        if captured:
            for k, n in self.captured.warmup_launches.get(bucket, {}).items():
                launches[k] -= n
        self.counters["steps"] += 1
        self.step_times_s.append(dt)
        self.step_buckets.append(bucket)
        self.step_captured.append(captured)
        self.step_launches.append(launches)
        self.step_device_ms.append(
            None if events is None else events[0].elapsed_time(events[1]))
        self.step_decode_s.append(
            (self.expert_store.decode_seconds() - dec0)
            if self.expert_store is not None else 0.0)
        self.step_h2d_bytes.append(self._h2d_bytes() - h2d0)
        self.step_gather_bytes.append(self._gather_bytes() - gather0)
        self.step_kv_bytes.append(self._gather_bytes("dense_bytes") - kv0)
        self.step_ep_bytes.append(expert_exchange_bytes() - ep0)
        if self.governor.observe_step(dt):
            for req in self.queue.shed_lowest_priority(
                    self.config.shed_per_trip, reason="overload"):
                self.counters["shed"] += 1
                req.finish_s = self.clock()
        for req in active:
            slot = req.slot
            t = toks[slot]
            req.tokens.append(t)
            self._tokens[slot] = t
            self._lengths[slot] += 1
            if self.config.collect_logits:
                req.logits.append(self._state["logits"][slot].clone())
            if len(req.tokens) >= req.max_new_tokens:
                self._complete(req)

    # -- driver -------------------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: shed and evict by deadline, admit from
        the queue, probe step faults, run one batched decode step.
        Returns True if any work happened (admission or decode)."""
        if self.health.state == "failed":
            raise EngineError(f"engine failed: {self.health.detail}")
        now = self.clock()
        self._shed_and_evict(now)
        admitted = self._admit()
        self._probe_step_faults(self.clock())
        if not self._active():
            return admitted > 0
        self._decode_step()
        return True

    def has_work(self) -> bool:
        return bool(self._active()) or self.queue.peek_viable()

    def run_until_idle(self, max_steps: Optional[int] = None) -> None:
        """Drive steps until the queue and the slots are empty."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return

    def shutdown(self, deadline_s: Optional[float] = None) -> None:
        """Graceful drain: refuse new work, shed the queue, finish
        in-flight requests; past ``deadline_s`` (relative seconds) the
        stragglers are evicted as ``abort``.  Health: ``draining`` ->
        ``stopped``."""
        self._draining = True
        self.queue.close()
        self.health.transition("draining",
                               f"{len(self._active())} in flight")
        for req in self.queue.drain_all("drain"):
            self.counters["shed"] += 1
            req.finish_s = self.clock()
        abs_deadline = None if deadline_s is None \
            else self.clock() + deadline_s
        while self._active():
            if abs_deadline is not None and self.clock() > abs_deadline:
                for req in self._active():
                    self._finish(req, "evicted", "abort")
                break
            self.step()
        self.health.transition("stopped", "drained")

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        """Every counter a probe, script or test needs.
        ``compiled_buckets`` lists the buckets whose step was captured (on
        the CPU, or with an expert store: the buckets whose step ran);
        ``experts`` (with an expert store) carries the store's hit / miss
        / eviction / resident-byte counters."""
        out = {
            "engine": dict(self.counters,
                           compiled_buckets=self.captured.buckets,
                           active=len(self._active()),
                           queued=len(self.queue)),
            "queue": dict(self.queue.counters,
                          depth=len(self.queue),
                          max_depth_seen=self.queue.max_depth_seen,
                          cap=self.queue.depth),
            "governor": self.governor.stats(),
            "retry": self.retry.stats(),
            "health": {"state": self.health.state,
                       "detail": self.health.detail},
        }
        if self.expert_store is not None:
            out["experts"] = self.expert_store.stats()
        return out
