"""Deterministic, seeded fault injection (port of
``repro/runtime/faults.py``; pure Python).

The reliability claims of the checkpoint path and of the serving engine
hold only if their failures can be caused on demand.  This module injects
the failure classes they are built to survive:

  read      ``open``/``read`` of a matching path raises ``InjectedFault``
            (an ``OSError``, so the retry policy treats it like a real
            filesystem error); ``times`` bounds how often it fires, which
            is how a transient fail-twice-then-succeed fault differs from
            a permanent one (``times=-1``)
  write     the same, for the checkpoint writer's pack writes
  corrupt   bytes returned by a matching read are bit-flipped or truncated
            (the frame CRC then rejects the record downstream: corruption
            is detected by the real validation path, never simulated)
  decode    the checkpoint loader's decode dispatch fails for a matching
            record name (a kernel or runtime failure after the bytes
            arrived intact)
  step      a serving-engine step fails for a matching request key
            (``runtime/engine.py`` probes every active request before each
            prefill and decode step; the engine's RetryPolicy absorbs a
            transient step fault, and a permanent one evicts only the
            poisoned request while the rest of the batch continues)

Faults activate through a contextvar (the ``inject(...)`` context manager,
the in-process route) or through the ``ENEC_FAULTS`` environment variable
(a JSON spec list, the route for subprocesses).  Injection is
deterministic: specs match first-match in declaration order, firing
counters are exact, and any random choice (a ``corrupt`` spec without an
explicit offset) draws from a ``random.Random(seed)`` owned by the
injector.

The I/O helpers below cost nothing when no injector is active:
``read_range`` and ``read_file`` are then a plain seek and read.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import random
import time
from pathlib import Path
from typing import List, Optional, Union


class InjectedFault(OSError):
    """An injected I/O or decode fault.  Subclasses ``OSError`` so the
    retry policy (runtime/retry.py) handles injected and real filesystem
    failures identically."""


class FaultConfigError(ValueError):
    """The ``ENEC_FAULTS`` environment variable (or an explicit spec) is
    malformed.  Raised eagerly with a one-line message naming the env var
    so a typo'd CI fault schedule fails at the first injection point, not
    as a raw JSON/TypeError traceback deep inside a checkpoint read."""


FAULT_KINDS = ("read", "write", "corrupt", "decode", "step")
CORRUPT_MODES = ("flip", "truncate")


@dataclasses.dataclass
class FaultSpec:
    """One fault to inject.

    ``match`` is a substring test against the target (a file path for
    read/write/corrupt, a record name for decode); "" matches everything.
    ``times`` caps the number of firings (-1 = unlimited/permanent).
    ``offset`` picks the byte to corrupt within the read slice (``None``
    = seeded choice); for ``mode="truncate"`` it is the length to keep.
    ``delay_s`` sleeps before the fault takes effect (slow-I/O modelling).
    """
    kind: str
    match: str = ""
    times: int = -1
    offset: Optional[int] = None
    mode: str = "flip"
    xor: int = 0x08
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt mode {self.mode!r}; "
                             f"expected one of {CORRUPT_MODES}")


class FaultInjector:
    """Holds the active :class:`FaultSpec` list and the per-spec firing
    counters.  One injector == one deterministic fault schedule."""

    def __init__(self, specs, seed: int = 0):
        self.specs: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs]
        self.seed = seed
        self._rng = random.Random(seed)
        self.fired = [0] * len(self.specs)

    def stats(self) -> list:
        """Per-spec firing counters, in declaration order."""
        return [{"kind": s.kind, "match": s.match, "times": s.times,
                 "fired": n} for s, n in zip(self.specs, self.fired)]

    def _take(self, kind: str, target) -> Optional[FaultSpec]:
        """First live spec of ``kind`` matching ``target``; consumes one
        firing (and applies its delay) when found."""
        for i, s in enumerate(self.specs):
            if s.kind != kind or s.match not in str(target):
                continue
            if s.times >= 0 and self.fired[i] >= s.times:
                continue
            self.fired[i] += 1
            if s.delay_s:
                time.sleep(s.delay_s)
            return s
        return None

    def check_read(self, path) -> None:
        if self._take("read", path) is not None:
            raise InjectedFault(f"injected read fault: {path}")

    def check_write(self, path) -> None:
        if self._take("write", path) is not None:
            raise InjectedFault(f"injected write fault: {path}")

    def check_decode(self, name) -> None:
        if self._take("decode", name) is not None:
            raise InjectedFault(f"injected decode fault: {name}")

    def check_step(self, key) -> None:
        if self._take("step", key) is not None:
            raise InjectedFault(f"injected step fault: {key}")

    def corrupt(self, path, data: bytes) -> bytes:
        """Apply a matching ``corrupt`` spec to bytes just read from
        ``path`` — flip one byte or truncate, leaving detection to the
        real frame/CRC validation downstream."""
        s = self._take("corrupt", path)
        if s is None or not data:
            return data
        if s.mode == "truncate":
            keep = s.offset if s.offset is not None \
                else self._rng.randrange(len(data))
            return data[:max(0, min(keep, len(data) - 1))]
        buf = bytearray(data)
        idx = s.offset if s.offset is not None and 0 <= s.offset < len(buf) \
            else self._rng.randrange(len(buf))
        buf[idx] ^= (s.xor or 0x01) & 0xFF
        return bytes(buf)


# ---------------------------------------------------------------------------
# activation: contextmanager (in-process) or ENEC_FAULTS env (subprocess/CI)
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_fault_injector", default=None)
_ENV_CACHE: tuple = (None, None)   # (raw env string, parsed injector)


def _parse_env_schedule(raw: str) -> FaultInjector:
    """Parse ``ENEC_FAULTS`` into a :class:`FaultInjector`, converting every
    malformed-input failure (bad JSON, wrong container shape, unknown fault
    ``kind``/``mode``, bogus field types) into a one-line
    :class:`FaultConfigError` that names the env var."""
    try:
        data = json.loads(raw)
    except json.JSONDecodeError as e:
        raise FaultConfigError(
            f"ENEC_FAULTS is not valid JSON: {e}") from None
    if isinstance(data, list):
        data = {"specs": data}
    if not isinstance(data, dict):
        raise FaultConfigError(
            f"ENEC_FAULTS must be a JSON list of fault specs or an object "
            f"with a 'specs' key, got {type(data).__name__}")
    try:
        return FaultInjector(data.get("specs", []),
                             seed=int(data.get("seed", 0)))
    except (TypeError, ValueError) as e:
        raise FaultConfigError(f"ENEC_FAULTS has a bad fault spec: {e}") \
            from None


def active() -> Optional[FaultInjector]:
    """The injector in effect, if any: the ``inject()`` contextvar wins,
    else ``ENEC_FAULTS`` (JSON: a spec list, or ``{"seed": .., "specs":
    [..]}``), else None.  A malformed env schedule raises
    :class:`FaultConfigError` at the first injection point instead of a
    raw traceback from deep inside a checkpoint read."""
    inj = _ACTIVE.get()
    if inj is not None:
        return inj
    raw = os.environ.get("ENEC_FAULTS")
    if not raw:
        return None
    global _ENV_CACHE
    if _ENV_CACHE[0] != raw:
        _ENV_CACHE = (raw, _parse_env_schedule(raw))
    return _ENV_CACHE[1]


@contextlib.contextmanager
def inject(*specs: Union[FaultSpec, dict], seed: int = 0):
    """Activate a fault schedule for the enclosed block and yield the
    injector (its ``stats()``/``fired`` counters are assertable after)."""
    if len(specs) == 1 and isinstance(specs[0], FaultInjector):
        inj = specs[0]
    else:
        inj = FaultInjector(list(specs), seed=seed)
    token = _ACTIVE.set(inj)
    try:
        yield inj
    finally:
        _ACTIVE.reset(token)


# ---------------------------------------------------------------------------
# fault-aware I/O helpers (the checkpoint layer's single read/write funnel)
# ---------------------------------------------------------------------------

def read_range(path, offset: int, length: int) -> bytes:
    """seek+read ``length`` bytes at ``offset``, applying any active read
    and corrupt faults for ``path``."""
    inj = active()
    if inj is not None:
        inj.check_read(path)
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read(length)
    if inj is not None:
        data = inj.corrupt(path, data)
    return data


def read_file(path) -> bytes:
    """Whole-file read through the same fault funnel as :func:`read_range`."""
    inj = active()
    if inj is not None:
        inj.check_read(path)
    with open(path, "rb") as f:
        data = f.read()
    if inj is not None:
        data = inj.corrupt(path, data)
    return data


def check_write(path) -> None:
    """Raise the active write fault for ``path``, if any (called by the
    checkpoint writer pool before each pack write)."""
    inj = active()
    if inj is not None:
        inj.check_write(path)


def check_decode(name) -> None:
    """Raise the active decode fault for record ``name``, if any (called
    by the checkpoint loader before admitting a record to the batched
    decode plan)."""
    inj = active()
    if inj is not None:
        inj.check_decode(name)


def check_step(key) -> None:
    """Raise the active serving-step fault for request ``key``, if any
    (called by the engine's scheduler before each prefill/decode step for
    every active request, so a fault can poison one request without
    touching the rest of the batch)."""
    inj = active()
    if inj is not None:
        inj.check_step(key)


# ---------------------------------------------------------------------------
# on-disk corruption helper (tests / CI / bench: damage a committed record)
# ---------------------------------------------------------------------------

def flip_pack_byte(ckpt_root, name: str = "", *, step: Optional[int] = None,
                   byte: int = 0, xor: int = 0x08) -> tuple:
    """Permanently flip one byte inside a committed pack record's payload
    (the frame CRC will reject it on the next read).  ``name`` selects the
    first manifest entry whose record name contains it (declaration order);
    ``byte`` indexes into the record payload.  Returns ``(record_name,
    pack_path, absolute_offset)`` so the caller can assert the quarantine
    line points at exactly this damage."""
    from repro_torch.core import wire as enec_wire

    root = Path(ckpt_root)
    if step is None:
        dirs = sorted(p for p in root.glob("step_*") if p.is_dir())
        if not dirs:
            raise FileNotFoundError(f"no step directories under {root}")
        cdir = dirs[-1]
    else:
        cdir = root / f"step_{step:012d}"
    manifest = json.loads((cdir / "manifest.json").read_text())
    entry = next((e for e in manifest["leaves"]
                  if name in e["name"] and "pack" in e), None)
    if entry is None:
        raise ValueError(f"no pack record matching {name!r} in {cdir}")
    pack_path = cdir / manifest["packs"][entry["pack"]]
    pos = entry["offset"] + enec_wire.FRAME_HEADER_BYTES \
        + min(max(byte, 0), entry["bytes"] - 1)
    with open(pack_path, "r+b") as f:
        f.seek(pos)
        old = f.read(1)
        f.seek(pos)
        f.write(bytes([old[0] ^ xor]))
    return entry["name"], str(pack_path), pos
