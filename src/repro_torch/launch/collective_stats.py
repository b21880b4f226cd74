"""Collective traffic of a rank's program, from records of the collectives
it started: the port's counterpart of ``repro/launch/hlo_stats.py``.

The reference parses the compiled HLO's collective instructions; the port
has no HLO, so the dry-run's abstract mesh (``launch/dryrun.py``) records
each collective the rank would start as ``(kind, result_bytes,
group_size)`` instead, and this module turns the records into per-device
bytes on the wire with the reference's ring formulas, plus the
``broadcast`` that the port's gloo stream gather and its dense gathers
(``launch/mesh.py:gather_whole``) start, one an owner:

  all-reduce          2 * (n-1)/n * bytes
  all-gather              (n-1)/n * bytes          (result bytes)
  reduce-scatter          (n-1)   * bytes          (result bytes; operand = n*result)
  all-to-all              (n-1)/n * bytes
  broadcast               (n-1)/n * bytes          (the bytes broadcast)
  collective-permute               bytes

A broadcast delivers its bytes to the n - 1 ranks other than its owner;
averaged over the n ranks of the group that is (n-1)/n of the bytes a
device, so the n broadcasts of a gather (one an owner, each of one shard)
cost what one all-gather of the whole costs.
"""
from __future__ import annotations

from collections import defaultdict

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "broadcast", "collective-permute")


def wire_bytes(kind: str, result_bytes: int, n: int) -> float:
    """Per-device bytes on the wire of one collective over ``n`` ranks."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind in ("all-gather", "all-to-all", "broadcast"):
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return float(n - 1) * result_bytes
    return float(result_bytes)  # collective-permute


def collective_stats(records) -> dict:
    """``records``: ``(kind, result_bytes, group_size)`` of each collective
    -> ``{kind: {count, result_bytes, wire_bytes}}`` plus
    ``total_wire_bytes`` and ``total_count`` (the reference's schema)."""
    stats = defaultdict(lambda: {"count": 0, "result_bytes": 0,
                                 "wire_bytes": 0.0})
    for kind, rb, n in records:
        if kind not in KINDS:
            raise ValueError(f"unknown collective {kind!r}; expected one of "
                             f"{KINDS}")
        stats[kind]["count"] += 1
        stats[kind]["result_bytes"] += int(rb)
        stats[kind]["wire_bytes"] += wire_bytes(kind, int(rb), int(n))
    out = {k: dict(v) for k, v in stats.items()}
    out["total_wire_bytes"] = sum(v["wire_bytes"] for v in stats.values())
    out["total_count"] = sum(v["count"] for v in stats.values())
    return out
