"""Collective-traffic accounting for the roofline: the twin of
``repro.launch.hlo``.

JAX parses the compiled SPMD HLO text, whose shapes are per partition.
The port's rank program issues its collectives itself, so in place of HLO
text this module reads the records its groups log
(``distributed/collectives.py::Group.log``; the dry run's
``RecordingGroup`` logs the same records on ``meta`` tensors): the op in
XLA's spelling, the operand and result bytes on this rank, and the group
size.  The wire model is ``hlo.py``'s, per chip:

  all-gather        : result x (n-1)/n      (receive everyone else's shard)
  all-reduce        : 2 x operand x (n-1)/n (ring reduce-scatter + all-gather)
  reduce-scatter    : operand x (n-1)/n
  all-to-all        : operand x (n-1)/n
  collective-permute: operand              (one send + one receive)
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Mapping

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def wire_bytes(op: str, operand_bytes: float, result_bytes: float,
               n: int) -> float:
    """Per-chip bytes on the wire of one collective over ``n`` ranks."""
    frac = (n - 1) / n if n > 1 else 0.0
    if op == "all-gather":
        return result_bytes * frac
    if op == "all-reduce":
        return 2 * operand_bytes * frac
    if op in ("reduce-scatter", "all-to-all"):
        return operand_bytes * frac
    if op == "collective-permute":
        return operand_bytes
    raise ValueError(f"unknown collective {op!r}; known: {COLLECTIVES}")


def collective_bytes(records: Iterable[Mapping]) -> Dict[str, Dict[str, float]]:
    """Per-collective-type {count, result_bytes, operand_bytes,
    wire_bytes} over one rank's records, ``hlo.collective_bytes``'s
    stats."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "result_bytes": 0.0, "operand_bytes": 0.0,
                 "wire_bytes": 0.0})
    for r in records:
        s = stats[r["op"]]
        s["count"] += 1
        s["result_bytes"] += r["result_bytes"]
        s["operand_bytes"] += r["operand_bytes"]
        s["wire_bytes"] += wire_bytes(r["op"], r["operand_bytes"],
                                      r["result_bytes"], r["group"])
    return dict(stats)


def total_wire_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return sum(s["wire_bytes"] for s in stats.values())
