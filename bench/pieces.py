"""Device time of the program's pieces inside a layer (``attn/core``,
``moe/route`` and the other ``moe/*`` spans, ``models/spans.py::layer``)
from the traced run's reduction (``bench/progtrace.py``'s ``by_span``):
the device ms a step under each named span in every phase (``@fwd``,
``@recompute``, ``@bwd``; the phases never overlap), summed over the
names, on several cards the largest rank's; and the program's counters
a profiled step (``moe.kept``).  A run whose program opens none of the
spans or counts nothing (an older program) reads nothing.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from bench import progtrace

PHASES = ("fwd", "recompute", "bwd")


def span_ms(rec: Dict, names: Iterable[str]) -> Optional[float]:
    names = tuple(names)
    vals = []
    for red in progtrace.readings(rec):
        by_span = red.get("by_span", {})
        hit = [f"{n}@{p}" for n in names for p in PHASES
               if f"{n}@{p}" in by_span]
        if hit:
            vals.append(sum(by_span[h]["device_ms"] for h in hit))
    return max(vals) if vals else None


def share(rec: Dict, names: Iterable[str], flops_a_step: Optional[float]
          ) -> Optional[float]:
    """``flops_a_step`` (per card) over the spans' device time a step and
    the card's peak in the configuration's compute dtype, in %."""
    from bench import flops

    ms = span_ms(rec, names)
    pk = flops.flops_peak(rec.get("device_kind", ""), rec["config"])
    if not ms or not pk or flops_a_step is None:
        return None
    return 100.0 * flops_a_step / (ms / 1e3 * pk)


def counter_a_step(rec: Dict, name: str) -> Optional[float]:
    """The program's counter ``name`` a profiled step, or None where the
    program counts no such thing (an older program, or no profile)."""
    c = rec.get("counters", {}).get(name)
    if not c or not c.get("count"):
        return None
    return c["sum"] / c["count"]
