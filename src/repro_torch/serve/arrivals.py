"""Seeded arrival-trace generators for the serving scheduler.

A trace is a list of non-negative integer arrival times on the scheduler's
*virtual step clock* (one tick per engine decode step), so replayed load is
bit-for-bit deterministic in CI regardless of wall-clock jitter — the first
step toward the ROADMAP trace-driven-campaigns item.

Trace specs (the ``JobSpec.arrival`` / ``--arrival-trace`` mini-language):

* ``""``               — all requests queued at step 0 (the static case)
* ``"poisson:<rate>"`` — Poisson process with ``rate`` arrivals per step
* ``"burst:<n>x<gap>"``— bursts of ``n`` back-to-back, ``gap`` steps apart
"""
from __future__ import annotations

from typing import List

import numpy as np


def poisson_trace(n: int, rate: float, *, seed: int = 0) -> List[int]:
    """Arrival steps of a Poisson process with ``rate`` arrivals/step."""
    if rate <= 0:
        raise ValueError(f"poisson rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(int).tolist()


def burst_trace(n: int, burst: int, gap: int, *, seed: int = 0) -> List[int]:
    """``burst`` simultaneous arrivals every ``gap`` steps."""
    del seed  # deterministic by construction; kept for interface symmetry
    if burst <= 0 or gap < 0:
        raise ValueError(f"burst size must be > 0 and gap >= 0, "
                         f"got {burst}x{gap}")
    return [(i // burst) * gap for i in range(n)]


def parse_trace(spec: str):
    """Validate a trace spec; returns (kind, params). Raises ValueError."""
    if not spec:
        return ("static", ())
    kind, _, rest = spec.partition(":")
    try:
        if kind == "poisson":
            rate = float(rest)
            if rate <= 0:
                raise ValueError
            return ("poisson", (rate,))
        if kind == "burst":
            burst, _, gap = rest.partition("x")
            b, g = int(burst), int(gap)
            if b <= 0 or g < 0:
                raise ValueError
            return ("burst", (b, g))
    except ValueError:
        pass
    raise ValueError(
        f"bad arrival trace spec {spec!r}; expected '', 'poisson:<rate>' "
        f"or 'burst:<n>x<gap>'")


def make_trace(spec: str, n: int, *, seed: int = 0) -> List[int]:
    """Arrival steps for ``n`` requests per the trace spec mini-language."""
    kind, params = parse_trace(spec)
    if kind == "static":
        return [0] * n
    if kind == "poisson":
        return poisson_trace(n, params[0], seed=seed)
    return burst_trace(n, params[0], params[1], seed=seed)
