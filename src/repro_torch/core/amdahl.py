"""Lemma 3.1 — multi-accelerator efficiency under Amdahl's law (a copy of
``repro.core.amdahl``).

    alpha(G, R_O) = (1 + R_O) / (1 + G * R_O)

where R_O = T_O / T_C is the ratio of non-hidden overhead to computation.
Also the inverse forms the paper uses operationally: the G needed for a
target speedup, and the R_O budget admissible for a target efficiency.
"""
from __future__ import annotations

import math


def efficiency(g: int, r_o: float) -> float:
    """Lemma 3.1: efficiency alpha given G accelerators and overhead ratio."""
    if g < 1:
        raise ValueError("G >= 1")
    return (1.0 + r_o) / (1.0 + g * r_o)


def speedup(g: int, r_o: float) -> float:
    """alpha * G — the actual speedup factor (Fig. 4's estimated curve)."""
    return g * efficiency(g, r_o)


def max_overhead_for(g: int, alpha: float) -> float:
    """Eq. (12): R_O admissible for target efficiency alpha with G devices."""
    if not (0 < alpha <= 1):
        raise ValueError("alpha in (0, 1]")
    if g * alpha <= 1:
        return math.inf
    return (1.0 - alpha) / (alpha * g - 1.0)


def devices_for_speedup(target: float, r_o: float, g_max: int = 4096) -> int:
    """Smallest G achieving ``target``x speedup; paper's example: R_O=10%,
    3x target -> G=4. Returns g_max if saturation caps below target."""
    for g in range(1, g_max + 1):
        if speedup(g, r_o) >= target:
            return g
    return g_max


def speedup_saturation(r_o: float) -> float:
    """lim_{G->inf} speedup = (1 + R_O)/R_O — the Amdahl ceiling."""
    return math.inf if r_o == 0 else (1.0 + r_o) / r_o
