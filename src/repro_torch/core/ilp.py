"""Eq. (6) — per-layer algorithm selection as an ILP (a copy of
``repro.core.ilp``; the planner's branch-and-bound search runs on it).

    min  sum_k sum_l x_{k,l} * T_{k,l}
    s.t. sum_k sum_l x_{k,l} * M_{k,l} <= M_bound,   sum_l x_{k,l} = 1 (all k)

This is a multiple-choice knapsack. The paper points at GLPK; offline we
solve exactly with (a) Lagrangian-free branch-and-bound over layers with
a greedy lower bound, exact for the layer counts here (<= 128 groups), and
(b) a dynamic program over discretized memory as a cross-check.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)


@dataclass(frozen=True)
class Choice:
    name: str
    time: float
    memory: float


@dataclass
class ILPSolution:
    choices: List[int]  # chosen l per layer k
    time: float
    memory: float
    feasible: bool


def solve_ilp(layers: Sequence[Sequence[Choice]], m_bound: float) -> ILPSolution:
    """Exact branch-and-bound. ``layers[k][l]`` = Choice."""
    n = len(layers)
    # per-layer minima for bounds
    min_time_suffix = [0.0] * (n + 1)
    min_mem_suffix = [0.0] * (n + 1)
    for k in range(n - 1, -1, -1):
        min_time_suffix[k] = min_time_suffix[k + 1] + min(c.time for c in layers[k])
        min_mem_suffix[k] = min_mem_suffix[k + 1] + min(c.memory for c in layers[k])

    if min_mem_suffix[0] > m_bound:
        # infeasible even with the most memory-frugal choice everywhere
        picks = [min(range(len(ch)), key=lambda l: ch[l].memory) for ch in layers]
        t = sum(layers[k][picks[k]].time for k in range(n))
        m = sum(layers[k][picks[k]].memory for k in range(n))
        return ILPSolution(picks, t, m, feasible=False)

    best_time = float("inf")
    best_picks: Optional[List[int]] = None
    # DFS with (time_so_far + optimistic suffix) pruning; layers sorted by
    # "regret" (time spread) so impactful decisions come first.
    order = sorted(range(n),
                   key=lambda k: -(max(c.time for c in layers[k])
                                   - min(c.time for c in layers[k])))

    def dfs(idx: int, t_acc: float, m_acc: float, picks: List[int]):
        nonlocal best_time, best_picks
        if idx == n:
            if t_acc < best_time and m_acc <= m_bound:
                best_time, best_picks = t_acc, picks.copy()
            return
        k = order[idx]
        # optimistic bounds over the *remaining* (by order) layers
        rem = order[idx:]
        t_lb = t_acc + sum(min(c.time for c in layers[j]) for j in rem)
        m_lb = m_acc + sum(min(c.memory for c in layers[j]) for j in rem)
        if t_lb >= best_time or m_lb > m_bound:
            return
        for l in sorted(range(len(layers[k])), key=lambda l: layers[k][l].time):
            c = layers[k][l]
            picks.append(l)
            dfs(idx + 1, t_acc + c.time, m_acc + c.memory, picks)
            picks.pop()

    dfs(0, 0.0, 0.0, [])
    assert best_picks is not None
    # unpermute
    final = [0] * n
    for pos, k in enumerate(order):
        final[k] = best_picks[pos]
    t = sum(layers[k][final[k]].time for k in range(n))
    m = sum(layers[k][final[k]].memory for k in range(n))
    return ILPSolution(final, t, m, feasible=True)


def solve_ilp_dp(layers: Sequence[Sequence[Choice]], m_bound: float,
                 buckets: int = 4096) -> ILPSolution:
    """Memory-discretized DP cross-check (pseudo-polynomial)."""
    n = len(layers)
    max_mem = max(m_bound, 1.0)
    unit = max_mem / buckets

    def q(m: float) -> int:  # conservative rounding UP keeps feasibility
        return min(buckets, int(-(-m / unit)))

    INF = float("inf")
    dp = [INF] * (buckets + 1)
    back: List[List[Tuple[int, int]]] = []
    dp[0] = 0.0
    for k in range(n):
        ndp = [INF] * (buckets + 1)
        nback = [(-1, -1)] * (buckets + 1)
        for m_idx in range(buckets + 1):
            if dp[m_idx] == INF:
                continue
            for l, c in enumerate(layers[k]):
                nm = m_idx + q(c.memory)
                if nm > buckets:
                    continue
                nt = dp[m_idx] + c.time
                if nt < ndp[nm]:
                    ndp[nm] = nt
                    nback[nm] = (m_idx, l)
        dp = ndp
        back.append(nback)
    best_idx = min(range(buckets + 1), key=lambda i: dp[i])
    if dp[best_idx] == INF:
        picks = [min(range(len(ch)), key=lambda l: ch[l].memory) for ch in layers]
        t = sum(layers[k][picks[k]].time for k in range(n))
        m = sum(layers[k][picks[k]].memory for k in range(n))
        return ILPSolution(picks, t, m, feasible=False)
    picks = [0] * n
    idx = best_idx
    for k in range(n - 1, -1, -1):
        prev, l = back[k][idx]
        picks[k] = l
        idx = prev
    t = sum(layers[k][picks[k]].time for k in range(n))
    m = sum(layers[k][picks[k]].memory for k in range(n))
    return ILPSolution(picks, t, m, feasible=True)


# ---------------------------------------------------------------------------
# Generic branch-and-bound over configuration dimensions (the unified
# auto-parallel search: Eq. 6 generalized from per-layer algorithms to the
# planner's whole (pipe, microbatch, attention, remat, ...) grid)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Dim:
    """One search dimension: a name and its candidate values, in the order
    they should be tried (ties in predicted time resolve to the earliest
    enumerated config, exactly like exhaustive enumeration with strict <)."""

    name: str
    values: Tuple[Any, ...]

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"dim {self.name!r} has no candidate values")


@dataclass
class SearchResult:
    """Outcome of :func:`search_bnb`.  When no config is feasible,
    ``feasible`` is False and ``config`` is the memory-frugal pick (the
    same contract as :func:`solve_ilp`'s infeasible path)."""

    config: Dict[str, Any]
    time: float
    memory: float
    feasible: bool
    n_evaluated: int = 0
    n_pruned: int = 0
    notes: List[str] = field(default_factory=list)


def search_bnb(dims: Sequence[Dim],
               evaluate: Callable[[Dict[str, Any]], Tuple[float, float, bool]],
               *,
               lower_bound: Optional[Callable[[Dict[str, Any]], float]] = None
               ) -> SearchResult:
    """Branch-and-bound over the cross product of ``dims``.

    ``evaluate(config)`` prices a complete assignment and returns
    ``(time, memory, feasible)``.  ``lower_bound(partial)``, if given, must
    be *admissible*: a value <= the time of every completion of the partial
    assignment — only then is the search exact (equal to exhaustive
    enumeration, which the property tests assert).  Subtrees are pruned
    when the bound cannot beat the incumbent.

    If nothing is feasible, no incumbent ever forms, so no subtree is
    pruned — the full grid is priced and the minimum-memory config is
    returned with ``feasible=False`` (memory-frugal, like
    :func:`solve_ilp`)."""
    n = len(dims)
    best_time = float("inf")
    best_cfg: Optional[Dict[str, Any]] = None
    best_mem = 0.0
    frugal_mem = float("inf")
    frugal_cfg: Optional[Dict[str, Any]] = None
    frugal_time = 0.0
    stats = {"evaluated": 0, "pruned": 0}

    def dfs(idx: int, partial: Dict[str, Any]):
        nonlocal best_time, best_cfg, best_mem
        nonlocal frugal_mem, frugal_cfg, frugal_time
        if idx == n:
            stats["evaluated"] += 1
            t, mem, ok = evaluate(dict(partial))
            if ok and t < best_time:
                best_time, best_cfg, best_mem = t, dict(partial), mem
            if mem < frugal_mem:
                frugal_mem, frugal_cfg, frugal_time = mem, dict(partial), t
            return
        if lower_bound is not None and best_time < float("inf"):
            if lower_bound(dict(partial)) >= best_time:
                stats["pruned"] += 1
                return
        for v in dims[idx].values:
            partial[dims[idx].name] = v
            dfs(idx + 1, partial)
            del partial[dims[idx].name]

    dfs(0, {})
    if best_cfg is not None:
        return SearchResult(best_cfg, best_time, best_mem, feasible=True,
                            n_evaluated=stats["evaluated"],
                            n_pruned=stats["pruned"])
    assert frugal_cfg is not None
    return SearchResult(frugal_cfg, frugal_time, frugal_mem, feasible=False,
                        n_evaluated=stats["evaluated"],
                        n_pruned=stats["pruned"])


def search_exhaustive(dims: Sequence[Dim],
                      evaluate: Callable[[Dict[str, Any]],
                                         Tuple[float, float, bool]]
                      ) -> SearchResult:
    """Reference enumeration with the same tie-break (strict <, dim-order
    traversal) — the oracle the optimality property tests compare
    :func:`search_bnb` against."""
    return search_bnb(dims, evaluate, lower_bound=None)
