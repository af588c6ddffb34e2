"""Gradient-sync strategies over the data-parallel ranks (the port of
``repro.distributed.collectives``; Lemma 3.2, executable).

A strategy is one rank's view, as the JAX function is one device's view
inside ``shard_map``: it takes this rank's gradient tree and a
:class:`Group` (or, for the hierarchical strategy, an ``(outer, inner)``
pair of groups) and returns the data-axis **mean**, the same on every rank.
The members differ only in which collectives move the bytes:

- ``all_reduce``      — one all-reduce per leaf; wire 2*S_p*(dp-1)/dp.
- ``reduce_scatter_all_gather`` — reduce-scatter of the flat, padded
  gradient, a local 1/dp, an all-gather (ZeRO's "N_ps = dp" mapping).
- ``parameter_server`` — the flat gradient split into ``n_servers``
  buckets (``np.array_split`` sizes), one collective per bucket, each
  emulating one server's push + reduce + pull round.
- ``hier_all_reduce`` — reduce-scatter inside each node, all-reduce of the
  surviving 1/node shard across nodes, all-gather back in-node, over two
  sub-groups.

A :class:`Group` wraps any ``torch.distributed`` process group (gloo or
NCCL), so the strategies run the same under one thread per rank (the
trainer) or one process per card (``torchrun`` and ``dist.new_group``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import ps as ps_lib
from repro_torch.core.hardware import Tier
from repro_torch.models.common import tree_items, tree_unflatten


class Group:
    """This rank's handle on one process group: sum-collectives that block
    the host until the backend has taken the work (NCCL then orders the
    caller's stream after it).

    ``log`` (optional): a list each call appends one record to, ``{"op"``
    (XLA's spelling), ``"operand_bytes"``, ``"result_bytes"``, ``"group"``
    (the group's size)``}`` — what ``repro_torch.launch.wire`` prices, so
    a real run's collectives can be held to a dry run's."""

    def __init__(self, pg, log: Optional[list] = None):
        self.pg = pg
        self.size = pg.size()
        self.rank = pg.rank()
        self.log = log

    def _record(self, op: str, operand: torch.Tensor,
                result: torch.Tensor) -> None:
        if self.log is not None:
            self.log.append({
                "op": op, "dtype": str(operand.dtype).replace("torch.", ""),
                "operand_bytes": operand.numel() * operand.element_size(),
                "result_bytes": result.numel() * result.element_size(),
                "group": self.size})

    @staticmethod
    def _opts(opts_cls, op: str = "sum"):
        opts = opts_cls()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM,
                         "max": dist.ReduceOp.MAX}[op]
        return opts

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or ``op="max"``) over the group, in place."""
        self.pg.allreduce([t], self._opts(dist.AllreduceOptions, op)).wait()
        self._record("all-reduce", t, t)
        return t

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's 1/size slice of the sum of every rank's ``flat``."""
        out = flat.new_empty(flat.numel() // self.size)
        self.pg._reduce_scatter_base(
            out, flat, self._opts(dist.ReduceScatterOptions)).wait()
        self._record("reduce-scatter", flat, out)
        return out

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's ``shard``, concatenated in rank order."""
        out = shard.new_empty(shard.numel() * self.size)
        self.pg._allgather_base(out, shard).wait()
        self._record("all-gather", shard, out)
        return out

    def all_to_all(self, flat: torch.Tensor, send: Sequence[int],
                   recv: Sequence[int]) -> torch.Tensor:
        """``flat``'s consecutive pieces of ``send[j]`` elements to rank
        j; returns the pieces of ``recv[j]`` elements from rank j,
        concatenated in rank order."""
        out = flat.new_empty(sum(recv))
        self.pg.alltoall_base(out, flat, list(recv), list(send),
                              dist.AllToAllOptions()).wait()
        self._record("all-to-all", flat, out)
        return out


class RecordingGroup(Group):
    """A :class:`Group` that moves no byte: on ``meta`` tensors each call
    returns an output of the right shape and logs the record a real group
    would (the dry run's stand-in for JAX's placeholder devices)."""

    def __init__(self, size: int, rank: int, log: Optional[list] = None):
        self.pg = None
        self.size = int(size)
        self.rank = int(rank)
        self.log = [] if log is None else log

    @staticmethod
    def _check(t: torch.Tensor) -> None:
        if t.device.type != "meta":
            raise ValueError("a RecordingGroup takes meta tensors only (it "
                             f"moves no data), got one on {t.device}")

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        self._check(t)
        self._record("all-reduce", t, t)
        return t

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        self._check(flat)
        out = flat.new_empty(flat.numel() // self.size)
        self._record("reduce-scatter", flat, out)
        return out

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        self._check(shard)
        out = shard.new_empty(shard.numel() * self.size)
        self._record("all-gather", shard, out)
        return out

    def all_to_all(self, flat: torch.Tensor, send: Sequence[int],
                   recv: Sequence[int]) -> torch.Tensor:
        self._check(flat)
        out = flat.new_empty(sum(recv))
        self._record("all-to-all", flat, out)
        return out


# a strategy's group argument: one group, or (outer, inner) for the tree
AxisArg = Union[Group, Tuple[Group, Group]]


# ---------------------------------------------------------------------------
# Flat-vector helpers (PS sharding and reduce-scatter need a 1-D view)
# ---------------------------------------------------------------------------


def flatten_tree(tree) -> Tuple[torch.Tensor, Any]:
    """Concatenate all leaves (as fp32) into one 1-D vector. Returns
    (vector, meta) for :func:`unflatten_tree`."""
    items = list(tree_items(tree))
    meta = [(path, g.shape, g.dtype) for path, g in items]
    flat = torch.cat([g.float().reshape(-1) for _, g in items])
    return flat, meta


def unflatten_tree(flat: torch.Tensor, meta) -> Any:
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in meta]
    parts = torch.split(flat, sizes)
    return tree_unflatten((path, part.reshape(shape).to(dtype))
                          for (path, shape, dtype), part in zip(meta, parts))


def _pad(flat: torch.Tensor, multiple: int):
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


# ---------------------------------------------------------------------------
# Strategy zoo
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SyncStrategy:
    """A named gradient-sync schedule: (local_grads, group(s), dp) -> mean."""

    name: str
    _sync: Callable[[Any, AxisArg, int], Any]
    n_servers: Optional[int] = None  # parameter_server only
    tiers: Optional[Tuple[int, ...]] = None  # hier only: sizes, innermost first

    @property
    def hierarchical(self) -> bool:
        return self.name == "hier_all_reduce"

    def sync(self, grads, axis: AxisArg, dp: int):
        return self._sync(grads, axis, dp)

    def _tier_sizes(self, dp: int) -> Tuple[int, ...]:
        return self.tiers if self.tiers else (dp,)

    def wire_bytes(self, s_p: float, dp: int) -> float:
        """Per-worker wire bytes for one sync of s_p gradient bytes."""
        if dp <= 1:
            return 0.0  # nothing crosses the wire without a second worker
        if self.name == "parameter_server":
            return 2.0 * s_p  # push everything out + pull everything back
        if self.hierarchical:
            return sum(ps_lib.hier_wire_bytes(s_p, self._tier_sizes(dp)))
        return ps_lib.flat_wire_bytes(s_p, dp)  # ring all-reduce == RS + AG

    def wire_bytes_by_tier(self, s_p: float, dp: int) -> Tuple[float, ...]:
        """Per-worker wire bytes attributed to each topology tier
        (innermost first): flat strategies push their full payload across
        every spanning tier; the tree only moves the surviving shard out."""
        if dp <= 1:
            return tuple(0.0 for _ in self._tier_sizes(dp))
        sizes = self._tier_sizes(dp)
        if self.hierarchical:
            return ps_lib.hier_wire_bytes(s_p, sizes)
        total = self.wire_bytes(s_p, dp)
        return tuple(total if d > 1 else 0.0 for d in sizes)

    def predicted_comm_time(self, s_p: float, dp: int, link_bw: float,
                            *, tier_bws: Optional[Sequence[float]] = None
                            ) -> float:
        """Lemma 3.2's comm-time prediction for this schedule; the
        hierarchical strategy prices each phase on ``tier_bws`` (aligned
        with ``tiers``), else on ``link_bw``."""
        if dp <= 1:
            return 0.0
        tiers = None
        if self.hierarchical:
            sizes = self._tier_sizes(dp)
            bws = tuple(tier_bws) if tier_bws else (link_bw,) * len(sizes)
            tiers = tuple(Tier(f"t{i}", d, bw)
                          for i, (d, bw) in enumerate(zip(sizes, bws)))
        return ps_lib.predicted_comm_time(self.name, s_p, dp, link_bw,
                                          n_ps=self.n_servers or 0,
                                          tiers=tiers)


def _all_reduce(grads, axis: AxisArg, dp: int):
    """Per-leaf mean; sums in place into fp32 leaves (the caller's, when
    they are fp32 already)."""
    return {k: _all_reduce(v, axis, dp) if isinstance(v, dict)
            else axis.all_reduce(v.float()) / dp for k, v in grads.items()}


def _reduce_scatter_all_gather(grads, axis: AxisArg, dp: int):
    """ZeRO mapping: RS the flat gradient (each rank owns 1/dp of the sum),
    scale locally, AG the shards back."""
    flat, meta = flatten_tree(grads)
    flat, pad = _pad(flat, dp)
    shard = axis.reduce_scatter(flat) / dp
    full = axis.all_gather(shard)
    return unflatten_tree(full[:full.numel() - pad], meta)


def _hier_all_reduce(grads, axis: AxisArg, dp: int):
    """Reduction tree over ``(outer, inner)`` groups: reduce-scatter
    in-node, all-reduce the 1/d_inner shard across nodes, all-gather back
    in-node.  On one group it is RS+AG."""
    if isinstance(axis, Group):
        return _reduce_scatter_all_gather(grads, axis, dp)
    outer, inner = axis
    flat, meta = flatten_tree(grads)
    flat, pad = _pad(flat, inner.size)
    shard = inner.reduce_scatter(flat)          # fast tier
    shard = outer.all_reduce(shard) / dp        # slow tier: the shard only
    full = inner.all_gather(shard)              # fast tier
    return unflatten_tree(full[:full.numel() - pad], meta)


def _parameter_server(n_servers: int):
    def sync(grads, axis: AxisArg, dp: int):
        flat, meta = flatten_tree(grads)
        n = max(min(n_servers, flat.numel()), 1)
        # near-equal bucket sizes, np.array_split semantics
        base, rem = divmod(flat.numel(), n)
        sizes = [base + 1] * rem + [base] * (n - rem)
        out: List[torch.Tensor] = []
        for bucket in torch.split(flat, [s for s in sizes if s]):
            # one collective per server: Eq. 7's push+reduce+pull round
            out.append(axis.all_reduce(bucket.clone()) / dp)
        return unflatten_tree(torch.cat(out), meta)

    return sync


def _ps_dynamic(grads, axis: AxisArg, dp: int):
    # n_servers unspecified: default to dp (ZeRO's N_ps = dp choice)
    return _parameter_server(dp)(grads, axis, dp)


def get_strategy(name: str, *, n_servers: Optional[int] = None,
                 tiers: Optional[Sequence[int]] = None) -> SyncStrategy:
    """Resolve a schedule name to an executable strategy.  ``n_servers``
    (parameter_server): ``None`` defers to N_ps = dp at sync time; size it
    with Lemma 3.2 (``core.ps.n_parameter_servers``).  ``tiers``
    (hier_all_reduce): per-tier fan-out, innermost first, e.g. ``(4, 2)``
    for 2 nodes x 4 ranks."""
    if name == "all_reduce":
        return SyncStrategy("all_reduce", _all_reduce)
    if name == "reduce_scatter_all_gather":
        return SyncStrategy("reduce_scatter_all_gather",
                            _reduce_scatter_all_gather)
    if name == "hier_all_reduce":
        t = tuple(int(d) for d in tiers) if tiers else None
        if t and any(d < 1 for d in t):
            raise ValueError(f"hier_all_reduce tiers must be >= 1, got {t}")
        return SyncStrategy("hier_all_reduce", _hier_all_reduce, tiers=t)
    if name == "parameter_server":
        if n_servers is None:
            return SyncStrategy("parameter_server", _ps_dynamic)
        if n_servers < 1:
            raise ValueError(
                f"parameter_server needs n_servers >= 1, got {n_servers}; "
                "pass None to defer to the dynamic N_ps = dp default")
        return SyncStrategy("parameter_server", _parameter_server(n_servers),
                            n_servers=n_servers)
    raise KeyError(f"unknown sync strategy {name!r}; known: {STRATEGIES}")


STRATEGIES: Tuple[str, ...] = ps_lib.SCHEDULES
