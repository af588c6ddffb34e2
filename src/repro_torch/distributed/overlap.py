"""Bucketed comm/compute overlap — wait-free backpropagation for the zoo
(a copy of ``repro.distributed.overlap``).

The paper's Lemma 3.1/3.2 price a step as compute **plus** communication,
but the standard system remedy (Shi et al.'s wait-free backpropagation;
FireCaffe's bucketed reduction trees) hides gradient sync under the
backward pass: gradients for the *output-side* layers are ready first, so
their collectives can be in flight while the input-side gradients are
still being computed.  This module is the schedule half of that story:

- :class:`BucketPlan` — a size-targeted, reverse-topological partition of
  the gradient tree's leaves into sync buckets.  "Reverse-topological"
  here means reverse flatten order: the model tree flattens input-side
  first (sorted dict keys, JAX's flatten order, so a converted tree gets
  JAX's plan index for index), and walking it backwards visits parameters
  roughly in backward-pass completion order (the same approximation
  PyTorch DDP makes with reverse registration order).  The plan is pure
  data (JSON round trip).
- :func:`build_bucket_plan` — greedy grouping of leaves into buckets of
  ``bucket_bytes`` target payload each.
- :func:`bucket_leaves` / :func:`unbucket_leaves` — split a leaf list into
  the plan's buckets and reassemble it, the partition property the tests
  hold (every leaf exactly once, order restored).

The *execution* half lives in ``repro_torch.distributed.trainer``: with
``sync_overlap=True`` each bucket's compress + sync is issued as soon as
autograd has finished the bucket's gradients, and runs while the rest of
the backward pass does.  The *pricing* half lives in
``repro_torch.core.ps.overlap_step_time``.

Units: all payload sizes in **bytes** (fp32 gradient bytes, matching
``SyncReport.grad_bytes``); ``bucket_mb`` knobs elsewhere are MiB for CLI
ergonomics and are converted once, here, via :func:`mb_to_bytes`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

# Default sync-bucket payload target (MiB): small enough that a reduced-run
# gradient still splits into several buckets, large enough that per-bucket
# collective launch overhead stays amortized on real payloads.  One constant
# shared with the cost model (core prices the same bucketing it cannot
# import from here).
from repro_torch.core.ps import DEFAULT_BUCKET_MB  # noqa: F401
from repro_torch.models.common import tree_items


def mb_to_bytes(mb: float) -> float:
    return float(mb) * 2.0 ** 20


@dataclass(frozen=True)
class BucketPlan:
    """A partition of gradient-tree leaves into dependency-ordered sync
    buckets.

    ``buckets[0]`` holds the *last* leaves of the flatten order (the
    output-side parameters whose gradients the backward pass finishes
    first), so executing buckets in index order launches collectives in
    grad-availability order.  ``leaf_bytes`` records each leaf's fp32
    payload so the plan is self-describing after serialization.
    """

    bucket_bytes: float                       # size target per bucket [bytes]
    buckets: Tuple[Tuple[int, ...], ...]      # leaf indices, availability order
    leaf_bytes: Tuple[float, ...]             # fp32 payload per leaf [bytes]

    def __post_init__(self):
        object.__setattr__(self, "buckets",
                           tuple(tuple(int(i) for i in b)
                                 for b in self.buckets))
        object.__setattr__(self, "leaf_bytes",
                           tuple(float(b) for b in self.leaf_bytes))
        seen = [i for b in self.buckets for i in b]
        if sorted(seen) != list(range(len(self.leaf_bytes))):
            raise ValueError(
                "BucketPlan is not a partition: buckets cover leaf indices "
                f"{sorted(seen)} for {len(self.leaf_bytes)} leaves")
        if self.bucket_bytes <= 0:
            raise ValueError("bucket_bytes must be > 0")

    # -- geometry ----------------------------------------------------------
    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_bytes)

    @property
    def total_bytes(self) -> float:
        return sum(self.leaf_bytes)

    @property
    def sizes_bytes(self) -> Tuple[float, ...]:
        """Per-bucket payload, aligned with ``buckets``."""
        return tuple(sum(self.leaf_bytes[i] for i in b) for b in self.buckets)

    # -- serialization (rides inside Plan / SyncReport JSON) ---------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "bucket_bytes": self.bucket_bytes,
            "buckets": [list(b) for b in self.buckets],
            "leaf_bytes": list(self.leaf_bytes),
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BucketPlan":
        return cls(bucket_bytes=float(d["bucket_bytes"]),
                   buckets=tuple(tuple(b) for b in d["buckets"]),
                   leaf_bytes=tuple(d["leaf_bytes"]))

    @classmethod
    def from_json(cls, s: str) -> "BucketPlan":
        return cls.from_dict(json.loads(s))


def bucket_span_args(plan: BucketPlan, k: int) -> Dict[str, Any]:
    """Span args (``repro_torch.obs``) identifying bucket ``k`` in a trace:
    index, wire payload, and leaf count.  Every executor of a BucketPlan
    labels its ``bucket_sync`` spans through this helper, so traces from
    the trainer (or any future executor) are comparable bucket-for-bucket
    and reconcile against ``SyncReport.bucket_sizes_bytes``."""
    return {"bucket": int(k), "bytes": int(plan.sizes_bytes[k]),
            "n_leaves": len(plan.buckets[k])}


def leaf_sizes_bytes(tree) -> Tuple[float, ...]:
    """fp32 payload per leaf of a nested dict (tensors, arrays or
    ``ParamSpec``s), in flatten order (the sync wire view: every strategy
    moves gradients as fp32, see collectives)."""
    sizes = []
    for _, leaf in tree_items(tree):
        n = 1
        for s in getattr(leaf, "shape", ()):
            n *= int(s)
        sizes.append(4.0 * n)
    return tuple(sizes)


def build_bucket_plan(tree, bucket_bytes: float = mb_to_bytes(DEFAULT_BUCKET_MB)
                      ) -> BucketPlan:
    """Greedy size-capped grouping of ``tree``'s leaves, walking the
    flatten order *backwards* so bucket 0 is the backward pass's first
    finished gradients.

    Cap semantics (PyTorch DDP's ``bucket_cap_mb``): a bucket closes
    *before* the leaf that would push it past ``bucket_bytes``, so no
    bucket exceeds the cap unless a single leaf does on its own.  This
    keeps the cost model's size-level count (``ps.bucket_count``, a plain
    ceil) a conservative lower bound on the real bucket count — the model
    never promises a finer overlap granularity than the executable plan
    delivers."""
    sizes = leaf_sizes_bytes(tree)
    if bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be > 0")
    buckets: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes = 0.0
    for i in range(len(sizes) - 1, -1, -1):  # reverse-topological walk
        if cur and cur_bytes + sizes[i] > bucket_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0.0
        cur.append(i)
        cur_bytes += sizes[i]
    if cur:
        buckets.append(tuple(cur))
    return BucketPlan(bucket_bytes=float(bucket_bytes),
                      buckets=tuple(buckets), leaf_bytes=sizes)


def bucket_leaves(leaves: Sequence[Any], plan: BucketPlan) -> List[List[Any]]:
    """Split a flatten-order leaf list into the plan's buckets (each bucket
    is a list; the trainer keys it into a tree for the compressors and
    strategies)."""
    if len(leaves) != plan.n_leaves:
        raise ValueError(f"got {len(leaves)} leaves for a {plan.n_leaves}-leaf "
                         "BucketPlan")
    return [[leaves[i] for i in b] for b in plan.buckets]


def unbucket_leaves(bucketed: Sequence[Sequence[Any]], plan: BucketPlan
                    ) -> List[Any]:
    """Inverse of :func:`bucket_leaves`: reassemble flatten-order leaves."""
    out: List[Any] = [None] * plan.n_leaves
    if len(bucketed) != plan.n_buckets:
        raise ValueError(f"got {len(bucketed)} buckets for a "
                         f"{plan.n_buckets}-bucket BucketPlan")
    for idx, vals in zip(plan.buckets, bucketed):
        if len(idx) != len(vals):
            raise ValueError("bucket length mismatch")
        for i, v in zip(idx, vals):
            out[i] = v
    return out
