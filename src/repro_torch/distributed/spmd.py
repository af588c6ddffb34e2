"""The rank program that GSPMD derives, written out.

JAX runs the train, prefill and decode steps sharded on a ``(data,
model)`` mesh by handing GSPMD the layout that
``launch/mesh.py::sharding_rules`` gives each leaf
(``launch/dryrun.py:64-124``); XLA then derives each device's program and
its collectives.  PyTorch has no GSPMD, so this module is that derived
program in explicit form: every leaf lives in the layout the rules give,
and the collectives that layout forces are issued through
``distributed/collectives.py::Group``.  The same code runs on threaded
gloo ranks (the tests), on the card with one-rank groups, and on the
``meta`` device under ``RecordingGroup``s, which allocate nothing (the
dry run, ``launch/dryrun.py``).

What the layout forces (Megatron's tensor and sequence parallelism, with
FSDP and ZeRO-1 on the data axes):

- the residual stream is (B/dp, S/tp, D) under sequence parallelism: a
  sequence all-gather over ``model`` before each mixer and MLP
  (:func:`enter`), a reduce-scatter of the head- or ff-sharded partial
  sums after (:func:`leave`), each the other's backward; with the
  sequence replicated (``seq_parallel=False``, Megatron's plain tensor
  parallelism) a copy in (identity forward, all-reduce backward) and an
  all-reduce out, and a replicated mixer between neither;
- decode has no sequence to split: a copy in (identity forward,
  all-reduce backward) and an all-reduce out;
- the embedding and the LM head are vocab-parallel
  (:func:`embed_partial`, :func:`vocab_parallel_nll`: an all-reduce of
  the max, of the sum of exponentials and of the target's logit);
- under FSDP each layer's ``embed``-sharded leaves are all-gathered over
  the data axes just before use, their gradients reduce-scattered back
  (:func:`fsdp_gather`);
- the gradients land on the ZeRO-1 layout (``embed`` on the data axes):
  :func:`land_grads` (a reduce-scatter, or JAX's baseline all-reduce),
  the norm of the sharded gradient in :func:`global_norm`;
- a batch smaller than the data axes (the ``batch`` rule empty) is
  whole on every rank: each data rank's gradient is then the whole
  batch's, and nothing is summed over the data axes (FSDP's gather and
  the ZeRO-1 landing take this rank's slice);
- microbatch accumulation spreads each microbatch's rows over the batch
  ranks (:func:`microbatches`, one all-to-all of the inputs).

Which leaves' gradients are summed over ``model`` depends on where the
leaf is read (:func:`_model_partial`): a leaf sharded on ``model`` has
its whole gradient locally; under sequence parallelism every other leaf
sees only its tokens' share; with the sequence replicated, a leaf read
inside a head- or ff-split region (``wk``/``wv`` beside split q heads,
MLA's down-projections, the MoE router) sees only its heads' or experts'
share, while the norms and a replicated mixer's leaves see the whole.
With one-rank groups every collective is the identity (none is issued,
as XLA drops them), and the program is the unsharded one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.collectives import Group
from repro_torch.distributed.layout import dp_axes, zero_rules
from repro_torch.models.common import tree_items, tree_unflatten


# ---------------------------------------------------------------------------
# Collectives along one dim, and their autograd pairs
# ---------------------------------------------------------------------------


def _live(g: Optional[Group]) -> bool:
    return g is not None and g.size > 1


def _leading(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` moved first, contiguous: a copy whenever ``dim``
    is not already first, even where size-1 dims before it would make the
    view contiguous, so the traffic does not depend on a stack's depth
    (the dry run's 1-cycle trace extrapolates)."""
    dim = dim % x.dim()
    if dim == 0:
        return x.contiguous()
    return x.movedim(dim, 0).clone(memory_format=torch.contiguous_format)


def all_gather_dim(g: Group, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order."""
    xt = _leading(x, dim)
    out = g.all_gather(xt.reshape(-1))
    return out.reshape((g.size * xt.shape[0],) + xt.shape[1:]).movedim(0, dim)


def reduce_scatter_dim(g: Group, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's 1/size slice along ``dim`` of the sum over the group."""
    xt = _leading(x, dim)
    if xt.shape[0] % g.size:
        raise ValueError(f"dim {dim} ({xt.shape[0]}) does not split over "
                         f"{g.size} ranks")
    out = g.reduce_scatter(xt.reshape(-1))
    return out.reshape((xt.shape[0] // g.size,) + xt.shape[1:]).movedim(0, dim)


def _summed(g: Group, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    return g.all_reduce(x.clone(memory_format=torch.contiguous_format), op)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter, or this rank's
    slice where every rank's gradient is already the whole (``whole``)."""

    @staticmethod
    def forward(ctx, x, g, dim, whole):
        ctx.g, ctx.dim, ctx.whole = g, dim, whole
        return all_gather_dim(g, x, dim)

    @staticmethod
    def backward(ctx, dy):
        if ctx.whole:
            return local_chunk(dy, ctx.g, ctx.dim), None, None, None
        return reduce_scatter_dim(ctx.g, dy, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return reduce_scatter_dim(g, x, dim)

    @staticmethod
    def backward(ctx, dy):
        return all_gather_dim(ctx.g, dy, ctx.dim), None, None


class _Copy(torch.autograd.Function):
    """Identity; backward: all-reduce (sum)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _summed(ctx.g, dy), None


class _Psum(torch.autograd.Function):
    """All-reduce (sum); backward: all-reduce (JAX's ``psum`` under
    ``shard_map``): for a sum whose ranks go on to compute different
    things from it."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _summed(g, x)

    @staticmethod
    def backward(ctx, dy):
        return _summed(ctx.g, dy), None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum); backward: identity."""

    @staticmethod
    def forward(ctx, x, g):
        return _summed(g, x)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def gather_dim(x, g: Optional[Group], dim: int, whole: bool = False):
    return _Gather.apply(x, g, dim, whole) if _live(g) else x


def scatter_dim(x, g: Optional[Group], dim: int):
    return _Scatter.apply(x, g, dim) if _live(g) else x


def copy_to(x, g: Optional[Group]):
    return _Copy.apply(x, g) if _live(g) else x


def reduce_from(x, g: Optional[Group]):
    return _Reduce.apply(x, g) if _live(g) else x


def psum(x, g: Optional[Group]):
    return _Psum.apply(x, g) if _live(g) else x


def psum_mean(x, g: Optional[Group]):
    """Mean over the group of a value each rank goes on to use
    differently (:func:`psum` over the size)."""
    return psum(x, g) / g.size if _live(g) else x


def pmean(x, g: Optional[Group]):
    """Mean over the group (all-reduce forward, identity/size backward)."""
    return reduce_from(x, g) / g.size if _live(g) else x


def all_reduce_max(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """Elementwise max over the group; carries no gradient."""
    x = x.detach()
    return _summed(g, x, "max") if _live(g) else x


def local_chunk(x, g: Optional[Group], dim: int):
    """This rank's 1/size slice of ``x`` along ``dim`` (no collective)."""
    if not _live(g):
        return x
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.rank * n, n)


# ---------------------------------------------------------------------------
# The rank's context
# ---------------------------------------------------------------------------


@dataclass
class ShardContext:
    """What a rank program needs to know of its mesh: the mesh and this
    rank, its groups (``launch/mesh.py::groups``), the rules, the model's
    specs (the FSDP dims), and the step's layout options
    (``launch/mesh.py::make_context`` builds one).
    ``grad_reduce_scatter``: the data-axis gradient sum lands on the
    ZeRO-1 layout by reduce-scatter (else by all-reduce and a slice,
    GSPMD's baseline choice)."""

    mesh: Any
    rank: int
    groups: Dict[Tuple[str, ...], Group]
    rules: Dict[str, object]
    specs: Dict[str, Any]
    fsdp: bool = False
    seq_parallel: bool = True
    grad_reduce_scatter: bool = True

    def axes(self, axes) -> Tuple[str, ...]:
        return self.mesh.axes(axes)

    def group(self, axes) -> Optional[Group]:
        """The group along ``axes`` (None for no axis)."""
        key = self.axes(axes)
        return self.groups[key] if key else None

    def size(self, axes) -> int:
        return self.mesh.axis_size(axes)

    def index(self, axes) -> int:
        return self.mesh.axis_index(axes, self.rank)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return dp_axes(self.mesh)

    @property
    def world(self) -> Optional[Group]:
        return self.group(self.mesh.axis_names)

    def rule(self, logical: str) -> Tuple[str, ...]:
        return self.axes(self.rules.get(logical))

    def layer_spec(self, name: str):
        """The (stacked) spec tree of slot ``name`` (``slot0``, ...) or of
        the ``prelude``."""
        if name == "prelude":
            return self.specs["prelude"]
        return self.specs["slots"][name]


# ---------------------------------------------------------------------------
# Layout transitions of the residual stream
# ---------------------------------------------------------------------------


def enter(x, ctx: Optional[ShardContext], seq: bool, partial: bool = True):
    """Residual (seq-sharded when ``seq``) -> the whole sequence,
    replicated over ``model``: what a head- or ff-sharded layer reads.
    ``partial`` as :func:`leave`'s: a replicated layer on a replicated
    residual reads ``x`` itself, since its input gradient is already
    whole on every rank.  Without a context (one device), ``x``."""
    if ctx is None:
        return x
    g = ctx.group("model")
    if seq:
        return gather_dim(x, g, 1)
    return copy_to(x, g) if partial else x


def leave(y, ctx: Optional[ShardContext], seq: bool, partial: bool = True):
    """A layer's output -> the residual's layout.  ``partial``: the output
    is a sum over ``model`` ranks (row-parallel); else every model rank
    computed all of it (replicated attention).  Without a context, ``y``."""
    if ctx is None:
        return y
    g = ctx.group("model")
    if seq:
        return scatter_dim(y, g, 1) if partial else local_chunk(y, g, 1)
    return reduce_from(y, g) if partial else y


def local_seq(t, ctx: ShardContext, dim: int = 1):
    """This rank's ``kv_seq`` slice of a cache the whole sequence of which
    it computed."""
    return local_chunk(t, ctx.group(ctx.rules["kv_seq"]), dim)


def last_token(h, ctx: ShardContext, seq: bool):
    """The sequence's last position (B, 1, D): on a seq-sharded residual
    it lives on the last model rank, so each rank's last row is gathered
    and the last kept."""
    if not seq:
        return h[:, -1:]
    return gather_dim(h[:, -1:], ctx.group("model"), 1)[:, -1:]


# ---------------------------------------------------------------------------
# Vocab parallelism
# ---------------------------------------------------------------------------


def vocab_lo(ctx: ShardContext, v_loc: int) -> int:
    """The first vocab id of this rank's rows."""
    return ctx.index(ctx.rules["vocab"]) * v_loc


def embed_partial(table: torch.Tensor, tokens: torch.Tensor,
                  v_lo: int) -> torch.Tensor:
    """Rows of ``table`` (this rank's V/tp vocab rows) for ``tokens``, zero
    where a token's row lives on another rank; summed over ``model`` it is
    the lookup."""
    v_loc = table.shape[0]
    local = tokens.long() - v_lo
    inside = (local >= 0) & (local < v_loc)
    rows = table[local.clamp(0, v_loc - 1)]
    return rows.masked_fill(~inside[..., None], 0)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       v_lo: int, ctx: ShardContext) -> torch.Tensor:
    """Per-token ``logsumexp - logit[label]`` from vocab-sharded fp32
    logits (..., V/tp): an all-reduce of the max (no gradient), of the sum
    of exponentials and of the target's logit (both identity backward, so
    each rank differentiates its own columns: Megatron's form)."""
    g = ctx.group(ctx.rules["vocab"])
    m = all_reduce_max(logits.amax(dim=-1), g)
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), g)
    logz = m + torch.log(sumexp)
    v_loc = logits.shape[-1]
    local = labels.long() - v_lo
    inside = (local >= 0) & (local < v_loc)
    gold = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])
    gold = reduce_from(gold[..., 0].masked_fill(~inside, 0.0), g)
    return logz - gold


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------


def _embed_dim(spec) -> Optional[int]:
    return spec.axes.index("embed") if "embed" in spec.axes else None


def fsdp_gather(tree, specs, ctx: ShardContext, offset: int = 0):
    """All-gather over the data axes the ``embed`` dim of every leaf of
    ``tree`` (aligned with the spec tree ``specs``; ``offset`` 1 for one
    layer's views of stacked leaves); backward: reduce-scatter.  Without
    FSDP, ``tree`` as it is."""
    if not ctx.fsdp:
        return tree
    g = ctx.group(ctx.rules["embed"])
    if not _live(g):
        return tree
    whole = not ctx.rule("batch")
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = fsdp_gather(v, specs[k], ctx, offset)
            continue
        d = _embed_dim(specs[k])
        out[k] = v if d is None else gather_dim(v, g, d - offset, whole)
    return out


# ---------------------------------------------------------------------------
# Microbatches
# ---------------------------------------------------------------------------


def microbatches(batch, n: int, ctx: ShardContext):
    """This rank's rows of each of the ``n`` microbatches of the global
    batch, in pass order (a list of ``n`` batches).  Microbatch i is the
    global rows ``[i m, (i + 1) m)`` (m = B/n, JAX's reshape), spread over
    the k ranks of the ``batch`` rule, m/k rows a rank, so that each pass
    holds JAX's sharded ``X_mini``.  Every input moves by one all-to-all
    over those ranks (nothing moves where k is 1): this rank's B/k rows
    are n blocks of m/k rows, global blocks ``s n .. s n + n - 1`` for
    its index s, and global block j is pass j // k on rank j mod k, so
    each rank receives its blocks in pass order.  ``ValueError`` where
    the batch or a microbatch does not split."""
    axes = ctx.rules["batch"]
    k, s, g = ctx.size(axes), ctx.index(axes), ctx.group(axes)
    b = batch["tokens"].shape[0]
    if b % n:  # B % n, or a microbatch's B/n rows over the k ranks
        raise ValueError(
            f"global batch {b * k} ({b} rows on each of {k} ranks of the "
            f"batch axes {ctx.axes(axes)}) does not split into {n} "
            f"microbatches whose rows split over those {k} ranks")
    q = b // n  # rows a rank a pass: m/k
    dest = [(s * n + j) % k for j in range(n)]
    order = sorted(range(n), key=lambda j: (dest[j], j))
    sent = [dest.count(r) for r in range(k)]
    got = [sum((r * n + j) % k == s for j in range(n)) for r in range(k)]
    out = {}
    for key, t in batch.items():
        blocks = t.reshape((n, q) + t.shape[1:])
        if _live(g) and n > 1:  # one microbatch: every row stays put
            row = q * t[0].numel()
            moved = g.all_to_all(
                torch.cat([blocks[j] for j in order]).reshape(-1),
                [c * row for c in sent], [c * row for c in got])
            blocks = moved.reshape(blocks.shape)
        out[key] = blocks
    return [{key: v[i] for key, v in out.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Gradients onto the ZeRO-1 layout, and its optimizer shard
# ---------------------------------------------------------------------------


def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def _split_on_model(ctx: ShardContext, spec) -> bool:
    """Whether the rules shard a dim of ``spec`` over ``model``."""
    return any("model" in ctx.axes(ctx.rules.get(a) if a is not None
                                   else None) for a in spec.axes)


def _model_partial(ctx: ShardContext, path) -> bool:
    """Whether the leaf at ``path`` has a part of its gradient on each
    model rank (so it is summed over ``model``): never where it is split
    on ``model``; always under sequence parallelism (its tokens' share);
    with the sequence replicated, where it is read inside a split region,
    a mixer or MLP that has a leaf split on ``model`` (its heads',
    channels' or experts' share).  The top leaves, the norms and a
    replicated mixer read the replicated residual with its whole
    gradient."""
    if _split_on_model(ctx, _spec_at(ctx.specs, path)):
        return False
    if ctx.seq_parallel:
        return True
    for i, k in enumerate(path):
        if k in ("mixer", "mlp"):
            return any(_split_on_model(ctx, sp) for _, sp in
                       tree_items(_spec_at(ctx.specs, path[:i + 1])))
    return False


def _zero_dim(ctx: ShardContext, spec) -> Optional[int]:
    """The dim a gradient is reduce-scattered on (ZeRO-1), None where the
    leaf has no ``embed`` dim or FSDP already shards it."""
    d = _embed_dim(spec)
    if d is None or (ctx.fsdp and ctx.rule("embed")):
        return None
    return d


def land_grads(grads, ctx: ShardContext):
    """This rank's gradients -> the whole batch's, in the ZeRO-1 layout:
    over the data axes a reduce-scatter on ``embed`` (or an all-reduce
    and this rank's slice; FSDP's gather already reduce-scattered its
    leaves), an all-reduce for a leaf with no ``embed`` dim, or, where
    the batch is whole on every rank, this rank's slice alone; then an
    all-reduce over ``model`` for each leaf whose gradient is partial on
    each model rank (:func:`_model_partial`)."""
    dp = ctx.group(ctx.dp_axes)
    g_model = ctx.group("model")
    split_batch = bool(ctx.rule("batch"))
    out = []
    for path, g in tree_items(grads):
        spec = _spec_at(ctx.specs, path)
        d = _zero_dim(ctx, spec)
        if _embed_dim(spec) is None:
            if split_batch:
                g = reduce_from(g, dp)
        elif d is not None:
            if not split_batch:
                g = local_chunk(g, dp, d)
            elif ctx.grad_reduce_scatter:
                g = scatter_dim(g, dp, d)
            else:
                g = local_chunk(reduce_from(g, dp), dp, d)
        if _model_partial(ctx, path):
            g = reduce_from(g, g_model)
        out.append((path, g))
    return tree_unflatten(out)


def global_norm(grads, ctx: ShardContext) -> torch.Tensor:
    """The norm of the whole gradient from this rank's ZeRO-1 shards: each
    leaf's sum of squares over the ranks that replicate it, summed over
    the world."""
    zr = zero_rules(ctx.mesh, ctx.rules)
    world = ctx.mesh.size
    parts = []
    for path, g in tree_items(grads):
        spec = _spec_at(ctx.specs, path)
        used = set()
        for a in spec.axes:
            used.update(ctx.axes(zr.get(a) if a is not None else None))
        rep = world // ctx.mesh.axis_size(tuple(used))
        parts.append(torch.sum(torch.square(g.float())) / rep)
    return torch.sqrt(reduce_from(torch.stack(parts).sum(), ctx.world))


def opt_shards(params, ctx: ShardContext):
    """Views of ``params`` in the ZeRO-1 layout (the slice of ``embed``
    this rank's optimizer shard updates), written in place by AdamW."""
    dp = ctx.group(ctx.dp_axes)
    out = []
    for path, p in tree_items(params):
        d = _zero_dim(ctx, _spec_at(ctx.specs, path))
        out.append((path, p if d is None else local_chunk(p, dp, d)))
    return tree_unflatten(out)


def gather_params(params, ctx: ShardContext) -> None:
    """After the shard's update: all-gather each ZeRO-sliced leaf over the
    data axes back into the parameter layout, in place."""
    dp = ctx.group(ctx.dp_axes)
    if not _live(dp):
        return
    with torch.no_grad():
        for path, p in tree_items(params):
            d = _zero_dim(ctx, _spec_at(ctx.specs, path))
            if d is not None:
                p.copy_(all_gather_dim(dp, local_chunk(p, dp, d), d))


# ---------------------------------------------------------------------------
# Placing and assembling trees (tests and the card's checks)
# ---------------------------------------------------------------------------


def _slices(spec_axes, shape, mesh, rank, rules):
    idx = []
    for dim, a in zip(shape, spec_axes):
        axes = rules.get(a) if a is not None else None
        n = mesh.axis_size(axes)
        i = mesh.axis_index(axes, rank)
        idx.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(idx)


def shard_tree(full, specs, rules, mesh, rank: int):
    """This rank's blocks of the full tensors of ``full`` (a tree aligned
    with ``specs``), as contiguous copies."""
    return tree_unflatten(
        (path, t[_slices(_spec_at(specs, path).axes, t.shape, mesh, rank,
                         rules)].clone())
        for path, t in tree_items(full))


def unshard_tree(per_rank, specs, rules, mesh):
    """The full tensors from every rank's blocks (``per_rank[r]`` is rank
    r's tree); each rank writes its block, so the last replica of a
    replicated block stands."""
    out = []
    for path, t0 in tree_items(per_rank[0]):
        spec = _spec_at(specs, path)
        full = t0.new_empty(spec.shape)
        for r in range(mesh.size):
            t = _spec_at(per_rank[r], path)
            full[_slices(spec.axes, spec.shape, mesh, r, rules)] = t
        out.append((path, full))
    return tree_unflatten(out)
