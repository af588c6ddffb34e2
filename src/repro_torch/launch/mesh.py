"""Production meshes and the rank's groups: the twin of
``repro.launch.mesh``.

The mesh description and the layout rules (:class:`Mesh`,
:func:`sharding_rules`, :func:`dp_axes`, :func:`zero_rules`,
:func:`act_spec`, :func:`batch_spec`) live in
``repro_torch.distributed.layout``, below the models that read them, and
are re-exported here.  :func:`groups` builds this rank's process group
along each axis and axis tuple, which the explicit rank program
(``repro_torch.distributed.spmd``) issues its collectives over, and
:func:`make_context` puts groups, rules and the model's specs together.
"""
from __future__ import annotations

from datetime import timedelta
from typing import Dict, Optional, Tuple

import torch.distributed as dist

from repro_torch.distributed.collectives import Group, RecordingGroup
from repro_torch.distributed.layout import (  # noqa: F401
    Axes, Mesh, act_spec, batch_spec, dp_axes, sharding_rules, zero_rules,
)
from repro_torch.distributed.spmd import ShardContext
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production shapes, so the dry run's records line up cell for
    cell with JAX's grid: (16, 16) over ("data", "model"), or (2, 16, 16)
    over ("pod", "data", "model")."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


# ---------------------------------------------------------------------------
# Groups: this rank's process group along each axis and axis tuple
# ---------------------------------------------------------------------------


def group_keys(mesh) -> Tuple[Tuple[str, ...], ...]:
    """The axis tuples a rank program reduces over: each axis, the data
    axes together, and every axis (the world)."""
    keys = [(a,) for a in mesh.axis_names]
    dp = dp_axes(mesh)
    for k in (dp, tuple(mesh.axis_names), dp + ("model",)):
        k = mesh.axes(k)
        if k and k not in keys:
            keys.append(k)
    return tuple(keys)


def groups(mesh, rank: int, *, store=None, device="cuda",
           timeout: timedelta = timedelta(seconds=300),
           log: Optional[list] = None) -> Dict[Tuple[str, ...], Group]:
    """One :class:`Group` per key of :func:`group_keys` for ``rank``.

    With ``store`` (a shared ``HashStore`` for threaded ranks in one
    process, or a ``TCPStore``) each group is built directly on a
    ``PrefixStore`` named after its axes and its place in the mesh
    (gloo on the CPU, NCCL on a card), by the group's members only.
    Without one, under ``torchrun`` (``init_process_group`` done), every
    group of the mesh is made with ``dist.new_group`` in one fixed order,
    as every rank must.  ``device``: the card (NCCL) unless the caller
    asks for the CPU (gloo); ``cuda`` without a card raises.  ``log``: a
    list every group appends its collectives' records to
    (``Group.log``)."""
    dev = resolve_device(device)
    out: Dict[Tuple[str, ...], Group] = {}
    for key in group_keys(mesh):
        members = mesh.group_ranks(key, rank)
        if store is None:
            if not dist.is_initialized():
                raise RuntimeError("groups() without a store needs "
                                   "init_process_group (torchrun)")
            mine = None
            for r0 in sorted({mesh.group_ranks(key, r)[0]
                              for r in range(mesh.size)}):
                pg = dist.new_group(list(mesh.group_ranks(key, r0)))
                if r0 == members[0]:
                    mine = pg
            out[key] = Group(mine, log=log)
            continue
        name = "+".join(key) + f"/{members[0]}"
        sub = dist.PrefixStore(name, store)
        me, n = members.index(rank), len(members)
        if dev.type == "cuda":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            pg = dist.ProcessGroupNCCL(sub, me, n, opts)
        else:
            pg = dist.ProcessGroupGloo(sub, me, n, timeout)
        out[key] = Group(pg, log=log)
    return out


def recording_groups(mesh, rank: int = 0, log: Optional[list] = None
                     ) -> Dict[Tuple[str, ...], Group]:
    """:func:`groups`' keys as :class:`RecordingGroup`s, which move no
    byte: the dry run's groups (meta tensors in, outputs of the right
    shape out, every call logged to ``log``)."""
    log = [] if log is None else log
    return {key: RecordingGroup(len(mesh.group_ranks(key, rank)),
                                mesh.group_ranks(key, rank).index(rank), log)
            for key in group_keys(mesh)}


def make_context(mesh, rank: int, groups, cfg, shape=None, *, fsdp=False,
                 seq_parallel=True, grad_reduce_scatter=True) -> ShardContext:
    """A :class:`~repro_torch.distributed.spmd.ShardContext` on
    ``sharding_rules(mesh, cfg, shape, fsdp)`` and ``cfg``'s specs."""
    return ShardContext(mesh=mesh, rank=rank, groups=groups,
                        rules=sharding_rules(mesh, cfg, shape, fsdp=fsdp),
                        specs=M.model_specs(cfg), fsdp=fsdp,
                        seq_parallel=seq_parallel,
                        grad_reduce_scatter=grad_reduce_scatter)
