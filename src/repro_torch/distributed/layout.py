"""A mesh as a description and the logical-axis layout rules: the part of
``repro.launch.mesh`` that the rank program itself reads.

JAX hands a ``Mesh`` of devices to GSPMD; PyTorch has no GSPMD, so here a
mesh is a plain description (:class:`Mesh`: axis sizes and names, ranks
laid out row-major over the axes).  :func:`sharding_rules` is JAX's, rule
for rule; :func:`zero_rules` is the optimizer state's layout;
:func:`act_spec` and :func:`batch_spec` return the partition tuples that
JAX's ``act_sharding`` and ``batch_sharding`` wrap in a ``NamedSharding``.
The models and ``distributed/spmd.py`` read these; ``launch/mesh.py``
re-exports them beside the production meshes and the rank's groups.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

Axes = Union[str, Sequence[str]]


class Mesh:
    """A device mesh as a description: ``shape`` (sizes, in axis order)
    and ``axis_names``.  Rank r sits at ``np.unravel_index(r, shape)``
    (row-major, JAX's device order in ``make_mesh``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {tuple(axis_names)}")
        self.dims = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return int(np.prod(self.dims))

    def __repr__(self) -> str:
        return f"Mesh({self.dims}, {self.axis_names})"

    def axes(self, axes: Optional[Axes]) -> Tuple[str, ...]:
        """``axes`` as a tuple of names in mesh order (a name, a tuple, or
        None for no axis)."""
        if axes is None:
            return ()
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.axis_names:
                raise KeyError(f"axis {a!r} is not in the mesh's "
                               f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axes: Optional[Axes]) -> int:
        shape = self.shape
        return int(np.prod([shape[a] for a in self.axes(axes)], dtype=np.int64))

    def coords(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(rank, self.dims))))

    def axis_index(self, axes: Optional[Axes], rank: int) -> int:
        """This rank's index along ``axes`` (row-major over the tuple):
        its shard of a dimension the rules map to ``axes``."""
        c, shape, idx = self.coords(rank), self.shape, 0
        for a in self.axes(axes):
            idx = idx * shape[a] + c[a]
        return idx

    def group_ranks(self, axes: Optional[Axes], rank: int) -> Tuple[int, ...]:
        """The ranks that differ from ``rank`` only along ``axes``, in
        their index order along ``axes``."""
        keep = self.axes(axes)
        c = self.coords(rank)
        grid = np.arange(self.size).reshape(self.dims)
        sub = grid[tuple(slice(None) if a in keep else c[a]
                         for a in self.axis_names)]
        return tuple(int(r) for r in np.asarray(sub).reshape(-1))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def sharding_rules(mesh, cfg: ModelConfig, shape: Optional[ShapeConfig] = None,
                   *, fsdp: bool = False) -> Dict[str, object]:
    """Map logical parameter/cache axes onto mesh axes (JAX's rules).

    TP ("model"): heads / ff / experts / d_inner / vocab.  FSDP adds the
    data-parallel axes on the ``embed`` dim (gathered layer by layer).  KV
    caches: batch on data axes, sequence on "model", and on (data + model)
    when the batch cannot cover the data axes (long_500k, B = 1).  A
    config that holds a share of its experts (``experts_held``, a
    one-card cut) has no layout on a mesh and is refused.
    """
    if cfg.experts_held:
        raise ValueError(
            f"{cfg.name}: experts_held {cfg.experts_held} is a one-card "
            "share of the experts, not a mesh layout; the mesh shards all "
            f"{cfg.num_experts} over 'model'")
    dp = dp_axes(mesh)
    batch_rule: object = dp
    kv_seq_rule: object = ("model",)
    if shape is not None and shape.global_batch < _dp_size(mesh):
        batch_rule = None
        kv_seq_rule = dp + ("model",)
    tp = mesh.shape["model"]
    # attention projections stay replicated where TP does not divide the
    # heads (llava/arctic: 56 heads, minicpm3: 40), as in JAX
    heads_ok = cfg.num_heads == 0 or cfg.num_heads % tp == 0
    return {
        "vocab": "model",
        "q_heads": "model" if heads_ok else None,
        "kv_heads": None,  # kv_heads (<=16) replicated; Q/O carry the TP split
        "ff": "model",
        "experts": "model",
        "inner": "model",
        "ssm_heads": "model",
        "conv_ch": "model",
        "lora": None,
        "embed": dp if fsdp else None,
        "layers": None,
        "batch": batch_rule,
        "kv_seq": kv_seq_rule,
    }


def zero_rules(mesh, rules) -> Dict[str, object]:
    """The optimizer state's rules (ZeRO-1): ``rules`` with ``embed`` on
    the data axes."""
    return dict(rules, embed=dp_axes(mesh))


def act_spec(mesh, shape: Optional[ShapeConfig] = None,
             *, seq_parallel: bool = True) -> Tuple[object, ...]:
    """The residual stream's (B, S, D) partition: JAX's ``act_sharding``
    spec."""
    batch: object = dp_axes(mesh)
    if shape is not None and shape.global_batch < _dp_size(mesh):
        batch = None
    return (batch, "model" if seq_parallel else None, None)


def batch_spec(mesh, shape: Optional[ShapeConfig] = None) -> Tuple[object, ...]:
    """The inputs' leading-dim partition: JAX's ``batch_sharding`` spec."""
    return act_spec(mesh, shape)[:1]
