"""Shared model machinery: ParamSpec trees (the single source of truth for
shapes and init), norms, rope, softcap, the masked cross-entropy — the port
of ``repro.models.common``.

A model's ``*_specs(config)`` returns a nested dict whose leaves are
:class:`ParamSpec`; :func:`materialize` turns it into a dict of tensors of
the same structure.  Parameters are named by their JAX path string
(``slots/slot0/mixer/wq``) and keep JAX's layouts, so a JAX parameter tree
converts name for name (``repro_torch.models.convert``).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


class DeviceCountError(RuntimeError):
    """A job that asks for more ranks' devices than are visible."""


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card raises:
    nothing in the port moves to the CPU unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


# ---------------------------------------------------------------------------
# ParamSpec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    dtype: str = "float32"
    init: str = "normal"  # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 1.0  # stddev multiplier / fan-in handled by caller

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_unflatten(items) -> dict:
    """Nested dict from (path, leaf) pairs, the inverse of :func:`tree_items`."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def path_str(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def materialize(specs, seed: int, device):
    """Randomly initialize real parameters from a ParamSpec tree.

    Each leaf draws from its own ``torch.Generator`` seeded from ``seed``
    and the crc32 of its path (the JAX package folds the same crc32 into
    its PRNG key), so a leaf's values do not depend on which other leaves
    exist.  Normal leaves use std ``scale / sqrt(fan_in)`` with fan_in the
    second-to-last dim, as JAX does.  The numbers differ from JAX's: tests
    that compare the two convert JAX's parameters."""
    dev = resolve_device(device)

    def init_leaf(path, spec: ParamSpec):
        dt = torch_dtype(spec.dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed) * 2**31 + zlib.crc32(path_str(path).encode()) % 2**31)
        if spec.init == "ssm_a":  # A_log init: log of uniform [1, 16]
            u = torch.rand(spec.shape, generator=g, device=dev) * 15.0 + 1.0
            return torch.log(u).to(dt)
        if spec.init == "ssm_dt":  # dt_bias: softplus^-1 of uniform [1e-3, 0.1]
            u = torch.rand(spec.shape, generator=g, device=dev) * (0.1 - 1e-3) + 1e-3
            return (u + torch.log(-torch.expm1(-u))).to(dt)
        if spec.init != "normal":
            raise ValueError(f"{path_str(path)}: unknown init {spec.init!r}")
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / np.sqrt(max(fan_in, 1))
        x = torch.randn(spec.shape, generator=g, dtype=torch.float32, device=dev)
        return (x * std).to(dt)

    return _build(specs, (), init_leaf)


def _build(tree, prefix, fn):
    return {k: _build(v, prefix + (k,), fn) if isinstance(v, dict)
            else fn(prefix + (k,), v) for k, v in tree.items()}


def param_count(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for _, s in tree_items(specs)))


# ---------------------------------------------------------------------------
# Sharding: logical axes -> mesh axes -> per-rank shapes
# ---------------------------------------------------------------------------


def _spec_axes(spec: ParamSpec, rules):
    return tuple(rules.get(a) if a is not None else None for a in spec.axes)


def partition_specs(specs, rules):
    """Map logical axes to mesh axes via ``rules``: per leaf, a tuple with
    one entry per dim (a mesh axis, a tuple of them, or None), JAX's
    ``PartitionSpec``."""
    return tree_map(lambda s: _spec_axes(s, rules), specs)


def local_shape(spec: ParamSpec, rules, mesh) -> Tuple[int, ...]:
    """One rank's shape of ``spec``'s tensor on ``mesh``
    (``launch.mesh.Mesh``): each dim mapped to mesh axes divided by their
    size.  A division that is not exact raises ``ValueError``, where
    GSPMD would refuse the sharding."""
    out = []
    for dim, axes, name in zip(spec.shape, _spec_axes(spec, rules),
                               spec.axes):
        n = mesh.axis_size(axes)
        if dim % n:
            raise ValueError(f"dim {name!r} of {spec.shape} ({dim}) does not "
                             f"divide over mesh axes {axes} ({n})")
        out.append(dim // n)
    return tuple(out)


def abstractify(specs, mesh, rules, dtype_override: Optional[str] = None):
    """Meta tensors of each leaf's per-rank shape (JAX's ShapeDtypeStructs
    with shardings): nothing is allocated."""
    return tree_map(lambda s: torch.empty(
        local_shape(s, rules, mesh),
        dtype=torch_dtype(dtype_override or s.dtype), device="meta"), specs)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def smooth_attention(params, cfg):
    """Rescale slot 0's attention projections in place so each has std
    1/sqrt(fan-in of the whole product); returns ``params``.  The JAX
    package's init takes fan-in = heads for the (D, H, hd) projections,
    which makes the scores' std ~100 and the softmax nearly one-hot."""
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    mix = params["slots"]["slot0"]["mixer"]
    mix["wq"].mul_((H / D) ** 0.5)
    mix["wk"].mul_((KV / D) ** 0.5)
    mix["wv"].mul_((KV / D) ** 0.5)
    mix["wo"].mul_(H ** -0.5)
    return params


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             mean_of: Optional[Callable] = None) -> torch.Tensor:
    """``mean_of``: where ``x`` holds one rank's equal slice of the
    normalised dim, the mean over the ranks of each one's mean of squares
    (``distributed.spmd.psum_mean`` over their group)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    if mean_of is not None:
        var = mean_of(var)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding (half-split). x: (..., S, H, D_rot); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, logit_cap: float = 0.0) -> torch.Tensor:
    """Mean CE over mask. logits (..., V) cast to fp32 inside; labels int."""
    logits = softcap(logits.float(), logit_cap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
