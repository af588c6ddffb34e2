"""Carry a JAX parameter tree into the port.

The port names every parameter by the JAX path string
(``slots/slot0/mixer/wq``) and keeps JAX's layouts (``wq (L,D,H,hd)``,
``wo (L,H,hd,D)``, ``embed (V,D)``; a Mamba mixer's ``w_z (L,D,DI)``,
``w_xbc (L,D,DI+2N)``, ``w_dt (L,D,H)``, ``conv_w (L,W,DI+2N)``,
``conv_b``, ``dt_bias``, ``a_log``, ``d_skip``, ``gate_norm`` and
``w_out (L,DI,D)``; a K-codebook model's ``embed (K,V,D)`` and
``lm_head (K,D,V)``; gemma2's ``mixer_post_norm`` and ``mlp_post_norm``),
so conversion is a copy, name for name.  The caller
turns the JAX arrays into numpy first (``jax.tree_util.tree_map(
np.asarray, params)``), so this module needs no JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.common import path_str, resolve_device, tree_items


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device):
    """Nested dict of numpy arrays (JAX layout) -> nested dict of tensors on
    ``device``, checked name for name and shape for shape against
    ``model_specs(cfg)``.  Values keep their dtype (JAX's are float32
    masters; the serving engines cast once at load)."""
    dev = resolve_device(device)
    got = dict(tree_items(tree))
    want = dict(tree_items(M.model_specs(cfg)))
    if set(got) != set(want):
        missing = sorted(path_str(p) for p in set(want) - set(got))
        extra = sorted(path_str(p) for p in set(got) - set(want))
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"unexpected {extra}")
    out: Dict[str, Any] = {}
    for path, spec in want.items():
        arr = np.asarray(got[path])
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{path_str(path)}: shape {arr.shape} != "
                             f"{spec.shape}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(np.array(arr)).to(dev)
    return out
