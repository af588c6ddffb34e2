"""The benchmark's weights: every parameter of a configuration, made from
the seed on the device in fp32 (the masters' type), one generator call
per leaf.

The layout is the program's parameter tree (paths and stacked shapes, as
``models/model.py::model_specs`` gives them), written out here from the
configuration file's sizes so that the reference reads the same tensors
by name; :func:`check_layout` holds it against the program's own specs
before a run starts.  Each leaf draws from its own generator seeded from
the seed and the crc32 of its path, so one leaf can be made again alone.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str, float]  # path, shape, init, scale


def padded_vocab(model: Dict) -> int:
    return -(-int(model["vocab_size"]) // 256) * 256


def layout(config: Dict) -> List[Leaf]:
    """(path, shape, init, scale) of every leaf, in sorted path order."""
    m = config["model"]
    L, D = int(m["num_layers"]), int(m["d_model"])
    out: List[Leaf] = [("embed", (padded_vocab(m), D), "normal", 0.02),
                       ("final_norm", (D,), "normal", 0.1)]
    pre = "slots/slot0/"
    out.append((pre + "mixer_norm", (L, D), "normal", 0.1))
    if config["mixer"] == "attn":
        H, KV, hd, F = (int(m["num_heads"]), int(m["num_kv_heads"]),
                        int(m["head_dim"]), int(m["d_ff"]))
        out += [(pre + "mixer/wq", (L, D, H, hd), "normal", D ** -0.5),
                (pre + "mixer/wk", (L, D, KV, hd), "normal", D ** -0.5),
                (pre + "mixer/wv", (L, D, KV, hd), "normal", D ** -0.5),
                (pre + "mixer/wo", (L, H, hd, D), "normal", (H * hd) ** -0.5),
                (pre + "mlp_norm", (L, D), "normal", 0.1),
                (pre + "mlp/w_gate", (L, D, F), "normal", D ** -0.5),
                (pre + "mlp/w_up", (L, D, F), "normal", D ** -0.5),
                (pre + "mlp/w_down", (L, F, D), "normal", F ** -0.5)]
    elif config["mixer"] == "mamba":
        N, P = int(m["ssm_state"]), int(m["ssm_head_dim"])
        DI = int(m["ssm_expand"]) * D
        H, W = DI // P, int(m["ssm_conv_width"])
        ch = DI + 2 * N
        out += [(pre + "mixer/w_z", (L, D, DI), "normal", D ** -0.5),
                (pre + "mixer/w_xbc", (L, D, ch), "normal", D ** -0.5),
                (pre + "mixer/w_dt", (L, D, H), "normal", D ** -0.5),
                (pre + "mixer/conv_w", (L, W, ch), "normal", 0.5),
                (pre + "mixer/conv_b", (L, ch), "normal", 0.02),
                (pre + "mixer/a_log", (L, H), "log_uniform", 0.0),
                (pre + "mixer/dt_bias", (L, H), "dt_bias", 0.0),
                (pre + "mixer/d_skip", (L, H), "ones", 0.0),
                (pre + "mixer/gate_norm", (L, DI), "normal", 0.1),
                (pre + "mixer/w_out", (L, DI, D), "normal", DI ** -0.5)]
        if int(m.get("d_ff", 0)):
            raise ValueError("a Mamba block with an MLP is not laid out here")
    else:
        raise ValueError(f"unknown mixer {config['mixer']!r}")
    return sorted(out)


def leaf_seed(seed: int, path: str) -> int:
    return (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % (1 << 63)


def make_leaf(leaf: Leaf, seed: int, device) -> torch.Tensor:
    path, shape, init, scale = leaf
    if init == "ones":
        return torch.ones(shape, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, path))
    if init == "normal":
        return torch.randn(shape, generator=g, device=device).mul_(scale)
    u = torch.rand(shape, generator=g, device=device)
    if init == "log_uniform":  # A_log = log U[1, 16]
        return u.mul_(15.0).add_(1.0).log_()
    if init == "dt_bias":  # softplus^-1 of U[1e-3, 0.1]
        u = u.mul_(0.1 - 1e-3).add_(1e-3)
        return u + torch.log(-torch.expm1(-u))
    raise ValueError(f"{path}: unknown init {init!r}")


def make(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: fp32 tensor} of every leaf."""
    return {leaf[0]: make_leaf(leaf, seed, device) for leaf in layout(config)}


def nested(flat: Dict[str, torch.Tensor]) -> Dict:
    """The program's nested tree of the same tensors (no copy)."""
    out: Dict = {}
    for path, t in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return out


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def check_layout(config: Dict, program_shapes: Dict[str, Tuple[int, ...]]):
    """Raise unless the program's parameter tree has exactly this layout."""
    mine = {p: tuple(s) for p, s, _, _ in layout(config)}
    theirs = {p: tuple(s) for p, s in program_shapes.items()}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()))
        raise ValueError(f"the program's parameter layout differs from the "
                         f"benchmark's: {diff[:6]}")


def count(config: Dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in layout(config))
