"""One card's share of the experts (``ModelConfig.experts_held``,
``models/moe.py``), on the CPU at a small size (E = 16, top-2, 4 held):

- the partial outputs of the four shares (``_local_expert_pass`` at
  e_lo = 0, 4, 8, 12), with the shared experts counted once, add up to
  ``moe_mlp`` with every expert held, to fp32 rounding, and their aux is
  the whole layer's; at a capacity that drops nothing they add up to the
  uncut reference (``moe_mlp_ref``);
- ``moe_mlp`` with 4 held is the first share's partial plus the shared
  experts, and its leaves are the held experts' (``moe_specs``);
- ``experts_held == 0`` gives output and gradients bitwise those of
  ``moe_mlp`` as it was before held shares (a frozen copy below), with
  the tracer off and on;
- the expert-parallel path and the mesh's rules refuse a held share;
- a tiny DeepSeek-V2 model with 2 of 4 experts held trains through the
  step ``Session.train()`` builds.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.distributed import layout
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import swish, tree_items
from repro_torch.obs import trace
from repro_torch.obs.trace import Tracer
from repro_torch.optim import adamw

E, HELD, K, D, F, T = 16, 4, 2, 32, 24, 96


def _cfg(**kw):
    return get_config("deepseek-v2-236b").reduced().replace(
        d_model=D, num_experts=E, top_k=K, moe_d_ff=F, num_shared_experts=1,
        dtype="float32", **kw)


def _params(seed=0, experts=E):
    g = torch.Generator().manual_seed(seed)

    def n(*shape, s=1.0):
        return torch.randn(*shape, generator=g) * s

    return {"router": n(D, E, s=D ** -0.5),
            "w_gate": n(experts, D, F, s=D ** -0.5),
            "w_up": n(experts, D, F, s=D ** -0.5),
            "w_down": n(experts, F, D, s=F ** -0.5),
            "shared": {"w_gate": n(D, F, s=D ** -0.5),
                       "w_up": n(D, F, s=D ** -0.5),
                       "w_down": n(F, D, s=F ** -0.5)}}


def _x(seed=1, rows=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, T // rows, D, generator=g)


def _shares(p, x, cfg, cf):
    xf = x.reshape(-1, D)
    parts, auxes = [], []
    for lo in range(0, E, HELD):
        out, aux = moe._local_expert_pass(
            xf, p["router"], p["w_gate"][lo: lo + HELD],
            p["w_up"][lo: lo + HELD], p["w_down"][lo: lo + HELD], cfg, cf,
            lo, HELD)
        parts.append(out)
        auxes.append(aux)
    return parts, auxes


@pytest.mark.parametrize("cf", [1.25, 64.0])
def test_the_shares_add_up_to_the_whole_layer(cf):
    cfg, p, x = _cfg(), _params(), _x()
    parts, auxes = _shares(p, x, cfg, cf)
    shared = moe.dense_mlp(p["shared"], x)
    got = sum(parts).reshape(x.shape) + shared
    whole, aux = moe.moe_mlp(p, x, cfg, capacity_factor=cf)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
    for a in auxes:  # every share routes over all E experts
        assert torch.equal(a, aux)
    if cf == 1.25:  # capacity drops some assignments at 1.25
        uncapped, _ = moe.moe_mlp(p, x, cfg, capacity_factor=64.0)
        assert not torch.allclose(whole, uncapped, atol=1e-4)
    else:
        torch.testing.assert_close(got, moe.moe_mlp_ref(p, x, cfg),
                                   rtol=1e-5, atol=1e-5)
    assert all(float(part.abs().sum()) > 0 for part in parts)


def test_a_held_share_is_the_first_shares_part():
    cfg = _cfg(experts_held=HELD)
    full = _params()
    p = {k: (v[:HELD] if k.startswith("w_") else v) for k, v in full.items()}
    x = _x()
    out, aux = moe.moe_mlp(p, x, cfg)
    parts, auxes = _shares(full, x, _cfg(), 1.25)
    want = parts[0].reshape(x.shape) + moe.dense_mlp(p["shared"], x)
    assert torch.equal(out, want) and torch.equal(aux, auxes[0])
    specs = moe.moe_specs(cfg, 3)
    assert specs["router"].shape == (3, D, E)
    assert specs["w_gate"].shape == specs["w_up"].shape == (3, HELD, D, F)
    assert specs["w_down"].shape == (3, HELD, F, D)
    assert moe.moe_specs(_cfg(), 3)["w_gate"].shape == (3, E, D, F)
    with pytest.raises(ValueError, match="experts_held"):
        moe.held_experts(_cfg(experts_held=E + 1))


def _parent_moe_mlp(p, x, cfg, capacity_factor=1.25):
    """``moe_mlp`` as it was before held shares, line for line."""
    B, S, D_ = x.shape
    xf = x.reshape(B * S, D_)
    T_, K_ = xf.shape[0], cfg.top_k
    r = moe.route({"router": p["router"]}, xf, cfg, capacity_factor)
    C, order, se = r["C"], r["order"], r["se"]
    local = (se >= 0) & (se < cfg.num_experts) & r["keep"]
    slot = torch.where(local, r["slot"],
                       torch.full_like(se, cfg.num_experts * C))
    xs = xf[:, None].expand(T_, K_, D_).reshape(T_ * K_, D_)[order]
    buf = xf.new_zeros((cfg.num_experts * C + 1, D_)).index_put((slot,), xs)
    h = buf[: cfg.num_experts * C].reshape(cfg.num_experts, C, D_)
    y = torch.einsum(
        "ecf,efd->ecd",
        swish(torch.einsum("ecd,edf->ecf", h, p["w_gate"]))
        * torch.einsum("ecd,edf->ecf", h, p["w_up"]), p["w_down"])
    y = torch.cat([y.reshape(cfg.num_experts * C, D_), y.new_zeros((1, D_))],
                  dim=0)
    v = (y[slot] * torch.where(local, r["sw"], 0.0)[:, None]).float()
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T_ * K_)
    v_tok = v[torch.sort(inv.reshape(T_, K_), dim=-1).values]
    out = torch.zeros((T_, D_), dtype=torch.float32)
    for j in range(K_):
        out = out + v_tok[:, j]
    out = out.to(x.dtype).reshape(B, S, D_) + moe.dense_mlp(p["shared"], x)
    return out, r["aux"]


def _with_grads(fn, p, x):
    leaves = [(path, t.clone().requires_grad_()) for path, t in
              tree_items(p)]
    tree = {}
    for path, t in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    xx = x.clone().requires_grad_()
    out, aux = fn(tree, xx)
    (out.square().sum() + aux).backward()
    return out.detach(), aux.detach(), [xx.grad] + [t.grad for _, t in leaves]


@pytest.mark.parametrize("traced", [False, True])
def test_all_experts_held_is_bitwise_the_parents(traced):
    cfg, p, x = _cfg(), _params(seed=3), _x(seed=4)
    assert cfg.experts_held == 0
    want = _with_grads(lambda q, u: _parent_moe_mlp(q, u, cfg), p, x)
    with trace.use(Tracer(enabled=traced)):
        got = _with_grads(lambda q, u: moe.moe_mlp(q, u, cfg), p, x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


def test_the_mesh_refuses_a_held_share():
    cfg = _cfg(experts_held=HELD)
    p, x = _params(), _x()
    with pytest.raises(ValueError, match="experts_held"):
        moe.moe_mlp_sharded(p, x, cfg, mesh=None)
    with pytest.raises(ValueError, match="experts_held"):
        layout.sharding_rules(mesh_lib.Mesh((1, 2), ("data", "model")), cfg)
    layout.sharding_rules(mesh_lib.Mesh((1, 2), ("data", "model")), _cfg())


def test_a_held_share_trains_through_the_sessions_step():
    cfg = get_config("deepseek-v2-236b").reduced().replace(
        num_layers=3, experts_held=2, vocab_size=256, dtype="float32")
    params = M.init_params(cfg, 0, "cpu")
    assert params["slots"]["slot0"]["mlp"]["w_gate"].shape[:2] == (2, 2)
    assert params["slots"]["slot0"]["mlp"]["router"].shape[-1] == 4
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=8)
    state = adamw.init_state(opt, params)
    step = build_train_step(cfg, RunConfig(attn_impl="auto"), opt)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 32)).astype(np.int64))
    before = params["slots"]["slot0"]["mlp"]["w_gate"].clone()
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, {"tokens": toks,
                                                "labels": toks})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not torch.equal(params["slots"]["slot0"]["mlp"]["w_gate"], before)
