"""The dense SwiGLU MLP (the port of ``repro.models.moe``'s dense part)
and the MoE MLP's parameter shapes.

The MoE MLP's forward (router and capacity dispatch) and arctic's
parallel dense+MoE residual are not ported yet (ROADMAP A11); its shapes
are here so the planner prices MoE architectures."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, swish


def dense_mlp_specs(d_model: int, d_ff: int, layers: int) -> Dict[str, ParamSpec]:
    L, la = (layers,), ("layers",)
    return {
        "w_gate": ParamSpec(L + (d_model, d_ff), la + ("embed", "ff")),
        "w_up": ParamSpec(L + (d_model, d_ff), la + ("embed", "ff")),
        "w_down": ParamSpec(L + (d_ff, d_model), la + ("ff", "embed")),
    }


def dense_mlp(p, x):
    return (swish(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def moe_specs(cfg: ModelConfig, layers: int) -> Dict[str, ParamSpec]:
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    L, la = (layers,), ("layers",)
    s = {
        "router": ParamSpec(L + (D, E), la + ("embed", None), scale=0.1),
        "w_gate": ParamSpec(L + (E, D, F), la + ("experts", "embed", None)),
        "w_up": ParamSpec(L + (E, D, F), la + ("experts", "embed", None)),
        "w_down": ParamSpec(L + (E, F, D), la + ("experts", None, "embed")),
    }
    if cfg.num_shared_experts:
        s["shared"] = dense_mlp_specs(D, cfg.moe_d_ff * cfg.num_shared_experts, layers)
    return s
