"""The dense SwiGLU MLP (the port of ``repro.models.moe``'s dense part).

The MoE MLP and arctic's parallel dense+MoE residual are not ported yet
(ROADMAP A11)."""
from __future__ import annotations

from typing import Dict

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
