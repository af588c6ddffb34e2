"""Block (slot) composition: pre-norm mixer + residual, pre-norm MLP +
residual, optional post-norms — the port of ``repro.models.blocks``.

``slot_specs`` gives the parameter shapes of every slot kind (GQA, MLA,
Mamba; dense, MoE, and arctic's dense + MoE), so the planner prices the
full architecture of every arch.  Forward and decode run
``("attn", "dense")`` slots; the others raise ``NotImplementedError``
until their slice is ported (ROADMAP A11), and
``models.model.init_params`` refuses them before any parameter exists.
The Mamba mixer itself is ``models/ssm.py``; its slot comes with Mamba
serving."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from repro_torch.configs.base import ModelConfig, SlotSpec
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ParamSpec, rms_norm

PORTED_SLOTS = (("attn", "dense"),)
REMATS = ("none", "block")


@dataclass
class RunConfig:
    """Runtime (non-architecture) knobs: the JAX package's, less the
    sharding, MoE and dry-run fields, which nothing in the port reads."""

    attn_impl: str = "dense"  # dense | chunked | auto | kernel (JAX's pallas)
    remat: str = "block"  # none | block (recompute each cycle in backward)
    microbatch: int = 0  # >0: gradient-accumulation microbatch size
    kv_block: int = 1024  # chunked attention's key block
    q_block: int = 2048  # chunked attention's query block
    bf16_grads: bool = False  # mixed precision: grads computed in bf16

    def __post_init__(self):
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, "
                             f"got {self.remat!r}")


def check_slot(slot: SlotSpec) -> None:
    if (slot.mixer, slot.mlp) not in PORTED_SLOTS:
        raise NotImplementedError(
            f"slot ({slot.mixer!r}, {slot.mlp!r}) is not ported yet; the port "
            f"runs {PORTED_SLOTS} (ROADMAP A11)")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def slot_specs(cfg: ModelConfig, slot: SlotSpec, layers: int) -> Dict[str, Any]:
    la = ("layers",)
    L = (layers,)
    s: Dict[str, Any] = {
        "mixer_norm": ParamSpec(L + (cfg.d_model,), la + ("embed",), init="zeros"),
    }
    if slot.mixer == "mamba":
        s["mixer"] = ssm_lib.ssm_specs(cfg, layers)
    else:
        s["mixer"] = attn.attn_specs(cfg, slot.mixer, layers)
    if cfg.use_post_norm:
        s["mixer_post_norm"] = ParamSpec(L + (cfg.d_model,), la + ("embed",), init="zeros")

    has_mlp = not (slot.mlp == "dense" and cfg.d_ff == 0)
    if has_mlp:
        s["mlp_norm"] = ParamSpec(L + (cfg.d_model,), la + ("embed",), init="zeros")
        if slot.mlp == "dense":
            s["mlp"] = moe_lib.dense_mlp_specs(cfg.d_model, cfg.d_ff, layers)
        elif slot.mlp == "moe":
            s["mlp"] = moe_lib.moe_specs(cfg, layers)
        else:  # moe_dense: arctic — parallel dense residual + MoE
            s["mlp"] = {
                "dense": moe_lib.dense_mlp_specs(cfg.d_model, cfg.d_ff, layers),
                "moe": moe_lib.moe_specs(cfg, layers),
            }
        if cfg.use_post_norm:
            s["mlp_post_norm"] = ParamSpec(L + (cfg.d_model,), la + ("embed",), init="zeros")
    return s


def _mlp_residual(p, h, cfg: ModelConfig):
    if "mlp_norm" not in p:
        return h
    u = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    u = moe_lib.dense_mlp(p["mlp"], u)
    if cfg.use_post_norm:
        u = rms_norm(u, p["mlp_post_norm"], cfg.norm_eps)
    return h + u


# ---------------------------------------------------------------------------
# Forward (full sequence: train / prefill)
# ---------------------------------------------------------------------------


def slot_forward(p, h, positions, cfg: ModelConfig, slot: SlotSpec,
                 run: RunConfig):
    """Returns (h, cache, aux_loss)."""
    check_slot(slot)
    u = rms_norm(h, p["mixer_norm"], cfg.norm_eps)
    u, cache = attn.gqa_forward(p["mixer"], u, positions, cfg, slot.mixer,
                                impl=run.attn_impl, kv_block=run.kv_block,
                                q_block=run.q_block)
    if cfg.use_post_norm:
        u = rms_norm(u, p["mixer_post_norm"], cfg.norm_eps)
    return _mlp_residual(p, h + u, cfg), cache, 0.0


# ---------------------------------------------------------------------------
# Decode (single token, cached)
# ---------------------------------------------------------------------------


def slot_decode(p, h, pos, cache, cfg: ModelConfig, slot: SlotSpec,
                run: RunConfig):
    check_slot(slot)
    u = rms_norm(h, p["mixer_norm"], cfg.norm_eps)
    u, new_cache = attn.gqa_decode(p["mixer"], u, pos, cache, cfg, slot.mixer,
                                   impl=run.attn_impl)
    if cfg.use_post_norm:
        u = rms_norm(u, p["mixer_post_norm"], cfg.norm_eps)
    return _mlp_residual(p, h + u, cfg), new_cache


def slot_cache_specs(cfg: ModelConfig, slot: SlotSpec, layers: int, batch: int,
                     s_max: int, dtype: str = "bfloat16",
                     kv_quant: bool = False):
    check_slot(slot)
    window = attn._window_for(cfg, slot.mixer)
    eff = min(s_max, window) if window else s_max
    return attn.attn_cache_specs(cfg, slot.mixer, layers, batch, eff, dtype,
                                 kv_quant=kv_quant)
