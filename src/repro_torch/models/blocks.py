"""Block (slot) composition: pre-norm mixer + residual, pre-norm MLP +
residual, optional post-norms — the port of ``repro.models.blocks``.

``slot_specs`` gives the parameter shapes of every slot kind (GQA, SWA,
MLA, Mamba; dense, MoE, and arctic's dense + MoE), so the planner prices
the full architecture of every arch.  Forward, decode and the cache
specs run the slots in ``PORTED_SLOTS``, which every arch of the catalog
uses: GQA (with or without gemma2's sliding window), MLA or Mamba-2
mixers with the dense, MoE or arctic's dense + MoE MLP (each slot
returns its MoE aux loss).  A Mamba slot runs ``models/ssm.py``: its SSD
core on the CUDA scan (``impl="kernel"``) exactly when
``run.attn_impl`` is ``"kernel"``, the serving path, else on the plain
``ssd_chunked`` (JAX's ``"auto"``).  :func:`slot_extend` (chunked
prefill) takes GQA slots only, as JAX's does; ``model.supports_extend``
keeps other stacks on whole-prompt prefill.

With ``run.shard`` (a ``distributed.spmd.ShardContext``) a slot runs as
one rank of the mesh, on its leaves' local shapes: the norms on the
residual's local tokens, the mixer and the MLP between the layout
transitions :func:`spmd.enter` and :func:`spmd.leave` (the identity
without a context), the MoE MLP expert-parallel over ``model``
(``moe.moe_mlp_sharded``, where the rules put ``experts``), decode
attention over sequence-sharded caches, and the Mamba block split over
heads and channels (``ssm.ssm_forward``'s ``ctx``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from repro_torch.configs.base import ModelConfig, SlotSpec
from repro_torch.distributed import spmd
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import spans
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ParamSpec, rms_norm

PORTED_SLOTS = (("attn", "dense"), ("swa", "dense"), ("mla", "dense"),
                ("mla", "moe"), ("attn", "moe"), ("attn", "moe_dense"),
                ("mamba", "dense"), ("mamba", "moe"))
REMATS = ("none", "block")


@dataclass
class RunConfig:
    """Runtime (non-architecture) knobs: the JAX package's.  JAX's
    ``act_sharding``, ``grad_shardings`` and ``logit_sharding`` (GSPMD
    constraints) are the explicit layout a ``shard`` context runs
    (``distributed.spmd``), and ``moe_mesh``/``moe_axis`` are that
    context's expert parallelism over ``model``, where the rules put the
    experts; ``unroll_layers`` has no counterpart, since
    an eager trace counts every layer; ``cache_scatter`` has none either,
    since the port writes caches by index."""

    attn_impl: str = "dense"  # dense | chunked | auto | kernel (JAX's pallas)
    remat: str = "block"  # none | block (recompute each cycle in backward)
    microbatch: int = 0  # >0: gradient-accumulation microbatch size
    kv_block: int = 1024  # chunked attention's key block
    q_block: int = 2048  # chunked attention's query block
    bf16_grads: bool = False  # mixed precision: grads computed in bf16
    capacity_factor: float = 1.25  # MoE per-expert capacity factor
    # one rank of a mesh (distributed.spmd.ShardContext); None: one device
    shard: Any = None

    def __post_init__(self):
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, "
                             f"got {self.remat!r}")


def check_slot(slot: SlotSpec) -> None:
    """Raise ``ValueError`` for a slot no arch of the catalog uses."""
    if (slot.mixer, slot.mlp) not in PORTED_SLOTS:
        raise ValueError(
            f"slot ({slot.mixer!r}, {slot.mlp!r}): no config uses it; the "
            f"port runs {PORTED_SLOTS}")


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


def _ssm_impl(run: RunConfig) -> str:
    """The Mamba core's algorithm: the CUDA scan on the serving path
    (``attn_impl="kernel"``), else the plain chunked scan."""
    return "kernel" if run.attn_impl == "kernel" else "auto"


def _mixer_partial(p, cfg: ModelConfig, slot: SlotSpec) -> bool:
    """Whether a mixer's output is a partial sum over ``model`` (its q
    heads or inner channels split); replicated attention computes all of
    it."""
    if slot.mixer == "mamba":
        return True  # w_out's rows split on inner
    w = p["wq_up"] if slot.mixer.startswith("mla") else p["wq"]
    return w.shape[-2] != cfg.num_heads


def _mixer_forward(p, h, positions, cfg: ModelConfig, slot: SlotSpec,
                   run: RunConfig):
    ctx = run.shard
    if slot.mixer == "mamba":
        return ssm_lib.ssm_forward(p, h, positions, cfg, impl=_ssm_impl(run),
                                   ctx=ctx)
    kw = dict(impl=run.attn_impl, kv_block=run.kv_block,
              q_block=run.q_block)
    if slot.mixer.startswith("mla"):
        return attn.mla_forward(p, h, positions, cfg, slot.mixer, **kw)
    h_loc = p["wq"].shape[-2]
    off = 0 if h_loc == cfg.num_heads else ctx.index("model") * h_loc
    return attn.gqa_forward(p, h, positions, cfg, slot.mixer, head_offset=off,
                            **kw)


def _mlp_forward(p, h, cfg: ModelConfig, slot: SlotSpec, run: RunConfig,
                 seq: bool = False):
    """(out, aux): aux is 0.0 for the dense MLP.  Under ``run.shard`` the
    dense MLP is ff-sharded between ``enter`` and ``leave`` and the MoE
    expert-parallel over the rank's groups; ``seq``: ``h`` is the
    residual's sequence shard (else all of this rank's tokens)."""
    ctx = run.shard

    def dense(pd, x):
        return spmd.leave(moe_lib.dense_mlp(pd, spmd.enter(x, ctx, seq)),
                          ctx, seq)

    def moe(pm):
        if ctx is None:
            return moe_lib.moe_mlp(pm, h, cfg,
                                   capacity_factor=run.capacity_factor)
        return moe_lib.moe_mlp_sharded(pm, h, cfg, mesh=ctx,
                                       capacity_factor=run.capacity_factor,
                                       seq_sharded=seq)

    if slot.mlp == "dense":
        return dense(p, h), 0.0
    if slot.mlp == "moe":
        return moe(p)
    # moe_dense: arctic's dense residual MLP in parallel with the MoE
    y_moe, aux = moe(p["moe"])
    return dense(p["dense"], h) + y_moe, aux


def _mlp_residual(p, h, cfg: ModelConfig, slot: SlotSpec, run: RunConfig,
                  seq: bool = False):
    if "mlp_norm" not in p:
        return h, 0.0
    u = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    u, aux = spans.layer(
        "model/mlp", lambda x: _mlp_forward(p["mlp"], x, cfg, slot, run, seq),
        u)
    if cfg.use_post_norm:
        u = rms_norm(u, p["mlp_post_norm"], cfg.norm_eps)
    return h + u, aux


# ---------------------------------------------------------------------------
# Forward (full sequence: train / prefill)
# ---------------------------------------------------------------------------


def slot_forward(p, h, positions, cfg: ModelConfig, slot: SlotSpec,
                 run: RunConfig):
    """Returns (h, cache, aux_loss).  Under ``run.shard`` ``h`` is this
    rank's (B/dp, S/tp, D) residual shard under sequence parallelism (its
    (B/dp, S, D) rows, replicated over ``model``, without it),
    ``positions`` the whole sequence's, and an attention slot's caches
    come out as this rank's ``kv_seq`` slice."""
    check_slot(slot)
    ctx = run.shard
    seq = ctx is not None and ctx.seq_parallel
    partial = _mixer_partial(p["mixer"], cfg, slot)
    u = rms_norm(h, p["mixer_norm"], cfg.norm_eps)
    u, cache = spans.layer(
        "model/mixer",
        lambda x: _mixer_forward(p["mixer"], x, positions, cfg, slot, run),
        spmd.enter(u, ctx, seq, partial))
    u = spmd.leave(u, ctx, seq, partial=partial)
    if ctx is not None and slot.mixer != "mamba":
        cache = {k: spmd.local_seq(v, ctx) for k, v in cache.items()}
    if cfg.use_post_norm:
        u = rms_norm(u, p["mixer_post_norm"], cfg.norm_eps)
    h, aux = _mlp_residual(p, h + u, cfg, slot, run, seq)
    return h, cache, aux


# ---------------------------------------------------------------------------
# Decode (single token, cached)
# ---------------------------------------------------------------------------


def slot_decode(p, h, pos, cache, cfg: ModelConfig, slot: SlotSpec,
                run: RunConfig, s_max: Optional[int] = None):
    """``s_max``: the length the caches were placed for (a GQA slot's
    decode route, ``attention.decode_impl``).  Under ``run.shard`` ``h``
    (B/dp, 1, D) is replicated over ``model`` and the attention caches
    are this rank's sequence slices."""
    check_slot(slot)
    ctx = run.shard
    u = rms_norm(h, p["mixer_norm"], cfg.norm_eps)
    mla = slot.mixer.startswith("mla")
    if slot.mixer == "mamba":
        u, new_cache = ssm_lib.ssm_decode(p["mixer"], u, pos, cache, cfg, ctx)
        for k, v in new_cache.items():  # in place, as the attention writes
            cache[k].copy_(v)
        new_cache = cache
    elif ctx is not None:
        fn = attn.mla_decode_sharded if mla else attn.gqa_decode_sharded
        u, new_cache = fn(p["mixer"], u, pos, cache, cfg, slot.mixer, ctx)
    elif mla:
        u, new_cache = attn.mla_decode(p["mixer"], u, pos, cache, cfg,
                                       slot.mixer, impl=run.attn_impl)
    else:
        u, new_cache = attn.gqa_decode(p["mixer"], u, pos, cache, cfg,
                                       slot.mixer, impl=run.attn_impl,
                                       s_max=s_max)
    if cfg.use_post_norm:
        u = rms_norm(u, p["mixer_post_norm"], cfg.norm_eps)
    h, _ = _mlp_residual(p, h + u, cfg, slot, run)
    return h, new_cache


# ---------------------------------------------------------------------------
# Extend (multi-token cache append: chunked prefill)
# ---------------------------------------------------------------------------


def _mixer_extend(p, h, pos0, cache, cfg: ModelConfig, slot: SlotSpec):
    if slot.mixer == "mamba" or slot.mixer.startswith("mla"):
        raise NotImplementedError(
            f"chunked prefill is attention-only; {slot.mixer!r} slots use "
            f"whole-prompt prefill (model.supports_extend gates this)")
    return attn.gqa_extend(p, h, pos0, cache, cfg, slot.mixer)


def slot_extend(p, h, pos0, cache, cfg: ModelConfig, slot: SlotSpec,
                run: RunConfig):
    """slot_decode's multi-token sibling: h (B,C,D), pos0 (B,) chunk
    start; the cache is written in place.  Returns (h, cache)."""
    check_slot(slot)
    u = rms_norm(h, p["mixer_norm"], cfg.norm_eps)
    u, new_cache = _mixer_extend(p["mixer"], u, pos0, cache, cfg, slot)
    if cfg.use_post_norm:
        u = rms_norm(u, p["mixer_post_norm"], cfg.norm_eps)
    h, _ = _mlp_residual(p, h + u, cfg, slot, run)
    return h, new_cache


def slot_cache_specs(cfg: ModelConfig, slot: SlotSpec, layers: int, batch: int,
                     s_max: int, dtype: str = "bfloat16",
                     kv_quant: bool = False):
    check_slot(slot)
    if slot.mixer == "mamba":
        return ssm_lib.ssm_cache_specs(cfg, layers, batch, dtype)
    window = attn._window_for(cfg, slot.mixer)
    eff = min(s_max, window) if window else s_max
    quant = kv_quant and not slot.mixer.startswith("mla")  # MLA stays bf16
    return attn.attn_cache_specs(cfg, slot.mixer, layers, batch, eff, dtype,
                                 kv_quant=quant)
