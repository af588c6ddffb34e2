"""Memory models (the port of ``repro.core.memory_model``).

Part 1 — the paper's CNN model, implemented VERBATIM from Eqs. (1)-(5):
feature-map memory ``M_FM``, model parameters ``M_MP`` (gradients = 2x
params), classifier ``M_C``, and the budget
``M_bound = M_GPU - M_FM - M_MP - M_C``. Includes the AlexNet definition
and the GEMM/FFT per-layer memory models that reproduce Table 2.

Part 2 — the transformer generalization the planner uses: params, grads,
optimizer state, remat-dependent saved activations, logits, KV cache.
All byte counts are *totals*; the planner divides by the sharding degrees.
It counts the optimizer state as sharded over the data axis (ZeRO-1), as
the JAX package's GSPMD trainer keeps it; the port's data-parallel
trainer replicates it on every rank, so on the card a plan's
``est_memory_gb`` is below what the port's step holds.

Part 3 — serving's memory bound (Eq. 5 for the paged KV cache).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.common import param_count

BITS = 32  # the paper assumes fp32 everywhere


# ---------------------------------------------------------------------------
# Part 1 — faithful CNN model (Eqs. 1-5)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvLayer:
    kind: str  # "conv" | "pool"
    f: int  # filter size F_i
    s: int  # stride S_i
    p: int  # padding P_i
    k: int  # num filters K_i (0 for pooling, per the paper's convention)


@dataclass(frozen=True)
class CNN:
    input_bhd: Tuple[int, int, int]  # (B_0, H_0, D_0)
    features: Tuple[ConvLayer, ...]
    fc: Tuple[int, ...]  # L_j neuron counts, incl. the first FC input? no —
    # L_j are the FC layer widths; the flattened feature size feeds L_1.


def feature_shapes(cnn: CNN) -> List[Tuple[int, int, int]]:
    """Apply Eq. (1) through the feature extractor; returns [(B_i,H_i,D_i)]."""
    shapes = [cnn.input_bhd]
    b, h, d = cnn.input_bhd
    for layer in cnn.features:
        b = (b - layer.f + 2 * layer.p) // layer.s + 1
        h = (h - layer.f + 2 * layer.p) // layer.s + 1
        d = layer.k if layer.kind == "conv" else d
        shapes.append((b, h, d))
    return shapes


def m_fm(cnn: CNN, x_mini: int) -> float:
    """Eq. (2): input + all feature maps, bits."""
    return sum(b * h * d * x_mini * BITS for b, h, d in feature_shapes(cnn))


def m_mp(cnn: CNN) -> float:
    """Eq. (3): conv weights+biases, x3 (params + 2x gradients), bits."""
    shapes = feature_shapes(cnn)
    total = 0.0
    for i, layer in enumerate(cnn.features):
        if layer.kind != "conv":
            continue
        d_in = shapes[i][2]
        total += layer.f * layer.f * d_in * layer.k * 3 * BITS  # weights
        total += layer.k * 3 * BITS  # biases
    return total


def m_c(cnn: CNN) -> float:
    """Eq. (4): classifier outputs + weights (+2x grads) + biases."""
    out_bits = sum(l * BITS for l in cnn.fc)
    w_bits = sum(
        cnn.fc[j] * cnn.fc[j + 1] * 3 * BITS for j in range(len(cnn.fc) - 1)
    )
    b_bits = (len(cnn.fc) - 1) * 3 * BITS
    return out_bits + w_bits + b_bits


def m_bound(cnn: CNN, x_mini: int, m_gpu_bytes: float) -> float:
    """Eq. (5), returned in BYTES.  Negative when ``x_mini`` is infeasible
    on a device with ``m_gpu_bytes`` of memory."""
    used_bits = m_fm(cnn, x_mini) + m_mp(cnn) + m_c(cnn)
    return m_gpu_bytes - used_bits / 8.0


def max_x_mini(cnn: CNN, m_gpu_bytes: float, *, x_max: int = 1 << 20) -> int:
    """The paper's minibatch procedure, step 1: the largest ``X_mini`` with
    ``M_bound >= 0`` (Eq. 5), found by binary search — ``m_fm`` is linear in
    ``X_mini`` so feasibility is monotone.  Returns 0 when not even
    ``X_mini = 1`` fits (the model alone exceeds device memory)."""
    if m_bound(cnn, 1, m_gpu_bytes) < 0:
        return 0
    lo, hi = 1, 2
    while hi <= x_max and m_bound(cnn, hi, m_gpu_bytes) >= 0:
        lo, hi = hi, hi * 2
    hi = min(hi, x_max)
    while lo + 1 < hi:  # invariant: lo feasible, hi infeasible (or > x_max)
        mid = (lo + hi) // 2
        if m_bound(cnn, mid, m_gpu_bytes) >= 0:
            lo = mid
        else:
            hi = mid
    if hi == x_max and m_bound(cnn, hi, m_gpu_bytes) >= 0:
        return x_max
    return lo


# AlexNet feature extractor (paper Table 2 parameters) + classifier
ALEXNET = CNN(
    input_bhd=(224, 224, 3),
    features=(
        ConvLayer("conv", 11, 4, 2, 96),    # -> 55x55x96
        ConvLayer("pool", 3, 2, 0, 0),      # -> 27x27x96
        ConvLayer("conv", 5, 1, 2, 256),    # -> 27x27x256
        ConvLayer("pool", 3, 2, 0, 0),      # -> 13x13x256
        ConvLayer("conv", 3, 1, 1, 384),    # -> 13x13x384
        ConvLayer("conv", 3, 1, 1, 384),    # -> 13x13x384
        ConvLayer("conv", 3, 1, 1, 256),    # -> 13x13x256
        ConvLayer("pool", 3, 2, 0, 0),      # -> 6x6x256
    ),
    fc=(9216, 4096, 4096, 1000),
)


def conv_alg_memory(x_mini: int, bi: int, hi: int, bo: int, ho: int,
                    d_in: int, d_out: int, f: int) -> Tuple[float, float]:
    """(GEMM_bytes, FFT_bytes) for one conv layer — the Table-2 model.

    GEMM (tiled/implicit cuDNN lowering): input + output + filters.
    FFT: everything lives at the *padded* input resolution (filters are
    padded to the input size; feature maps transformed in place).
    """
    by = BITS // 8
    gemm = (x_mini * d_in * bi * hi + x_mini * d_out * bo * ho
            + f * f * d_in * d_out) * by
    fft = (x_mini * d_in + x_mini * d_out + d_in * d_out) * bi * hi * by
    return gemm, fft


# Paper Table 2 rows: (X_mini, B_i, H_i, B_o, H_o, D_i, D_o, F) and ratio
TABLE2_ROWS = [
    ((128, 224, 224, 55, 55, 3, 96, 11), 11.6),
    ((128, 27, 27, 27, 27, 96, 256, 5), 1.6),
    ((128, 13, 13, 13, 13, 256, 384, 3), 2.3),
    ((128, 13, 13, 13, 13, 384, 384, 3), 2.7),
    ((128, 13, 13, 13, 13, 384, 256, 3), 2.3),
]


# ---------------------------------------------------------------------------
# Part 2 — transformer memory model (per-chip, given sharding degrees)
# ---------------------------------------------------------------------------


@dataclass
class TransformerMemory:
    params: float
    grads: float
    opt_state: float
    activations: float
    logits: float
    kv_cache: float

    @property
    def total(self) -> float:
        return (self.params + self.grads + self.opt_state + self.activations
                + self.logits + self.kv_cache)


def n_params(cfg: ModelConfig) -> int:
    return param_count(M.model_specs(cfg))


def n_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k + shared of the routed experts)."""
    total = n_params(cfg)
    if not cfg.has_moe:
        return total
    # routed expert params across the stack
    moe_layers = sum(
        1 for s in cfg.pattern for _ in range(1)
        if s.mlp in ("moe", "moe_dense")
    ) * M.main_cycles(cfg)
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    routed = moe_layers * cfg.num_experts * per_expert
    active_routed = moe_layers * cfg.top_k * per_expert
    return total - routed + active_routed


def train_memory(cfg: ModelConfig, shape: ShapeConfig, *, dp: int, tp: int,
                 fsdp: bool, microbatch: int, attn_impl: str,
                 remat: str, seq_parallel: bool,
                 opt_kind: str = "adamw", pipe: int = 1,
                 n_microbatch: int = 0) -> TransformerMemory:
    """Per-chip bytes for one training step.

    With ``pipe > 1`` the stack is cut into ``pipe`` contiguous stage
    groups: params/grads/opt shrink by ``pipe`` (each chip holds one
    stage), the per-microbatch activation slice is ``B_rep / m`` rows, and
    the 1F1B schedule keeps ``min(pipe - s, m)`` microbatches in flight on
    stage ``s`` — this returns the stage-0 worst case (the KC107 contract
    checks every stage via :func:`stage_activation_bytes`).  ``dp`` is the
    data-parallel degree only; pass ``world // (tp * pipe)`` for a fixed
    chip budget."""
    N = n_params(cfg)
    chips = dp * tp
    p_shard = chips if fsdp else tp
    pipe = max(int(pipe), 1)
    params = (2 * N / p_shard + 4 * N / chips) / pipe  # bf16 + fp32 master
    grads = 4 * N / p_shard / pipe
    opt_per = {"adamw": 8, "momentum": 4}[opt_kind]
    opt_state = opt_per * N / chips / pipe  # ZeRO-1: always fully sharded

    B_rep = max(shape.global_batch // dp, 1)
    if pipe > 1:
        m = max(int(n_microbatch) or pipe, pipe)
        mb = max((microbatch or B_rep) // m, 1)
        in_flight = min(pipe, m)  # stage 0 holds the most under 1F1B
    else:
        mb = microbatch or B_rep
        in_flight = 1
    S = shape.seq_len
    D = cfg.d_model
    seq_shard = tp if seq_parallel else 1

    n_saved = cfg.num_layers if remat == "block" else 4 * cfg.num_layers
    n_saved /= pipe  # each stage saves only its own layers' activations
    activations = n_saved * mb * S * D * 2 / seq_shard * in_flight
    # live working set inside one block (attention blocks, mlp ff transient)
    ff = max(cfg.d_ff, cfg.moe_d_ff)
    work = mb * S * max(ff // tp, D) * 2 * 4 / seq_shard
    if attn_impl == "dense":
        heads_shard = tp if (cfg.num_heads % tp == 0) else 1
        work += 4 * mb * (cfg.num_heads / heads_shard) * S * S / seq_shard
    activations += work

    logits = mb * S * cfg.padded_vocab * 4 * 2 / tp / seq_shard  # f32 + grad
    return TransformerMemory(params, grads, opt_state, activations, logits, 0.0)


def stage_activation_bytes(cfg: ModelConfig, shape: ShapeConfig, *, dp: int,
                           tp: int, pipe: int, n_microbatch: int, stage: int,
                           stage_cycles: int, attn_impl: str, remat: str,
                           seq_parallel: bool) -> float:
    """Per-chip activation working set of pipeline stage ``stage`` under
    1F1B — the Eq.-5 feasibility term the KC107 contract prices: saved
    activations for the stage's ``stage_cycles`` layer cycles times its
    in-flight microbatch count ``min(pipe - stage, m)``, plus one live
    block working set, plus the logits buffer on the last stage."""
    pipe = max(int(pipe), 1)
    m = max(int(n_microbatch) or pipe, pipe)
    if not 0 <= stage < pipe:
        raise ValueError(f"stage {stage} outside [0, {pipe})")
    B_rep = max(shape.global_batch // dp, 1)
    mb = max(B_rep // m, 1)
    S, D = shape.seq_len, cfg.d_model
    seq_shard = tp if seq_parallel else 1
    in_flight = min(pipe - stage, m)

    layers = stage_cycles * max(len(cfg.pattern), 1)
    n_saved = layers if remat == "block" else 4 * layers
    act = n_saved * mb * S * D * 2 / seq_shard * in_flight
    ff = max(cfg.d_ff, cfg.moe_d_ff)
    act += mb * S * max(ff // tp, D) * 2 * 4 / seq_shard
    if attn_impl == "dense":
        heads_shard = tp if (cfg.num_heads % tp == 0) else 1
        act += 4 * mb * (cfg.num_heads / heads_shard) * S * S / seq_shard
    if stage == pipe - 1:
        act += mb * S * cfg.padded_vocab * 4 * 2 / tp / seq_shard
    return act


def max_microbatch(cfg: ModelConfig, shape: ShapeConfig, *, dp: int, tp: int,
                   fsdp: bool, attn_impl: str, remat: str,
                   seq_parallel: bool, hbm_bytes: float,
                   opt_kind: str = "adamw", frac: float = 0.9) -> int:
    """The paper's minibatch procedure on the transformer memory model: the
    largest microbatch in ``[1, B/dp]`` whose :func:`train_memory` total
    stays under ``frac * hbm_bytes`` — activations/logits are linear in the
    microbatch, so feasibility is monotone and binary search applies.
    Returns 0 when even microbatch 1 does not fit."""
    budget = frac * hbm_bytes

    def fits(mb: int) -> bool:
        mem = train_memory(cfg, shape, dp=dp, tp=tp, fsdp=fsdp,
                           microbatch=mb, attn_impl=attn_impl, remat=remat,
                           seq_parallel=seq_parallel, opt_kind=opt_kind)
        return mem.total <= budget

    b_rep = max(shape.global_batch // dp, 1)
    if not fits(1):
        return 0
    lo, hi = 1, b_rep
    if fits(hi):
        return hi
    while lo + 1 < hi:  # invariant: lo fits, hi does not
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


def decode_memory(cfg: ModelConfig, shape: ShapeConfig, *, dp: int, tp: int,
                  fsdp: bool, window_override: int = 0) -> TransformerMemory:
    """Per-chip bytes for one decode step with a full cache."""
    N = n_params(cfg)
    chips = dp * tp
    params = 2 * N / (chips if fsdp else tp)
    B, S = shape.global_batch, shape.seq_len
    batch_shard = min(B, dp)
    seq_shard = tp * (dp if B < dp else 1)

    kv = 0.0
    cycles = M.main_cycles(cfg)
    for s in cfg.pattern:
        if s.mixer == "mamba":
            kv += cycles * B * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 2
            kv += cycles * B * (cfg.ssm_conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2
            continue
        win = cfg.sliding_window if s.mixer == "swa" else (window_override or 0)
        s_eff = min(S, win) if win else S
        kv += cycles * B * s_eff * cfg.kv_cache_width * 2
    # cache sharded over batch (dp, when it covers it) and seq (tp [+dp if B<dp])
    kv_per_chip = kv / (batch_shard * seq_shard)
    logits = B / batch_shard * cfg.padded_vocab * 4 / tp
    act = B / batch_shard * cfg.d_model * 2 * 8
    return TransformerMemory(params, 0.0, 0.0, act, logits, kv_per_chip)


# ---------------------------------------------------------------------------
# Part 3 — serving memory bound (Eq. 5 for the paged KV cache)
# ---------------------------------------------------------------------------
# Training sizes the minibatch as the largest x_mini with
# M(x_mini) <= M_bound (Eq. 5 / max_x_mini / max_microbatch).  Serving has
# the same shape: KV blocks are the unit of allocation, so the admission
# bound is the largest block count whose pool fits what is left of HBM
# after weights, per-request recurrent state, and decode workspace.


def kv_token_bytes(cfg: ModelConfig, *, dtype_bytes: int = 2) -> float:
    """Paged-cache bytes per cached token position across the stack
    (attention-like slots; a *paged* cache stores every position linearly,
    so sliding windows don't discount — the window bounds reads, not
    residency)."""
    cycles = M.main_cycles(cfg)
    per = 0.0
    for s in cfg.pattern:
        if s.mixer == "mamba":
            continue
        per += cycles * cfg.kv_cache_width * dtype_bytes
    if cfg.first_k_dense and cfg.pattern[0].mixer != "mamba":
        per += cfg.first_k_dense * cfg.kv_cache_width * dtype_bytes
    return per


def request_state_bytes(cfg: ModelConfig, *, dtype_bytes: int = 2) -> float:
    """Per-request bytes that are NOT paged: Mamba recurrent state and conv
    tail are constant-size per sequence, resident for the whole request."""
    cycles = M.main_cycles(cfg)
    per = 0.0
    for s in cfg.pattern:
        if s.mixer != "mamba":
            continue
        per += cycles * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * dtype_bytes
        per += cycles * (cfg.ssm_conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * dtype_bytes
    return per


def kv_block_bytes(cfg: ModelConfig, block_size: int) -> float:
    """Bytes of one KV block across every paged pool."""
    return block_size * kv_token_bytes(cfg)


def max_kv_blocks(cfg: ModelConfig, hbm_bytes: float, *, block_size: int,
                  max_batch: int = 1, frac: float = 0.9) -> int:
    """Eq. 5 for serving: the largest KV block-pool size that fits.

        n_blocks = floor((frac·HBM − M_params − M_state − M_work) / M_block)

    with bf16 weights resident, ``max_batch`` requests of recurrent state,
    and a decode workspace (f32 logits row + activation slack) per row.
    Returns 0 when even the fixed costs exceed the budget or the config has
    no paged (attention) cache at all.
    """
    bb = kv_block_bytes(cfg, block_size)
    if bb <= 0:
        return 0
    params = 2.0 * n_params(cfg)
    state = max_batch * request_state_bytes(cfg)
    work = max_batch * (cfg.padded_vocab * 4.0 + cfg.d_model * 2.0 * 8)
    bound = frac * hbm_bytes - params - state - work
    return max(int(bound // bb), 0)
