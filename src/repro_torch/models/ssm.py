"""Mamba-2 SSD (state-space duality) mixer — the port of
``repro.models.ssm``: the chunked-scan reference in plain PyTorch, the O(1)
single-token decode, and the block forward, whose ``impl="kernel"`` runs
the SSD core on the CUDA kernel (``kernels/ops.py::ssd_scan``).

Block: in_proj -> [z | x | B | C | dt]; causal depthwise conv over (x,B,C);
SSD core y = SSD(a, dt*Bx, C) + D*x; gated RMSNorm(y * silu(z)); out_proj.
Group count G=1 (B/C shared across heads), as in Mamba-2 defaults.

With ``ctx`` (a ``distributed.spmd.ShardContext``) :func:`ssm_forward`
and :func:`ssm_decode` run the block as one rank of a mesh, with the
rules' split over ``model``: ``w_z``, ``gate_norm`` and ``w_out``'s rows
on ``inner``, the fused x/B/C projection, its depthwise conv and the
conv cache on ``conv_ch`` (contiguous columns of [x | B | C]), and
``w_dt``, ``a_log``, ``dt_bias``, ``d_skip`` and the state on
``ssm_heads``.  The conv runs on the local channels; the activated
channels are all-gathered, each rank takes its heads' x columns and the
whole B and C, runs the SSD on its heads, normalises the gated output
with the mean of squares averaged over ``model``, and ``w_out`` gives a
partial sum over ``model``.

``ssd_chunked`` computes in the input's dtype, as JAX does (the log decay
and its cumsum in x's dtype, the carried state in fp32 and cast back to
x's dtype for the output term); the kernel and ``ref.ssd_scan_ref``
compute in fp32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, rms_norm, swish


def ssm_specs(cfg: ModelConfig, layers: int) -> Dict[str, ParamSpec]:
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W = cfg.ssm_conv_width
    conv_ch = DI + 2 * N  # x, B, C share the conv
    L = (layers,)
    la = ("layers",)
    return {
        "w_z": ParamSpec(L + (D, DI), la + ("embed", "inner")),
        "w_xbc": ParamSpec(L + (D, DI + 2 * N), la + ("embed", "conv_ch")),
        "w_dt": ParamSpec(L + (D, H), la + ("embed", "ssm_heads")),
        "conv_w": ParamSpec(L + (W, conv_ch), la + (None, "conv_ch"), scale=3.0),
        "conv_b": ParamSpec(L + (conv_ch,), la + ("conv_ch",), init="zeros"),
        "a_log": ParamSpec(L + (H,), la + ("ssm_heads",), init="ssm_a"),
        "dt_bias": ParamSpec(L + (H,), la + ("ssm_heads",), init="ssm_dt"),
        "d_skip": ParamSpec(L + (H,), la + ("ssm_heads",), init="ones"),
        "gate_norm": ParamSpec(L + (DI,), la + ("inner",), init="zeros"),
        "w_out": ParamSpec(L + (DI, D), la + ("inner", "embed")),
    }


# ---------------------------------------------------------------------------
# SSD core — chunked reference
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, a_neg, b_mat, c_mat, chunk: int, h0=None):
    """SSD over a full sequence, chunked.

    x      (B, L, H, P)   per-head inputs
    dt     (B, L, H)      softplus'd step sizes (>=0)
    a_neg  (H,)           negative continuous-time decay (-exp(a_log))
    b_mat  (B, L, N)      input projection onto state  (G=1, shared over heads)
    c_mat  (B, L, N)      state readout
    h0     (B, H, N, P)   optional initial state
    returns y (B, L, H, P), h_final (B, H, N, P) fp32
    """
    B, L, H, P = x.shape
    N = b_mat.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd_chunked: L={L} is not a multiple of chunk {Q}")
    nc = L // Q

    loga = dt * a_neg  # (B, L, H) log per-step decay, <= 0
    xr = x.reshape(B, nc, Q, H, P)
    dtr = dt.reshape(B, nc, Q, H)
    br = b_mat.reshape(B, nc, Q, N)
    cr = c_mat.reshape(B, nc, Q, N)

    cl = torch.cumsum(loga.reshape(B, nc, Q, H), dim=2)  # inclusive
    # intra-chunk: Lmat[i,j,h] = exp(cl_i - cl_j) for i >= j, masked
    # before the exp (cl_i - cl_j > 0 above the diagonal can overflow)
    diff = cl[:, :, :, None, :] - cl[:, :, None, :, :]  # (B,nc,Q(i),Q(j),H)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)  # (B,nc,Q,Q)
    w = cb[..., None] * lmat * dtr[:, :, None, :, :]  # (B,nc,i,j,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xr)

    # chunk-final partial states: S_c = sum_j exp(cl_Q - cl_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cl[:, :, -1:, :] - cl)  # (B,nc,Q,H)
    sx = xr * (decay_to_end * dtr)[..., None]  # (B,nc,Q,H,P)
    s_chunk = torch.einsum("bcjn,bcjhp->bchnp", br, sx)  # (B,nc,H,N,P)

    # inter-chunk recurrence, in fp32 (JAX's lax.scan)
    chunk_decay = torch.exp(cl[:, :, -1, :]).float()  # (B,nc,H)
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    starts = []
    for ci in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + s_chunk[:, ci].float()
    h_prev = torch.stack(starts, dim=1).to(x.dtype)  # (B,nc,H,N,P)

    # inter-chunk contribution: y_i += exp(cl_i) * C_i . h_chunk_start
    decay_from_start = torch.exp(cl)  # (B,nc,Q,H)
    y_inter = torch.einsum("bcin,bchnp->bcihp", cr, h_prev) \
        * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(B, L, H, P)
    return y, h


def ssd_step(h, x_t, dt_t, a_neg, b_t, c_t):
    """Single-token SSD update.
    h (B,H,N,P), x_t (B,H,P), dt_t (B,H), b_t (B,N), c_t (B,N)."""
    dec = torch.exp(dt_t * a_neg)  # (B,H)
    inject = torch.einsum("bn,bhp->bhnp", b_t, x_t * dt_t[..., None])
    h = h * dec[..., None, None] + inject
    y = torch.einsum("bn,bhnp->bhp", c_t, h)
    return y, h


# ---------------------------------------------------------------------------
# Mixer forward / decode
# ---------------------------------------------------------------------------


def _project(p, x):
    return x @ p["w_z"], x @ p["w_xbc"], x @ p["w_dt"]


def _dt_a(p, dt_raw, dtype):
    dt = F.softplus(dt_raw.float() + p["dt_bias"]).to(dtype)
    a_neg = -torch.exp(p["a_log"].float()).to(dtype)
    return dt, a_neg


def _split_xbc(xbc, p, cfg: ModelConfig, ctx):
    """(x of this rank's heads, B, C) from the activated [x | B | C]
    channels.  Under ``ctx`` the rank holds a contiguous slice of them,
    all-gathered over ``model`` first (backward: reduce-scatter)."""
    DI, N = cfg.d_inner, cfg.ssm_state
    width = p["a_log"].shape[0] * cfg.ssm_head_dim
    lo = 0
    if ctx is not None:
        xbc = spmd.gather_dim(xbc, ctx.group("model"), xbc.dim() - 1)
        lo = ctx.index("model") * width
    return (xbc[..., lo: lo + width], xbc[..., DI: DI + N],
            xbc[..., DI + N:])


def _gated_norm(y, z, p, cfg: ModelConfig, ctx):
    """The gated RMSNorm over the whole inner dim, of which ``y`` and
    ``z`` hold this rank's columns under ``ctx``."""
    g = None if ctx is None else ctx.group("model")
    return rms_norm(y * swish(z), p["gate_norm"], cfg.norm_eps,
                    mean_of=None if g is None
                    else (lambda v: spmd.psum_mean(v, g)))


def ssm_forward(p, x, positions, cfg: ModelConfig, *, impl="auto", ctx=None):
    """Full-sequence mamba2 block.  Returns (out, cache) with the final
    state cache.  ``impl="kernel"`` (the counterpart of JAX's ``pallas``)
    runs the SSD core through ``ops.ssd_scan``; anything else through
    :func:`ssd_chunked`.  Under ``ctx`` ``x`` is the whole sequence,
    replicated over ``model``; ``out`` is a partial sum over ``model``
    and the cache holds this rank's heads and conv channels."""
    B, L, D = x.shape
    P, W = cfg.ssm_head_dim, cfg.ssm_conv_width
    H = p["a_log"].shape[0]  # this rank's heads

    z, xbc_raw, dt_raw = _project(p, x)

    # causal depthwise conv over (x,B,C) channels
    pad = F.pad(xbc_raw, (0, 0, W - 1, 0))
    conv = sum(pad[:, i: i + L] * p["conv_w"][i][None, None]
               for i in range(W)) + p["conv_b"][None, None]
    xs, b_mat, c_mat = _split_xbc(swish(conv), p, cfg, ctx)
    xs = xs.reshape(B, L, H, P)
    dt, a_neg = _dt_a(p, dt_raw, x.dtype)

    if impl == "kernel":
        y, h_fin = kops.ssd_scan(xs, dt, a_neg, b_mat, c_mat,
                                 chunk=cfg.ssm_chunk)
    else:
        y, h_fin = ssd_chunked(xs, dt, a_neg, b_mat, c_mat, cfg.ssm_chunk)
    y = y + xs * p["d_skip"][None, None, :, None]
    y = _gated_norm(y.reshape(B, L, H * P), z, p, cfg, ctx)
    out = y @ p["w_out"]
    # conv tail: last W-1 *pre-activation* (x,B,C) values, for decode
    cache = {"state": h_fin, "conv": pad[:, L:]}
    return out, cache


def ssm_decode(p, x, pos, cache, cfg: ModelConfig, ctx=None):
    """Single-token mamba2 step. cache: state (B,H,N,P), conv (B,W-1,conv_ch).
    Under ``ctx`` ``x`` is replicated over ``model``, the state holds this
    rank's heads and the conv tail its channels; the output is
    all-reduced over ``model``."""
    B = x.shape[0]
    P = cfg.ssm_head_dim
    H = p["a_log"].shape[0]

    z, xbc_new, dt_raw = _project(p, x[:, 0])

    hist = torch.cat([cache["conv"], xbc_new[:, None]], dim=1)  # (B,W,ch)
    conv = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    x_t, b_t, c_t = _split_xbc(swish(conv), p, cfg, ctx)
    x_t = x_t.reshape(B, H, P)
    dt, a_neg = _dt_a(p, dt_raw, x.dtype)

    y, h = ssd_step(cache["state"], x_t, dt, a_neg, b_t, c_t)
    y = y + x_t * p["d_skip"][None, :, None]
    y = _gated_norm(y.reshape(B, H * P), z, p, cfg, ctx)
    out = (y @ p["w_out"])[:, None]
    if ctx is not None:
        out = spmd.reduce_from(out, ctx.group("model"))
    return out, {"state": h, "conv": hist[:, 1:]}


def ssm_cache_specs(cfg: ModelConfig, layers: int, batch: int,
                    dtype: str = "bfloat16"):
    N, H, P = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_ch = cfg.d_inner + 2 * N
    W = cfg.ssm_conv_width
    return {
        "state": ParamSpec((layers, batch, H, N, P),
                           ("layers", "batch", "ssm_heads", None, None),
                           dtype=dtype, init="zeros"),
        "conv": ParamSpec((layers, batch, W - 1, conv_ch),
                          ("layers", "batch", None, "conv_ch"),
                          dtype=dtype, init="zeros"),
    }

