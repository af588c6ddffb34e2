"""Plain fp32 reference of the two trained models, written from the
published descriptions and the configuration file, in plain PyTorch.
It imports nothing of the program.

- the dense decoder: token embedding; per layer a pre-norm GQA attention
  with half-split RoPE and a causal softmax, and a pre-norm SwiGLU MLP,
  each added to the residual; a final RMSNorm and the tied head;
- the Mamba-2 stack: per layer a pre-norm Mamba-2 block (input
  projections to z, [x | B | C] and dt; a causal depthwise conv over
  [x | B | C] and SiLU; the SSD in its plain quadratic (masked) form over
  the whole sequence, y_i = sum_{j <= i} (C_i . B_j) exp(sum_{j < r <= i}
  dt_r a) dt_j x_j + D x_i; a gated RMSNorm of y * silu(z); the output
  projection) added to the residual;
- the loss: cross-entropy over the padded vocabulary with the padding
  columns masked, mean over every label.

RMSNorm scales apply as (1 + w), the program's form.  Parameters are a
dict of path -> tensor (layer leaves as lists of per-layer tensors).

``Numerics`` also gives the control, the reference computed in the
precision one step below the configuration's: ``"fp8"`` (for bf16) rounds
to 4 significant bits (fp8 e4m3's mantissa) every tensor the program
holds in bf16 (every matrix product's operands, the residual stream
between layers, the SSD's step sizes and summed log decays); ``"tf32"``
(for fp32 with TF32 off) rounds every matrix product's operands to 11
significant bits (TF32's mantissa).  The rounding is in the forward pass,
with the gradient passed straight through; norms, softmax and the loss
stay fp32 as the program keeps them.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# significant bits kept: (matrix operands, stored tensors); None keeps fp32
KINDS = {"fp32": (None, None), "tf32": (11, None), "fp8": (4, 4)}
# the control of a configuration's compute dtype: one precision below it
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def round_to(x: torch.Tensor, bits) -> torch.Tensor:
    """``x`` rounded to ``bits`` significant bits in the forward pass, the
    gradient passed straight through; -inf (masked entries) kept."""
    if bits is None:
        return x
    m, e = torch.frexp(x.detach())
    r = torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits, e)
    return torch.where(torch.isfinite(x), x + (r - x.detach()), x)


class Numerics:
    def __init__(self, kind: str = "fp32"):
        if kind not in KINDS:
            raise ValueError(kind)
        self.kind = kind
        self.mm_bits, self.store_bits = KINDS[kind]

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return round_to(x, self.store_bits)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return round_to(a, self.mm_bits) @ round_to(b, self.mm_bits)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, theta: float):
    """x (B, S, H, d), positions 0..S-1, the halves rotated as pairs."""
    S, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention_layer(h, p: Dict[str, torch.Tensor], m: Dict, num: Numerics):
    B, S, D = h.shape
    H, KV, hd = int(m["num_heads"]), int(m["num_kv_heads"]), int(m["head_dim"])
    eps = float(m["norm_eps"])
    u = rms_norm(h, p["mixer_norm"], eps)
    q = num.mm(u, p["wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
    k = num.mm(u, p["wk"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    v = num.mm(u, p["wv"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    q, k = rope(q, float(m["rope_theta"])), rope(k, float(m["rope_theta"]))
    rep = H // KV  # query head j reads key/value head j // rep
    q = q.permute(0, 2, 1, 3)
    k = k.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    v = v.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    s = num.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = num.mm(torch.softmax(s, dim=-1), v).permute(0, 2, 1, 3).reshape(
        B, S, H * hd)
    h = h + num.mm(o, p["wo"].reshape(H * hd, D))
    u = rms_norm(h, p["mlp_norm"], eps)
    g = silu(num.mm(u, p["w_gate"])) * num.mm(u, p["w_up"])
    return h + num.mm(g, p["w_down"])


def segsum(x):
    """x (..., L) -> (..., L, L): sum_{j < r <= i} x_r where i >= j, else
    -inf (summed from the masked terms, not as a difference of cumsums)."""
    L = x.shape[-1]
    xx = x[..., None].expand(*x.shape, L)  # [..., r, j] = x_r
    below = torch.ones(L, L, dtype=torch.bool, device=x.device).tril(-1)
    xx = xx.masked_fill(~below, 0.0)
    s = torch.cumsum(xx, dim=-2)
    keep = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def mamba_layer(h, p: Dict[str, torch.Tensor], m: Dict, num: Numerics):
    B, L, D = h.shape
    N, P, W = int(m["ssm_state"]), int(m["ssm_head_dim"]), int(m["ssm_conv_width"])
    DI = int(m["ssm_expand"]) * D
    H = DI // P
    eps = float(m["norm_eps"])
    u = rms_norm(h, p["mixer_norm"], eps)
    z = num.mm(u, p["w_z"])
    xbc = num.mm(u, p["w_xbc"])
    dt_raw = num.mm(u, p["w_dt"])
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pad[:, i: i + L] * p["conv_w"][i] for i in range(W)) + p["conv_b"]
    xbc = silu(conv)
    x = xbc[..., :DI].reshape(B, L, H, P)
    bm, cm = xbc[..., DI: DI + N], xbc[..., DI + N:]
    dt = num.q(F.softplus(dt_raw + p["dt_bias"]))  # (B, L, H)
    a = -torch.exp(p["a_log"])  # (H,)
    decay = torch.exp(num.q(segsum((dt * a).permute(0, 2, 1))))  # (B,H,L,L)
    cb = num.mm(cm, bm.transpose(-1, -2))  # (B, L, L)
    w = cb[:, None] * decay * dt.permute(0, 2, 1)[:, :, None, :]
    y = num.mm(w, x.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)  # (B, L, H, P)
    y = y + x * p["d_skip"][:, None]
    y = rms_norm(y.reshape(B, L, DI) * silu(z), p["gate_norm"], eps)
    return h + num.mm(y, p["w_out"])


def layer_fn(config: Dict):
    return attention_layer if config["mixer"] == "attn" else mamba_layer


def block_nll_sum(config: Dict, params: Dict, tokens, labels,
                  num: Numerics) -> torch.Tensor:
    """Sum of the next-token NLL over the rows ``tokens`` (B, S)."""
    m = config["model"]
    V, L = int(m["vocab_size"]), int(m["num_layers"])
    fn = layer_fn(config)
    h = num.q(params["embed"][tokens])
    prefix = "slots/slot0/"
    names = sorted(k[len(prefix):] for k in params if k.startswith(prefix))
    for i in range(L):
        lp = {n.rsplit("/", 1)[-1]: params[prefix + n][i] for n in names}
        h = checkpoint(lambda x, *vals, keys=tuple(lp): num.q(fn(
            x, dict(zip(keys, vals)), m, num)), h, *lp.values(),
            use_reentrant=False)
    h = rms_norm(h, params["final_norm"], float(m["norm_eps"]))
    logits = num.mm(h, params["embed"].T)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(cols >= V, float("-inf"))
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]
    return nll.sum()


def per_layer(flat: Dict[str, torch.Tensor], n_layers: int) -> Dict:
    """The reference's own parameters: a copy of each leaf, layer leaves
    split into per-layer tensors."""
    out: Dict = {}
    for path, t in flat.items():
        if path.startswith("slots/"):
            out[path] = [t[i].detach().clone().float().requires_grad_()
                         for i in range(n_layers)]
        else:
            out[path] = t.detach().clone().float().requires_grad_()
    return out


def tensors(params: Dict) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for k in sorted(params):
        v = params[k]
        out += v if isinstance(v, list) else [v]
    return out
