"""The yardstick: the chip's peaks, a training step's model FLOPs and
AdamW's least bytes, all from the configuration file's sizes.

Model FLOPs count the work the model needs, not what the program does:
6 * N * T over the matrix parameters (the tied head counted once, the
embedding lookup not), plus each mixer's sequence work, forward times 3
for forward and backward.  Recompute is not counted.

- causal attention, a layer forward: 2 * 2 * T * (S / 2) * H * head_dim
  (scores and values over the causal half);
- SSD, a layer forward, the Mamba-2 paper's chunked algorithm at chunk
  Q: 2*T*Q*N (C B^T within chunks, shared by the heads) + 2*T*Q*H*P (the
  masked product with x) + 2*T*N*H*P (chunk states) + 2*T*N*H*P (output
  from the states); the state passing between chunks is left out.
"""
from __future__ import annotations

from typing import Dict, Optional

from bench import weights

# published dense peaks of the cards the benchmark knows (NVIDIA's data
# sheet, SXM part, at the full 700 W limit): bf16 on the tensor cores,
# fp32 outside them (the program's fp32 path runs without TF32), HBM
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16_flops": 989e12,
                              "float32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, key: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(key)


def flops_peak(kind: str, config: Dict) -> Optional[float]:
    """The card's peak in the configuration's compute dtype."""
    return peak(kind, config["model"]["dtype"] + "_flops")


def matrix_params(config: Dict) -> int:
    """Parameters that multiply activations: every projection and the
    head (tied: the embedding table once), not norms, conv or biases."""
    m = config["model"]
    V = int(m["vocab_size"])
    n = V * int(m["d_model"])  # the head
    for path, shape, _, _ in weights.layout(config):
        name = path.rsplit("/", 1)[-1]
        if name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                    "w_z", "w_xbc", "w_dt", "w_out"):
            size = 1
            for d in shape:
                size *= d
            n += size
    return n


def mixer_flops_fwd(config: Dict, batch: int, seq: int) -> float:
    """The sequence work of every mixer layer, forward."""
    m = config["model"]
    T, L = batch * seq, int(m["num_layers"])
    if config["mixer"] == "attn":
        return L * 2.0 * 2.0 * T * (seq / 2) * int(m["num_heads"]) \
            * int(m["head_dim"])
    D, N, P = int(m["d_model"]), int(m["ssm_state"]), int(m["ssm_head_dim"])
    H = int(m["ssm_expand"]) * D // P
    Q = min(int(m["ssm_chunk"]), seq)
    return L * (2.0 * T * Q * N + 2.0 * T * Q * H * P + 4.0 * T * N * H * P)


def train_flops(config: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` rows of ``seq``."""
    T = batch * seq
    return 6.0 * matrix_params(config) * T \
        + 3.0 * mixer_flops_fwd(config, batch, seq)


def adamw_bytes(config: Dict) -> float:
    """AdamW's least HBM traffic a step, fp32: p, g, m, v read, p, m, v
    written, and g read once more for the clip's global norm."""
    return 32.0 * weights.count(config)
