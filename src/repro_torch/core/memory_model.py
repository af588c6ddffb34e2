"""Memory model — the port of Part 1 of ``repro.core.memory_model``: the
paper's CNN model, implemented VERBATIM from Eqs. (1)-(5): feature-map
memory ``M_FM``, model parameters ``M_MP`` (gradients = 2x params),
classifier ``M_C``, and the budget ``M_bound = M_GPU - M_FM - M_MP - M_C``.
Includes the AlexNet definition and the GEMM/FFT per-layer memory models
that reproduce Table 2.

Part 2 of the JAX module (the transformer generalization the planner uses)
is not ported yet: it needs the planner and the training slice.  The JAX
module imports ``repro.models.model`` at module level, so this is a copy,
not an import.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

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
