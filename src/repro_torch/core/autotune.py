"""The kernel-choice stage of the paper's procedure — the port of the
first stage of ``repro.core.autotune`` ("choosing computation algorithms"):

- :func:`bench_kernels` times every variant of every op in
  ``kernels.ops.TUNABLE_OPS`` (the CUDA kernels against their plain
  versions, the SSD scan at several chunks) and picks the fastest variant
  that runs;
- :func:`choose_conv_algs` is Table 2's choice under Eq. 5: per AlexNet
  conv layer, FFT when its working set fits ``M_bound``, else GEMM;
- :func:`host_microbench` measures achieved matmul FLOP/s and triad
  bandwidth on the device.

The return dicts are the JAX module's.  The rest of ``Session.tune()``
(``TuneResult``, ``Calibration``, ``measure_train_steps``,
``tune_overlap``, ``tune_minibatch``, ``autotune``) needs trainer steps and
waits for the training slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core import memory_model as mm
from repro_torch.kernels import ops
from repro_torch.models.common import resolve_device
from repro_torch.obs.trace import monotonic


def _sync(args) -> None:
    devs = {a.device for a in args if isinstance(a, torch.Tensor)
            and a.device.type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)


def _timeit(fn, *args, repeats: int = 2) -> float:
    """Best-of-``repeats`` wall time of ``fn(*args)`` (seconds), after one
    untimed warm-up call that absorbs the kernel build and first-launch
    costs.  Each call ends in a synchronise of the CUDA device its inputs
    are on (the counterpart of ``jax.block_until_ready``)."""
    fn(*args)
    _sync(args)
    best = math.inf
    for _ in range(max(repeats, 1)):
        t0 = monotonic()
        fn(*args)
        _sync(args)
        best = min(best, monotonic() - t0)
    return best


def host_microbench(*, n: int = 512, copy_mb: int = 32, repeats: int = 3,
                    device="cuda") -> Dict[str, float]:
    """Achieved constants of ``device``: fp32 matmul FLOP/s and
    triad-style bytes/s."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=dev)
    b = torch.randn((n, n), generator=g, device=dev)
    t_mm = _timeit(torch.matmul, a, b, repeats=repeats)
    matmul_flops = 2.0 * n ** 3 / t_mm

    m = max(copy_mb * 2 ** 20 // 4, 1)
    x = torch.ones((m,), device=dev)
    y = torch.full((m,), 2.0, device=dev)
    t_triad = _timeit(lambda u, v: u + 2.0 * v, x, y, repeats=repeats)
    triad_bw = 3.0 * 4.0 * m / t_triad  # 2 reads + 1 write per element
    return {"matmul_flops": matmul_flops, "triad_bw": triad_bw,
            "matmul_n": float(n), "copy_mb": float(copy_mb)}


def bench_kernels(*, seq: int = 128, repeats: int = 2,
                  ssd_chunks: Tuple[int, ...] = (32, 64, 128),
                  device="cuda") -> Dict[str, Dict[str, Any]]:
    """Time every registered variant of every tunable op on ``device`` and
    pick the fastest one that runs.  Each variant runs ``1 + repeats``
    times (one warm-up).

    A variant that cannot execute on these inputs is infeasible, which is
    what the paper's procedure prunes on: the wrappers refuse such inputs
    with ``ValueError`` or ``TypeError`` before launching anything (a chunk
    that does not divide the sequence), and the card may run out of
    memory.  Those are recorded under ``errors``.  Anything else, such as
    a kernel that fails to build or to launch, is a fault and propagates."""
    dev = resolve_device(device)
    out: Dict[str, Dict[str, Any]] = {}
    for op in ops.TUNABLE_OPS:
        inputs = ops.tune_inputs(op, seq=seq, device=dev)
        times: Dict[str, float] = {}
        errors: Dict[str, str] = {}
        for name, fn in ops.tune_candidates(op, ssd_chunks=ssd_chunks).items():
            try:
                times[name] = _timeit(fn, *inputs, repeats=repeats)
            except (ValueError, TypeError, torch.cuda.OutOfMemoryError) as e:
                errors[name] = f"{type(e).__name__}: {e}"
        chosen = min(times, key=times.get) if times else ""
        out[op] = {"chosen": chosen, "times_s": times, "errors": errors,
                   "seq": seq}
    return out


def choose_conv_algs(x_mini: int, m_gpu_bytes: float) -> Dict[str, Any]:
    """Table 2's algorithm choice under Eq. 5: per AlexNet conv layer, FFT
    when its (larger) working set fits ``M_bound``, else GEMM.  The paper's
    premise is that FFT is the faster algorithm whenever it fits — memory
    feasibility *is* the selection rule."""
    budget = mm.m_bound(mm.ALEXNET, x_mini, m_gpu_bytes)
    layers: List[Dict[str, Any]] = []
    for i, (row, paper_ratio) in enumerate(mm.TABLE2_ROWS):
        gemm, fft = mm.conv_alg_memory(x_mini, *row[1:])
        chosen = "fft" if fft <= budget else (
            "gemm" if gemm <= budget else "none")
        layers.append({
            "layer": f"conv{i + 1}", "gemm_bytes": gemm, "fft_bytes": fft,
            "ratio": fft / gemm, "paper_ratio": paper_ratio,
            "chosen": chosen, "feasible": chosen != "none",
        })
    return {"x_mini": x_mini, "m_gpu_bytes": m_gpu_bytes,
            "m_bound_bytes": budget, "layers": layers}
