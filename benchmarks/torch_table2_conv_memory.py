"""Paper Table 2 on the port: FFT vs GEMM convolution memory (AlexNet
conv1-5), the transformer analogue (dense vs flash attention memory), and
on a card the measured peak of one attention layer at each algorithm (the
twin of ``benchmarks/table2_conv_memory.py``).

    PYTHONPATH=src python benchmarks/torch_table2_conv_memory.py [--device cpu]

``run(csv_rows)`` gives the JAX script's rows, number for number (pure
arithmetic on the port's ``core/memory_model.py``).  Then, on a card
(``--device cuda``, the default), it measures the peak memory
(``torch.cuda.max_memory_allocated`` over what was allocated before) of
one forward + backward of one full-width granite-3-2b attention layer
(d_model 2048, 32 heads, 8 kv heads, head dim 64; bf16, batch 1) at
``attn_impl="dense"`` and at ``"chunked"``, S = 2048 and 4096, and prints
it beside the formula's dense and flash bytes for the same batch, heads
and length (the formula counts fp32 scores + probs, and one 1024-wide kv
block + stats for flash).  Those rows are named ``attn_mem_measured/``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.core import memory_model as mm  # noqa: E402

SEQS = (2048, 4096)


def dense_bytes(B: int, H: int, S: int) -> float:
    return 2 * B * H * S * S * 4  # scores + probs, fp32


def flash_bytes(B: int, H: int, S: int) -> float:
    return 2 * B * H * S * (1024 + 2) * 4  # one kv block + stats


def run_jax_rows(csv_rows):
    print("\n== Table 2: conv algorithm memory, FFT/GEMM (AlexNet) ==")
    print(f"{'layer':6s} {'paper':>6s} {'ours':>6s} {'rel.err':>8s}")
    errs = []
    for i, (row, paper) in enumerate(mm.TABLE2_ROWS):
        gemm, fft = mm.conv_alg_memory(*row)
        ours = fft / gemm
        err = abs(ours - paper) / paper
        errs.append(err)
        print(f"conv{i+1:<2d} {paper:6.1f} {ours:6.2f} {err:8.1%}")
        csv_rows.append((f"table2/conv{i+1}_ratio", ours, f"paper={paper}"))
    print(f"mean abs rel err: {sum(errs)/len(errs):.1%}")
    csv_rows.append(("table2/mean_rel_err", sum(errs) / len(errs), ""))

    print("\n== transformer analogue: dense vs flash attention memory ==")
    print(f"{'arch':14s} {'shape':12s} {'dense_GB':>9s} {'flash_GB':>9s} {'ratio':>7s}")
    for arch in ("granite-3-2b", "gemma2-27b", "qwen2-72b"):
        cfg = get_config(arch)
        for shape_name in ("train_4k", "prefill_32k"):
            sh = SHAPES[shape_name]
            B = max(sh.global_batch // 16, 1)  # per data-parallel replica
            dense = dense_bytes(B, cfg.num_heads, sh.seq_len)
            flash = flash_bytes(B, cfg.num_heads, sh.seq_len)
            print(f"{arch:14s} {shape_name:12s} {dense/2**30:9.1f} "
                  f"{flash/2**30:9.3f} {dense/flash:7.1f}")
            csv_rows.append((f"attn_mem/{arch}/{shape_name}", dense / flash,
                             "dense/flash"))


def measure_layer(impl: str, S: int, *, device="cuda", B: int = 1) -> float:
    """Peak bytes above the resting allocation of one forward + backward
    of one full-width granite-3-2b attention layer (bf16) at ``impl``."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models.common import materialize

    cfg = get_config("granite-3-2b")
    dev = torch.device(device)
    p = {k: v[0].to(torch.bfloat16).requires_grad_(True)
         for k, v in materialize(A.gqa_specs(cfg, 1), 0, dev).items()}
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, S, cfg.d_model, generator=g, device=dev,
                    dtype=torch.bfloat16, requires_grad=True)
    pos = torch.arange(S, device=dev).expand(B, S)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    y, _ = A.gqa_forward(p, x, pos, cfg, "attn", impl=impl)
    y.float().square().mean().backward()
    if dev.type != "cuda":
        return float("nan")
    torch.cuda.synchronize()
    return float(torch.cuda.max_memory_allocated() - base)


def run_measured(csv_rows, device="cuda"):
    cfg = get_config("granite-3-2b")
    H = cfg.num_heads
    print("\n== measured: one full-width granite-3-2b attention layer, "
          "forward + backward, bf16, batch 1 ==")
    print(f"{'S':>6s} {'impl':>8s} {'peak_GB':>9s} {'formula dense_GB':>17s} "
          f"{'formula flash_GB':>17s}")
    for S in SEQS:
        for impl in ("dense", "chunked"):
            peak = measure_layer(impl, S, device=device)
            print(f"{S:6d} {impl:>8s} {peak/1e9:9.4f} "
                  f"{dense_bytes(1, H, S)/1e9:17.4f} "
                  f"{flash_bytes(1, H, S)/1e9:17.4f}", flush=True)
            csv_rows.append((f"attn_mem_measured/granite-3-2b/S{S}/{impl}",
                             peak, "bytes above resting, max_memory_allocated"))


def run(csv_rows, device="cuda"):
    run_jax_rows(csv_rows)
    if device == "cuda":
        run_measured(csv_rows, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import subprocess

        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no card is visible; pass "
                               "--device cpu for the arithmetic alone")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    rows = []
    run(rows, args.device)
    return rows


if __name__ == "__main__":
    main()
