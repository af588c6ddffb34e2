"""Paper Fig. 3 on the port: learning curves across mini-batch sizes at a
fixed token budget (the twin of ``benchmarks/fig3_convergence.py``).

    PYTHONPATH=src python benchmarks/torch_fig3_convergence.py \\
        [--device cuda|cpu] [--out results/torch_fig3.json]

A range of X_mini reaching the same loss in a similar number of samples
is what licenses choosing X_mini on system grounds (§3.1.4).  The JAX
script's configuration: granite-3-2b reduced with vocab 512, seq 64,
``attn_impl="dense"``, ``remat="none"``, batches 4, 8 and 16 at a budget
of 160 x 8 x 64 tokens (320, 160 and 80 steps), lr 1e-3 x batch / 8 with
a tenth of the steps as warmup, through the port's ``train/loop.py``.

The JAX package's init makes attention nearly one-hot (it takes fan-in =
heads for the (D, H, hd) projections: ``src/repro/models/common.py:66``),
so the curves run twice, each labelled: once at that init (``jax-init``,
for parity with the JAX script), and once with the attention projections
rescaled to std 1/sqrt(fan-in of the whole product) (``smoothed``,
``repro_torch.models.common.smooth_attention``).  For each it prints the
final loss (mean of the last 5 steps) per batch and the spread across
batch sizes.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models.common import smooth_attention  # noqa: E402

TOKENS_BUDGET = 160 * 8 * 64  # fixed token budget = fixed "epochs"
SEQ = 64
BATCHES = (4, 8, 16)
INITS = ("jax-init", "smoothed")


def curves(init: str, device="cuda", batches=BATCHES, budget=TOKENS_BUDGET):
    """{batch: (steps, losses)} for one init."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import train

    cfg = get_config("granite-3-2b").reduced().replace(vocab_size=512)
    run_cfg = RunConfig(attn_impl="dense", remat="none")
    out = {}
    for batch in batches:
        steps = budget // (batch * SEQ)
        # LR scaled linearly with batch (standard practice the paper predates)
        opt = OptConfig(lr=1e-3 * batch / 8, warmup_steps=steps // 10,
                        total_steps=steps)
        params = M.init_params(cfg, 0, device)
        if init == "smoothed":
            smooth_attention(params, cfg)
        res = train(cfg, run_cfg, opt, batch=batch, seq=SEQ, steps=steps,
                    log_every=0, seed=0, device=device, params=params)
        out[batch] = (steps, res.losses)
    return out


def run(csv_rows, device="cuda"):
    print("\n== Fig. 3: convergence vs mini-batch size (fixed token budget) ==")
    summary = {}
    for init in INITS:
        print(f"-- {init} --")
        print(f"{'batch':>6s} {'steps':>6s} {'final_loss':>11s}")
        finals = {}
        for batch, (steps, losses) in curves(init, device).items():
            final = float(np.mean(losses[-5:]))
            finals[batch] = final
            print(f"{batch:6d} {steps:6d} {final:11.4f}", flush=True)
            csv_rows.append((f"fig3/{init}/batch{batch}_final_loss", final,
                             f"steps={steps}"))
        spread = max(finals.values()) - min(finals.values())
        print(f"loss spread across batch sizes ({init}): {spread:.4f}")
        csv_rows.append((f"fig3/{init}/loss_spread", spread, ""))
        summary[init] = {"final_loss": finals, "loss_spread": spread}
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/torch_fig3.json")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no card is visible; pass "
                               "--device cpu")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    summary = run([], args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
