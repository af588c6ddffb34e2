"""Does full-width granite-3-2b learn in a few steps, by depth and init?

    PYTHONPATH=src python benchmarks/torch_train_depth.py \\
        [--layers 4 8 16 40] [--seeds 0 1 2 3] [--steps 4]

Runs the training loop (``train.loop.train``) on the card with the
session's run and optimizer settings (``attn_impl="auto"``,
``remat="block"``, AdamW at lr 1e-3 with ``max(steps // 10, 1)`` warmup
steps), batch 4 x seq 512, from random weights for each depth and seed,
once at the JAX package's init and once with the attention projections
smoothed as ``chip_smoke.py``'s phase 4 does (std 1/sqrt(fan-in of the
whole product); JAX's init takes fan-in = heads for wq/wk/wv, which makes
the scores' std ~64 and the softmax one-hot).  Prints one JSON line per
run with its losses.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import smooth_attention  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.blocks import RunConfig  # noqa: E402
from repro_torch.models.common import materialize  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 8, 16, 40])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_depth: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    run = RunConfig(attn_impl="auto", remat="block")
    opt = OptConfig(lr=1e-3, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps)
    for layers in args.layers:
        cfg = get_config("granite-3-2b").replace(num_layers=layers)
        for smooth in (False, True):
            for seed in args.seeds:
                params = materialize(M.model_specs(cfg), seed, "cuda")
                if smooth:
                    smooth_attention(params, cfg)
                res = train(cfg, run, opt, batch=4, seq=512,
                            steps=args.steps, seed=seed, device="cuda",
                            params=params, log_every=0)
                print(json.dumps({"layers": layers, "smooth": smooth,
                                  "seed": seed, "losses": res.losses}),
                      flush=True)
                del params
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
