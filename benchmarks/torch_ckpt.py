"""One checkpoint save and one restore of full-depth granite-3-2b on the
card, through the training loop's own checkpoint path.

    PYTHONPATH=src python benchmarks/torch_ckpt.py [--layers 40] \\
        [--dir build/torch_ckpt] [--out results/torch_ckpt.json]
    # a CPU rehearsal at the reduced config
    PYTHONPATH=src python benchmarks/torch_ckpt.py --device cpu --reduced

It first checks that the directory's file system has room for the
checkpoint (fp32 params + AdamW's m and v: 12 bytes a parameter, ~30.4 GB
at 40 layers) with 15% to spare, and exits otherwise.  Then:

1. ``train.loop.train`` runs one step (batch 4 x seq 512, ``auto``
   attention with block remat, AdamW) with ``ckpt_every=1``: the save's
   enqueue (the device-to-host copy of every leaf, the stall the training
   step pays: the ``ckpt_enqueue`` span) and the writer thread's time (npz
   + meta + manifest, the ``ckpt_write`` span, waited for when the loop
   closes its manager);
2. a second loop call on fresh parameters (another seed) with the same
   directory restores that step into them in place and has nothing left
   to run: the ``ckpt_restore`` span (read + host-to-device copy +
   synchronize);
3. every restored leaf must equal the saved one bitwise, and the
   optimizer step must be 1;
4. the restore's two parts, timed apart over the same file: reading each
   array out of the npz into host memory (numpy), and copying it to the
   device (``copy_`` into the restored tensor, then a synchronize).

It prints one JSON line (and writes it to ``--out``): the bytes on disk,
the three times and their rates, the (first) step's own time, the free space
before, peak device memory, and the card's name and power limit.  The
checkpoint directory is deleted at the end.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def restore_parts(d: Path, tree) -> tuple:
    """(seconds reading every array of the newest step's npz into host
    memory, seconds copying them into ``tree``'s tensors on the device)."""
    import numpy as np

    from repro_torch.models.common import path_str, tree_items

    leaves = {path_str(p): t for p, t in tree_items(tree)
              if isinstance(t, torch.Tensor)}
    read = h2d = 0.0
    with np.load(max(d.glob("step_*.npz"))) as data:
        for key, t in leaves.items():
            t0 = time.perf_counter()
            host = torch.from_numpy(data[key])
            t1 = time.perf_counter()
            t.copy_(host)
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            h2d += time.perf_counter() - t1
            read += t1 - t0
    return read, h2d


def main() -> None:
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import materialize, param_count, tree_items
    from repro_torch.obs import Tracer
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.train.loop import train

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a CPU rehearsal)")
    ap.add_argument("--dir", default="build/torch_ckpt")
    ap.add_argument("--out", default="results/torch_ckpt.json")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_ckpt: needs a CUDA device")
        card = smi()
        print(card, flush=True)
    else:
        card = "cpu"
    cfg = get_config("granite-3-2b")
    cfg = cfg.reduced() if args.reduced else cfg.replace(
        num_layers=args.layers)
    n = param_count(M.model_specs(cfg))
    need = 12 * n  # fp32 params, m and v
    d = ROOT / args.dir
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    free = shutil.disk_usage(d).free
    print(f"granite-3-2b, {cfg.num_layers} layers, {n:,} params: the "
          f"checkpoint needs {need / 1e9:.2f} GB; {free / 1e9:.2f} GB free "
          f"under {d}", flush=True)
    if free < 1.15 * need:
        shutil.rmtree(d, ignore_errors=True)
        raise SystemExit("torch_ckpt: not enough free disk for the "
                         "checkpoint")
    run = RunConfig(attn_impl="auto", remat="block")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=1)
    kw = dict(batch=args.batch, seq=args.seq, steps=1, device=args.device,
              log_every=0, ckpt_dir=str(d), ckpt_every=1)
    dev = torch.device(args.device)
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        p1 = materialize(M.model_specs(cfg), 0, dev)
        s1 = init_state(opt, p1)
        t_save = Tracer()
        t0 = time.perf_counter()
        res = train(cfg, run, opt, params=p1, opt_state=s1, tracer=t_save,
                    **kw)
        wall_save = time.perf_counter() - t0
        disk = sum(p.stat().st_size for p in d.iterdir())
        p2 = materialize(M.model_specs(cfg), 1, dev)
        s2 = init_state(opt, p2)
        t_load = Tracer()
        back = train(cfg, run, opt, params=p2, opt_state=s2, tracer=t_load,
                     **kw)
        same = all(torch.equal(a, b) for tree1, tree2 in
                   ((p1, p2), (s1["m"], s2["m"]), (s1["v"], s2["v"]))
                   for (_, a), (_, b) in zip(tree_items(tree1),
                                             tree_items(tree2)))
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else 0)
        read_s, h2d_s = restore_parts(d, {"params": p2, "opt_state": s2})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not same or s2["step"] != 1 or back.start_step != 1 or back.losses:
        raise SystemExit("torch_ckpt: the restored state differs from the "
                         "saved one")
    enqueue = t_save.total_s("ckpt_enqueue")
    write = t_save.total_s("ckpt_write")
    restore = t_load.total_s("ckpt_restore")
    line = {
        "layers": cfg.num_layers, "n_params": n, "disk_bytes": disk,
        "free_bytes_before": free,
        "enqueue_s": enqueue, "enqueue_gb_per_s": disk / enqueue / 1e9,
        "write_s": write, "write_gb_per_s": disk / write / 1e9,
        "restore_s": restore, "restore_gb_per_s": disk / restore / 1e9,
        "restore_read_s": read_s, "restore_h2d_s": h2d_s,
        "first_step_s": res.step_times[0].compute,
        "save_call_wall_s": wall_save, "restored_bitwise": same,
        "peak_gb": peak / 1e9, "card": card,
    }
    print(json.dumps(line), flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(line) + "\n")
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
