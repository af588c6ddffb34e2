"""What the training drivers share: building the program's train step
for a cell the way ``Session.train()`` does, reading the program's state
for the comparison, the reference run after the window, and the result.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import torch

from bench import check, traffic as traffic_lib, weights
from bench.harness import Run
from bench.reference import train as ref_train

OPT_KEYS = ("kind", "lr", "b1", "b2", "eps", "weight_decay", "grad_clip",
            "warmup_steps", "total_steps")


def program_config(config: Dict):
    """The program's ModelConfig for the configuration file: the registry
    entry with the file's sizes; a size that differs from the registry
    must be listed under ``reduced``."""
    from repro_torch.configs.base import get_config

    base = get_config(config["registry_id"])
    cfg = base.replace(**config["model"])
    changed = {k for k in config["model"]
               if getattr(cfg, k) != getattr(base, k)}
    if changed - set(config["reduced"]):
        raise ValueError(f"{config['name']}: {sorted(changed)} differ from "
                         "the registry but are not listed as reduced")
    return cfg


def session_setup(run: Run, *, batch: int, dp: int = 0, **spec_kw):
    """(cfg, RunConfig, OptConfig) of ``Session.train()`` for the cell: a
    JobSpec with the cell's arch, batch and sequence on the session's own
    defaults (no planner, no tune).  The optimizer must be the one the
    configuration file states, since the reference follows it."""
    from repro_torch.api import JobSpec, Session
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_items

    cfg = program_config(run.config)
    spec = JobSpec(arch=run.config["registry_id"], reduced=False,
                   batch=batch, seq=int(run.traffic["seq"]), dp=dp,
                   **spec_kw)
    session = Session(spec, config=cfg, device=run.device)
    run_cfg, opt = session.build_run_opt()
    want = run.config["optimizer"]
    got = {k: getattr(opt, k) for k in OPT_KEYS}
    if got != {k: want[k] for k in OPT_KEYS}:
        raise ValueError(f"the session's optimizer {got} is not the "
                         f"configuration's {want}")
    weights.check_layout(run.config, {
        "/".join(p): s.shape for p, s in tree_items(M.model_specs(cfg))})
    return cfg, run_cfg, opt


def leaf_norms(tree) -> Dict[str, float]:
    return {p: float(torch.linalg.vector_norm(t.float()))
            for p, t in weights.flat(tree).items()}


def change_norms(run: Run, params) -> Dict[str, float]:
    """Each leaf's distance from its initial value, made again from the
    seed one leaf at a time."""
    out = {}
    by_path = {leaf[0]: leaf for leaf in weights.layout(run.config)}
    for path, t in weights.flat(params).items():
        t0 = weights.make_leaf(by_path[path], run.seed, t.device)
        out[path] = float(torch.linalg.vector_norm(t.float() - t0))
        del t0
    return out


def program_readings(losses: List[float], grad_m: Dict[str, float],
                     change: Dict[str, float], b1: float) -> Dict:
    return {"losses": losses,
            "grad_norms": {p: n / (1.0 - b1) for p, n in grad_m.items()},
            "change_norms": change}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def compared_steps(run: Run) -> int:
    """The steps the reference follows (``compared_steps`` in the cell)."""
    return int(run.cell["compared_steps"])


def reference(run: Run, device, *, batch: int, numerics: str = "fp32",
              rows: List[int] = None) -> Dict:
    """The reference's readings on the first compared batches of the
    global stream (``rows``: which rows of each batch, default all)."""
    seq = int(run.traffic["seq"])
    corpus = traffic_lib.Corpus(run.traffic, int(run.config["model"]
                                                 ["vocab_size"]), run.seed)
    batches = []
    for i in range(compared_steps(run)):
        tok, lab = traffic_lib.global_batch(corpus, batch, seq, i)
        if rows is not None:
            tok, lab = tok[rows], lab[rows]
        batches.append((torch.from_numpy(tok).to(device),
                        torch.from_numpy(lab).to(device)))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        flat0 = weights.make(run.config, run.seed, device)
        t0 = time.perf_counter()
        out = ref_train.follow(run.config, flat0, batches,
                               steps=compared_steps(run), numerics=numerics,
                               rows_per_block=int(run.cell["reference_rows"]))
        sync(device)
        print(f"bench: reference ({numerics}) {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
    return out


def judge(run: Run, prog: Dict, ref: Dict):
    values = check.readings(prog, ref, int(run.cell["loss_steps"]))
    return check.judge(values, run.cell["limits"])
