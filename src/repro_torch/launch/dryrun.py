"""Multi-pod dry run: one rank's train, prefill or decode step for every
(arch x input-shape x mesh) combination, traced on the ``meta`` device,
and the roofline terms it gives: the twin of ``repro.launch.dryrun``.

JAX lowers and compiles each step against 256 or 512 placeholder devices
and reads XLA's cost and memory analyses.  The port's sharded step is an
explicit rank program (``distributed/spmd.py``), so :func:`trace` runs
rank 0's step on ``meta`` tensors of the local shapes
(``launch/steps.py::input_specs``, ``abstract_params``,
``abstract_opt_state``) under ``RecordingGroup``s: nothing is allocated
and no byte moves, and it measures

* FLOPs with ``torch.utils.flop_counter.FlopCounterMode``;
* bytes accessed as the sum of each aten op's input and output bytes (a
  ``TorchDispatchMode``; view ops move nothing).  Eager PyTorch fuses
  nothing, so this is an unfused upper bound of the traffic, where XLA's
  count is after fusion;
* memory: ``argument_bytes`` and ``output_bytes`` exactly from the local
  shapes (outputs that are new storage: the step updates parameters,
  moments and caches in place), ``temp_bytes`` as the peak of live bytes
  beyond the arguments and outputs, tracked by storage.
  ``alias_bytes`` is 0: eager updates in place, there is no donated
  buffer to alias;
* collectives from the groups' records, priced by ``launch/wire.py``.

An eager trace runs every layer, so the full-depth trace gives
``derived`` directly; JAX's 1- and 2-cycle traces are kept for the
record's ``*_base`` and ``*_per_cycle`` fields, and ``base + (n - 1) x
delta`` must equal the full count.  A combination that fails is recorded
``ok: false`` with its error (a part of the rank program not written yet
raises ``NotImplementedError`` naming its ROADMAP item); the CLI exits 1
if any failed.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
      --mesh single --out results/torch_dryrun [--skip-full] [--skip-count]
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.distributed import spmd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as S
from repro_torch.launch import wire
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.obs.trace import monotonic
from repro_torch.optim.adamw import OptConfig

OUT = "results/torch_dryrun"
DONATION = ("n/a: eager PyTorch updates parameters, optimizer state and "
            "caches in place; there is no buffer to donate")


def _planner_defaults(cfg, shape):
    """Runtime knobs for the baseline dry run: FSDP for the five big
    archs, momentum for arctic (JAX's)."""
    big = cfg.name in (
        "qwen2-72b", "jamba-1.5-large-398b", "arctic-480b",
        "deepseek-v2-236b", "llava-next-34b",
    )
    opt_kind = "momentum" if cfg.name == "arctic-480b" else "adamw"
    return big, OptConfig(kind=opt_kind)


def variant_config(cfg, shape):
    """Arch variant run for this input shape (long-context SWA override
    for full-attention archs, JAX's long_500k policy)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return cfg.replace(attn_window_override=8192), "swa8192-variant"
    return cfg, "native"


def _reduced_cycles(cfg, n_cycles):
    return cfg.replace(num_layers=cfg.first_k_dense + n_cycles * len(cfg.pattern))


def build_step_and_args(cfg, shape, mesh, run=None, *, counting=False,
                        optimized=False):
    """(fn, args, log): rank 0's step for ``shape.kind`` and its arguments
    as meta tensors, its groups ``RecordingGroup``s logging to ``log``.
    ``run`` and ``counting`` are JAX's (its ``counting`` unrolls the
    layers for XLA's cost analysis): an eager trace counts every layer
    either way, so both are unused.  ``optimized``: the levers that mean
    something eagerly: bf16 gradients and the reduce-scatter onto the
    ZeRO-1 layout (train), int8 KV (decode)."""
    fsdp, opt = _planner_defaults(cfg, shape)
    rules = mesh_lib.sharding_rules(mesh, cfg, shape, fsdp=fsdp)
    log: list = []
    ctx = spmd.ShardContext(
        mesh=mesh, rank=0, groups=mesh_lib.recording_groups(mesh, 0, log),
        rules=rules, specs=M.model_specs(cfg), fsdp=fsdp,
        seq_parallel=shape.kind != "decode", grad_reduce_scatter=optimized)
    if shape.kind in ("train", "prefill"):
        runc = RunConfig(attn_impl="chunked", remat="block", shard=ctx,
                         bf16_grads=optimized and shape.kind == "train")
    else:
        runc = RunConfig(attn_impl="dense", remat="none", shard=ctx)
    inputs = S.input_specs(cfg, shape, mesh, rules,
                           kv_quant=optimized and shape.kind == "decode")
    if shape.kind == "train":
        params = S.abstract_params(cfg, mesh, rules)
        opt_state = S.abstract_opt_state(cfg, mesh, rules, opt)
        return S.build_train_step(cfg, runc, opt), (params, opt_state,
                                                    inputs), log
    params = S.abstract_params(cfg, mesh, rules, dtype="bfloat16")
    if shape.kind == "prefill":
        return S.build_prefill_step(cfg, runc), (params, inputs), log
    return S.build_decode_step(cfg, runc), (
        params, inputs["tokens"], inputs["pos"], inputs["caches"]), log


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return StorageWeakRef(t.untyped_storage()).cdata


class _Meter(TorchDispatchMode):
    """Per aten op: the bytes it reads and writes (not for view ops), and
    the live bytes of the storages it creates beyond the arguments',
    their peak kept.  A storage is live until its last user dies
    (``StorageWeakRef.expired``); the live set is swept whenever the
    running count would raise the peak."""

    def __init__(self, arg_keys):
        super().__init__()
        self.args = arg_keys
        self.live = {}
        self.cur = 0
        self.peak = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        key = ref.cdata
        if key in self.args:
            return
        old = self.live.get(key)
        if old is not None:
            if not old[0].expired():
                return
            self.cur -= old[1]
        n = st.nbytes()
        self.live[key] = (ref, n)
        self.cur += n
        if self.cur > self.peak:
            self.sweep()
            self.peak = max(self.peak, self.cur)

    def sweep(self) -> None:
        for k in [k for k, (r, _) in self.live.items() if r.expired()]:
            self.cur -= self.live.pop(k)[1]


def trace(fn, args, log) -> dict:
    """Run ``fn(*args)`` once under the FLOP counter and the byte and
    memory meter; ``log`` is the list its groups record into (read after
    the call).  Works on meta tensors (the dry run) and on real ones (the
    card's check of the dry run against the real step)."""
    arg_ts = _tensors(args)
    arg_keys = {_key(t) for t in arg_ts}
    n_log = len(log)
    t0 = monotonic()
    meter = _Meter(arg_keys)
    with FlopCounterMode(display=False) as fc:
        with meter:
            out = fn(*args)
    trace_s = monotonic() - t0
    meter.sweep()
    seen, out_bytes = set(), 0
    for t in _tensors(out):
        k = _key(t)
        if k not in arg_keys and k not in seen:
            seen.add(k)
            out_bytes += t.untyped_storage().nbytes()
    return {"flops": int(fc.get_total_flops()), "bytes": int(meter.bytes),
            "argument_bytes": int(sum(_nbytes(t) for t in arg_ts)),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(max(meter.peak - out_bytes, 0)),
            "records": list(log[n_log:]), "trace_s": trace_s, "out": out}


def analyze(traced: dict) -> dict:
    """The record's measurement section (JAX's ``analyze`` keys)."""
    stats = wire.collective_bytes(traced["records"])
    return {
        "flops": float(traced["flops"]),
        "bytes_accessed": float(traced["bytes"]),
        "memory": {
            "argument_bytes": traced["argument_bytes"],
            "output_bytes": traced["output_bytes"],
            "temp_bytes": traced["temp_bytes"],
            "alias_bytes": 0,
        },
        "collectives": stats,
        "wire_bytes": wire.total_wire_bytes(stats),
    }


def run_one(arch, shape_name, mesh_kind, outdir=OUT, skip_full=False,
            skip_count=False, optimized=False, mesh_shape=None,
            config=None, shape=None):
    """Trace one combination and write its record to
    ``{outdir}/{arch}__{shape}__{mesh}.json``; returns whether it is ok.
    ``config``/``shape``: a ModelConfig / ShapeConfig in place of the
    registry's (a reduced arch in the tests)."""
    cfg0 = config if config is not None else get_config(arch)
    shape = shape if shape is not None else get_shape(shape_name)
    cfg, variant = variant_config(cfg0, shape)
    if mesh_shape:  # reinterpret the 256 chips, e.g. 32x8
        mesh = Mesh(tuple(mesh_shape), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "optimized": optimized,
        "num_devices": int(np.prod(list(mesh.shape.values()))),
        "pattern_cycles": cfg.num_cycles if not cfg.first_k_dense else
        (cfg.num_layers - cfg.first_k_dense) // len(cfg.pattern),
        "mesh_shape": list(mesh.dims), "donation": DONATION,
        "ok": False,
    }
    try:
        if not skip_full:
            fn, args, log = build_step_and_args(cfg, shape, mesh,
                                                optimized=optimized)
            traced = trace(fn, args, log)
            del fn, args
            rec["full"] = analyze(traced)
            rec["full"]["trace_s"] = round(traced["trace_s"], 2)
            rec["full"]["n_collectives"] = len(traced["records"])
            del traced

        if not skip_count:
            n_cycles = rec["pattern_cycles"]
            counts = {}
            for nc in (1, 2):
                fn, args, log = build_step_and_args(
                    _reduced_cycles(cfg, nc), shape, mesh, counting=True,
                    optimized=optimized)
                traced = trace(fn, args, log)
                counts[nc] = analyze(traced)
                counts[nc]["trace_s"] = round(traced["trace_s"], 2)
                del fn, args, traced
            extra = {}
            for key in ("flops", "bytes_accessed", "wire_bytes"):
                base, two = counts[1][key], counts[2][key]
                delta = max(two - base, 0.0)
                extra[key] = base + (n_cycles - 1) * delta
                extra[key + "_per_cycle"] = delta
                extra[key + "_base"] = base
                if "full" in rec and rec["full"][key] != extra[key]:
                    raise ValueError(
                        f"{key}: base {base} + ({n_cycles} - 1) x "
                        f"{delta} != the full trace's {rec['full'][key]}")
            rec["derived"] = extra
            rec["count_details"] = counts
        elif "full" in rec:
            rec["derived"] = {k: rec["full"][k] for k in
                              ("flops", "bytes_accessed", "wire_bytes")}
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    path = outdir / f"{arch}__{shape_name}__{mesh_kind}.json"
    path.write_text(json.dumps(rec, indent=1, default=float))
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')[:120]})"
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {status}",
          flush=True)
    return rec["ok"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-full", action="store_true")
    ap.add_argument("--skip-count", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="the levers that mean something eagerly: bf16 "
                         "gradients, the reduce-scatter onto the ZeRO-1 "
                         "layout, int8 KV at decode (donation has no "
                         "meaning here)")
    ap.add_argument("--mesh-shape", default="",
                    help="override the single-pod mesh as DPxTP, e.g. 32x8 "
                         "(model inside one 8-card NVLink node)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    t0 = monotonic()
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                p = Path(args.out) / f"{arch}__{shape}__{mesh_kind}.json"
                if args.skip_existing and p.exists():
                    if json.loads(p.read_text()).get("ok"):
                        continue
                ms = None
                if args.mesh_shape:
                    ms = tuple(int(x) for x in args.mesh_shape.split("x"))
                ok = run_one(arch, shape, mesh_kind, args.out,
                             args.skip_full, args.skip_count,
                             optimized=args.opt, mesh_shape=ms)
                n_fail += (not ok)
    print(f"[dryrun] done, {n_fail} failures, wall "
          f"{monotonic() - t0:.1f} s", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
