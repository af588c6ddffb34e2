"""The paper's closed-loop autotuner — the port of ``repro.core.autotune``.

The abstract promises "a procedure for setting minibatch size and choosing
computation algorithms".  The planner prices a step from data-sheet
constants (:class:`~repro_torch.core.hardware.Chip`); this module closes
the loop on measurements, in the JAX module's four stages:

1. **Microbenchmark** — :func:`bench_kernels` times every variant of
   every op in ``kernels.ops.TUNABLE_OPS`` (the CUDA kernels against their
   plain versions, the SSD scan at several chunks) and picks the fastest
   that runs; :func:`choose_conv_algs` is Table 2's choice under Eq. 5;
   :func:`host_microbench` measures the device's matmul FLOP/s and triad
   bandwidth; :func:`measure_train_steps` runs short trainer steps.
2. **Calibrate** — :func:`fit_calibration` fits a :class:`Calibration`:
   the FLOP/s the trainer achieves, the triad bandwidth, and the
   data-axis link bandwidth from a measured ``SyncReport`` when
   ``dp >= 2``; :func:`tune_overlap` adds the achieved comm/compute
   overlap.  It persists in a JSON cache keyed by
   ``backend/cluster/executed-config`` in the JAX module's on-disk schema,
   so one file holds both packages' calibrations.  The port's backend is
   ``torch-<device type>`` (JAX's is ``jax.default_backend()``): the two
   packages' wall clocks differ, and neither prices on the other's.
3. **Procedure** — :func:`tune_minibatch`: the largest Eq.-5-feasible
   ``X_mini`` and the largest microbatch whose ``train_memory`` fits.
4. **Re-plan** — :func:`autotune` prices the production job again on
   :meth:`Calibration.apply`'s measured constants.

Every number crosses the packages unchanged: the same fits, keys, plans
and cache files as the JAX module for the same measurements.  In a job
with one process per rank (``rank``/``world``/``store``), every rank
measures and rank 0's kernel choice and calibration go to every rank
through the job's store, so no two ranks adopt different knobs; only rank
0 writes the cache.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import memory_model as mm
from repro_torch.core.hardware import ClusterSpec, MeshSpec
from repro_torch.core.planner import (Plan, estimate_step_time,
                                      plan as plan_fn, train_flops_per_step)
from repro_torch.kernels import ops
from repro_torch.models.common import resolve_device
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs.trace import monotonic

# Schema id of the tuning section a Session.tune() Report carries under
# ``measured["tuning"]`` (validated by repro_torch.api.report.validate_report).
TUNING_SCHEMA_ID = "repro.api/tuning/v1"

# Default on-disk calibration cache (keyed by backend/cluster/executed-config).
DEFAULT_CACHE_PATH = "results/calibration_cache.json"
CACHE_SCHEMA_ID = "repro.core/autotune-cache/v1"

# The calibration's triad array size [MiB] on a card.  At the JAX
# package's 32 MiB an array each pass of an H100 triad still pays a ramp
# that reads 0.78-0.86x the 256 MiB rate, and Calibration.apply makes the
# triad the chip's hbm_bw; on the CPU the calibration keeps JAX's 32 MiB.
CARD_TRIAD_MB = 256


def triad_mb(device) -> int:
    """The triad's array size [MiB] the calibration times on ``device``."""
    return CARD_TRIAD_MB if torch.device(device).type == "cuda" else 32


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


def _triad(u: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
           passes: int) -> torch.Tensor:
    """``passes`` passes of out = u + 2 v, each one kernel: two reads and
    one write an element."""
    for _ in range(passes):
        torch.add(u, v, alpha=2.0, out=out)
    return out


def host_microbench(*, n: int = 512, copy_mb: int = 32, repeats: int = 3,
                    passes: int = 16, device="cuda") -> Dict[str, float]:
    """Achieved constants of ``device``: fp32 matmul FLOP/s and
    triad-style bytes/s.  The triad's timed call runs ``passes`` passes
    back to back, so the fixed cost of a call (launch and synchronize)
    is spread over them: at 32 MiB an array one pass on an H100 takes
    about as long as that fixed cost."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=dev)
    b = torch.randn((n, n), generator=g, device=dev)
    t_mm = _timeit(torch.matmul, a, b, repeats=repeats)
    matmul_flops = 2.0 * n ** 3 / t_mm

    m = max(copy_mb * 2 ** 20 // 4, 1)
    x = torch.ones((m,), device=dev)
    y = torch.full((m,), 2.0, device=dev)
    w = torch.empty_like(x)
    # fused passes (JAX jits u + 2v into one kernel): eager ``u + 2.0 *
    # v`` would be two kernels and five array passes against the three
    # counted here
    t_triad = _timeit(_triad, x, y, w, passes, repeats=repeats)
    triad_bw = 3.0 * 4.0 * m * passes / t_triad  # 2 reads + 1 write each
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


# ---------------------------------------------------------------------------
# Measured trainer steps (the StepTimes/SyncReport feedback path)
# ---------------------------------------------------------------------------


def _placement(device, dp: int, devices, rank, world, store,
               tag: str) -> Dict[str, Any]:
    """The data-parallel trainer's placement keywords for ``dp`` ranks.
    One-rank mode (``rank`` given): rank ``rank`` of ``world`` on
    ``devices`` (default ``[device]``), its groups on ``store`` under the
    prefix ``tag``, so that each trainer a tuning pass builds has keys of
    its own.  Otherwise every rank in this process, one thread each, on
    ``devices`` (default ``distributed.trainer.rank_devices``)."""
    from repro_torch.distributed.trainer import rank_devices

    if rank is None:
        return dict(devices=(rank_devices(device, dp) if devices is None
                             else list(devices)[:dp]))
    if world != dp:
        raise ValueError(f"dp={dp} but world={world}: one process per rank")
    return dict(devices=[device] if devices is None else list(devices),
                rank=rank, world=world, store=dist.PrefixStore(tag, store))


def measure_train_steps(cfg: ModelConfig, *, batch: int, seq: int,
                        steps: int = 3, dp: int = 0, seed: int = 0,
                        topology: Optional[ClusterSpec] = None,
                        device="cuda", devices=None, rank: Optional[int] = None,
                        world: Optional[int] = None, store=None
                        ) -> Dict[str, Any]:
    """Run a short instrumented training burst on ``device`` and distill
    the timings the calibration fit needs.  ``dp >= 2`` uses the
    data-parallel trainer with ``all_reduce`` (measuring the sync phase
    too), placed by ``devices`` / ``rank`` / ``world`` / ``store`` as the
    trainer is; otherwise the single-device loop.  Best-of-steps is
    reported next to the steady mean so the first step's one-time costs
    cannot poison the fit."""
    from repro_torch.models.blocks import RunConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import loop as loop_lib

    run = RunConfig(attn_impl="auto", remat="none")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=max(steps, 1))
    sync_report = None
    dev = resolve_device(device)
    if dp >= 2:
        from repro_torch.distributed.trainer import DataParallelTrainer

        tr = DataParallelTrainer(
            cfg, run, opt, strategy="all_reduce", topology=topology,
            **_placement(dev, dp, devices, rank, world, store, "measure"))
        try:
            res = tr.train(batch=batch, seq=seq, steps=steps, seed=seed,
                           log_every=0)
            sync_report = tr.report().as_dict()
        finally:
            tr.close()
    else:
        res = loop_lib.train(cfg, run, opt, batch=batch, seq=seq, steps=steps,
                             seed=seed, log_every=0, device=dev)
    ts = res.step_times
    step_total = [t.compute + t.param_update + t.dist_update for t in ts]
    steady = ts[2:] or ts
    mean = lambda xs: float(sum(xs) / len(xs)) if xs else 0.0
    out: Dict[str, Any] = {
        "steps": len(ts),
        "batch": batch, "seq": seq, "dp": dp,
        "best_step_s": float(min(step_total)) if step_total else 0.0,
        "best_compute_s": float(min(t.compute for t in ts)) if ts else 0.0,
        "mean_step_s": mean([t.compute + t.param_update + t.dist_update
                             for t in steady]),
        "mean_compute_s": mean([t.compute for t in steady]),
        "mean_comm_s": mean([t.dist_update for t in steady]),
        "tokens_per_s": float(res.tokens_per_s),
        "r_o": float(res.mean_r_o),
    }
    if sync_report is not None:
        out["sync"] = sync_report
    return out


# default bucket-size candidates for the overlap sweep [MiB]; callers with
# tiny (test-scale) gradients pass their own
DEFAULT_OVERLAP_BUCKET_MBS = (1.0, 4.0, 16.0)


def tune_overlap(cfg: ModelConfig, *, batch: int, seq: int, dp: int,
                 steps: int = 8, seed: int = 0,
                 bucket_mbs: Tuple[float, ...] = DEFAULT_OVERLAP_BUCKET_MBS,
                 topology: Optional[ClusterSpec] = None, device="cuda",
                 devices=None, rank: Optional[int] = None,
                 world: Optional[int] = None, store=None) -> Dict[str, Any]:
    """Measure the achieved comm/compute overlap and its bucket-size sweet
    spot: one short overlapped trainer burst per candidate ``bucket_mb``,
    chosen on fused-step wall clock.  The winner's measured
    ``overlap_fraction`` calibrates the cost model's hideable window
    (:func:`repro_torch.core.ps.overlap_exposed_comm`) the same way the
    measured ``effective_link_bw`` calibrates Lemma 3.2's bandwidth.
    Below two ranks there is nothing to hide under: ``measured`` False."""
    if dp < 2:
        return {"measured": False,
                "note": f"needs dp >= 2 ranks (dp={dp})"}
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.models.blocks import RunConfig
    from repro_torch.optim.adamw import OptConfig

    run = RunConfig(attn_impl="auto", remat="none")
    steps = max(steps, DataParallelTrainer.N_CALIB_STEPS + 3)
    dev = resolve_device(device)
    candidates: Dict[str, Dict[str, float]] = {}
    best_mb, best_wall = 0.0, math.inf
    for mb in bucket_mbs:
        opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
        tr = DataParallelTrainer(
            cfg, run, opt, strategy="all_reduce", topology=topology,
            sync_overlap=True, bucket_mb=mb,
            **_placement(dev, dp, devices, rank, world, store,
                         f"overlap{mb:g}"))
        try:
            tr.train(batch=batch, seq=seq, steps=steps, seed=seed,
                     log_every=0)
            rep = tr.report()
        finally:
            tr.close()
        wall = rep.overlapped_step_s or math.inf
        candidates[f"{mb:g}"] = {
            "bucket_mb": mb,
            "n_buckets": rep.n_buckets,
            "overlap_fraction": rep.overlap_fraction,
            "exposed_comm_s": rep.exposed_comm_time,
            "serial_comm_s": rep.measured_comm_s,
            "fused_step_s": rep.overlapped_step_s,
        }
        if wall < best_wall:
            best_mb, best_wall = mb, wall
    chosen = candidates.get(f"{best_mb:g}", {})
    return {
        "measured": True,
        "dp": dp,
        "steps": steps,
        "candidates": candidates,
        "chosen_bucket_mb": best_mb,
        "overlap_fraction": float(chosen.get("overlap_fraction", 0.0)),
        "exposed_comm_s": float(chosen.get("exposed_comm_s", 0.0)),
        "serial_comm_s": float(chosen.get("serial_comm_s", 0.0)),
    }


# ---------------------------------------------------------------------------
# Calibration — the measured overlay on Chip/ClusterSpec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Calibration:
    """Measured hardware constants for one ``backend/cluster/executed-config``
    triple (the JAX module's fields and on-disk form).

    ``achieved_flops`` is the per-chip FLOP/s the *trainer* achieves (the
    model-flops-over-measured-compute fit, framework overhead included,
    which is what makes the re-planned ``estimate_step_time`` land near the
    wall clock).  ``matmul_flops``/``triad_bw`` are the raw microkernel
    ceilings kept for provenance and as the fallback when no trainer
    measurement exists.  ``link_bw`` is the effective per-worker data-axis
    bandwidth fitted from a measured ``SyncReport`` (0 = unmeasured)."""

    backend: str
    cluster: str
    achieved_flops: float           # FLOP/s per chip, trainer-fitted
    matmul_flops: float = 0.0       # FLOP/s, microkernel ceiling
    hbm_bw: float = 0.0             # bytes/s, triad microkernel
    link_bw: float = 0.0            # bytes/s per worker (0 = unmeasured)
    # achieved comm/compute overlap (SyncReport.overlap_fraction of the
    # best measured bucket size): derates the overlap model's hideable
    # window the same way link_bw re-prices Lemma 3.2.  ``bucket_mb > 0``
    # marks that the sweep actually ran — a fraction of 0.0 with a set
    # bucket_mb is a real measurement (no hiding achieved), not "unknown"
    overlap_fraction: float = 0.0
    bucket_mb: float = 0.0          # measured bucket-size sweet spot [MiB]
    arch: str = ""                  # executed config the wall clock belongs to
    measured: Dict[str, float] = field(default_factory=dict)
    created: str = ""

    @property
    def key(self) -> str:
        # the arch is part of the key: achieved FLOP/s is fitted *through*
        # a model, and the cached wall clock (replan's reference) is only
        # comparable to predictions for that same executed config
        base = f"{self.backend}/{self.cluster}"
        return f"{base}/{self.arch}" if self.arch else base

    def flops_efficiency(self, chip) -> float:
        """Achieved/peak — the fraction of the data sheet the measured
        trainer actually sustains on this backend."""
        return self.achieved_flops / chip.peak_flops if chip.peak_flops else 0.0

    # -- overlay ----------------------------------------------------------
    def apply(self, mesh: MeshSpec) -> MeshSpec:
        """Re-price a mesh on measured constants: the chip's peak FLOP/s and
        HBM bandwidth become the achieved ones, and every topology tier's
        bandwidth is rescaled so the bottleneck tier matches the measured
        link bandwidth (relative hierarchy preserved).  The chip keeps its
        name plus a ``+cal`` marker so plans record their provenance."""
        chip = mesh.chip.scaled(
            peak_flops=self.achieved_flops or self.matmul_flops or None,
            hbm_bw=self.hbm_bw or None)
        cluster = mesh.cluster
        tiers = cluster.tiers
        if self.link_bw > 0 and cluster.min_bw > 0:
            r = self.link_bw / cluster.min_bw
            tiers = tuple(replace(t, bw=t.bw * r) for t in tiers)
        topo = ClusterSpec(name=cluster.name, chip=chip, tiers=tiers)
        return dataclasses.replace(mesh, chip=chip, topology=topo)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Calibration":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def cfg_cache_key(cfg: ModelConfig) -> str:
    """The executed-config component of a calibration-cache key.  The name
    alone is not enough: a reduced family member shares its name with the
    full config but measures a very different wall clock."""
    return f"{cfg.name}@d{cfg.d_model}L{cfg.num_layers}"


def fit_calibration(cfg: ModelConfig, *, batch: int, seq: int,
                    measured: Dict[str, Any], micro: Dict[str, float],
                    backend: str, cluster_name: str,
                    remat: str = "none") -> Calibration:
    """Distill measurements into a :class:`Calibration`.

    The FLOP/s fit divides the step-time model's FLOP count for the
    *executed* config/shape by the best measured compute-phase time; the
    link fit takes the SyncReport's per-worker wire bytes over the
    measured sync-phase time."""
    exec_shape = ShapeConfig("tune-exec", seq, batch, "train")
    dp = max(int(measured.get("dp") or 0), 1)
    flops_step = train_flops_per_step(cfg, exec_shape, remat) / dp
    t_comp = measured.get("best_compute_s") or measured.get("mean_compute_s")
    achieved = flops_step / t_comp if t_comp else 0.0
    # the trainer's feedback path: SyncReport.effective_link_bw is the
    # measured bytes/s the sync phase delivered (0.0 when nothing moved)
    sync = measured.get("sync") or {}
    link_bw = float(sync.get("effective_link_bw") or 0.0)
    return Calibration(
        backend=backend, cluster=cluster_name, arch=cfg_cache_key(cfg),
        achieved_flops=achieved,
        matmul_flops=micro.get("matmul_flops", 0.0),
        hbm_bw=micro.get("triad_bw", 0.0),
        link_bw=link_bw,
        measured={"best_compute_s": float(t_comp or 0.0),
                  "best_step_s": float(measured.get("best_step_s") or 0.0),
                  "flops_per_step": float(flops_step),
                  "batch": float(batch), "seq": float(seq), "dp": float(dp),
                  # the triad's array size, where the microbenchmark names it
                  **({"copy_mb": float(micro["copy_mb"])}
                     if "copy_mb" in micro else {})},
        created=time.strftime("%Y-%m-%dT%H:%M:%S"),
    )


# -- JSON cache (keyed by backend/cluster/executed-config) ------------------


def load_cache(path) -> Dict[str, Dict[str, Any]]:
    p = Path(path)
    if not p.exists():
        return {}
    try:
        d = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return {}
    if d.get("schema") != CACHE_SCHEMA_ID:
        return {}
    return dict(d.get("calibrations", {}))


def cached_calibration(path, key: str, *,
                       copy_mb: Optional[float] = None
                       ) -> Optional[Calibration]:
    """The entry cached under ``key``.  Given ``copy_mb``, an entry whose
    triad was timed at another array size is a miss (one that names no
    size was timed at the JAX package's 32 MiB), so a card's calibration
    from before the 256 MiB triad is measured anew."""
    entry = load_cache(path).get(key)
    if not entry:
        return None
    cal = Calibration.from_dict(entry)
    if copy_mb is not None and \
            float(cal.measured.get("copy_mb", 32.0)) != float(copy_mb):
        return None
    return cal


def save_calibration(path, cal: Calibration) -> Path:
    p = Path(path)
    cals = load_cache(p)
    cals[cal.key] = cal.to_dict()
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(
        {"schema": CACHE_SCHEMA_ID, "calibrations": cals}, indent=2))
    return p


# ---------------------------------------------------------------------------
# The procedure end to end
# ---------------------------------------------------------------------------


@dataclass
class TuneResult:
    """Everything one autotune pass decided, measured, and re-planned."""

    backend: str
    cluster: str
    minibatch: Dict[str, Any]
    kernels: Dict[str, Any]
    conv_alg: Dict[str, Any]
    calibration: Calibration
    measured: Dict[str, Any]
    replan: Dict[str, Any]
    tuned_plan: Plan
    cache_path: str = ""
    # the measured comm/compute-overlap sweep (tune_overlap): bucket-size
    # candidates, the sweet spot, and the achieved overlap_fraction
    overlap: Dict[str, Any] = field(default_factory=dict)

    @property
    def chosen_minibatch(self) -> int:
        return int(self.minibatch["chosen"])

    @property
    def chosen_microbatch(self) -> int:
        return int(self.minibatch["microbatch"]["chosen"])

    def attn_impl(self) -> str:
        """The executable attention choice for training: ``dense`` when the
        plain version beat the flash kernel on this device, ``auto``
        otherwise (the training path runs no kernel either way)."""
        chosen = self.kernels.get("flash_attention", {}).get("chosen", "")
        return "dense" if chosen == "ref" else "auto"

    def ssd_chunk(self) -> Optional[int]:
        """The scan chunk of the winning kernel variant (``kernel_chunkN``),
        or None when the plain version won."""
        chosen = self.kernels.get("ssd_scan", {}).get("chosen", "")
        if chosen.startswith("kernel_chunk"):
            return int(chosen[len("kernel_chunk"):])
        return None

    def section(self) -> Dict[str, Any]:
        """The ``repro.api/tuning/v1`` section of a Report."""
        return {
            "schema": TUNING_SCHEMA_ID,
            "backend": self.backend,
            "cluster": self.cluster,
            "minibatch": self.minibatch,
            "kernels": self.kernels,
            "conv_alg": self.conv_alg,
            "calibration": self.calibration.to_dict(),
            "measured": self.measured,
            "replan": self.replan,
            "cache_path": self.cache_path,
            "overlap": self.overlap,
        }


def tune_minibatch(cfg_full: ModelConfig, shape: ShapeConfig,
                   mesh: MeshSpec, base_plan: Plan) -> Dict[str, Any]:
    """The paper's minibatch procedure, both forms:

    - CNN (Eq. 5): the largest ``X_mini`` with ``m_bound >= 0`` on this
      chip's memory — ``chosen`` is exactly that binary-search result.
    - Transformer: the largest per-replica microbatch whose
      ``train_memory`` total fits, under the plan's algorithm choices.
    """
    hbm = mesh.chip.hbm_bytes
    x_star = mm.max_x_mini(mm.ALEXNET, hbm)
    mb_star = mm.max_microbatch(
        cfg_full, shape, dp=mesh.dp, tp=mesh.tp, fsdp=base_plan.fsdp,
        attn_impl=base_plan.attn_impl, remat=base_plan.remat,
        seq_parallel=base_plan.seq_parallel, hbm_bytes=hbm,
        opt_kind=base_plan.opt_kind)
    return {
        "chosen": x_star,
        "bound": "m_bound",
        "search": "binary",
        "m_gpu_bytes": hbm,
        "m_bound_at_chosen": mm.m_bound(mm.ALEXNET, max(x_star, 1), hbm),
        "m_bound_at_next": mm.m_bound(mm.ALEXNET, x_star + 1, hbm),
        "microbatch": {
            "chosen": mb_star,
            "bound": "train_memory",
            "b_rep": max(shape.global_batch // mesh.dp, 1),
            "plan_microbatch": base_plan.microbatch,
            "attn_impl": base_plan.attn_impl,
            "remat": base_plan.remat,
        },
    }


def _from_rank0(store, rank: Optional[int], key: str, value):
    """``value`` as rank 0 has it, on every rank of a one-process-per-rank
    job: rank 0 puts it in the job's store as JSON and every rank (rank 0
    too) reads it back, so every rank holds the same JSON-decoded value.
    Outside such a job (``rank`` None) it is ``value`` itself."""
    if rank is None:
        return value
    if rank == 0:
        store.set(key, json.dumps(value))
    return json.loads(store.get(key))


def autotune(cfg_exec: ModelConfig, cfg_full: ModelConfig,
             shape: ShapeConfig, mesh: MeshSpec, *,
             batch: int, seq: int, steps: int = 3, dp: int = 0,
             seed: int = 0, cache_path: str = "", use_cache: bool = True,
             bench_seq: int = 128, repeats: int = 2,
             overlap_bucket_mbs: Tuple[float, ...] = DEFAULT_OVERLAP_BUCKET_MBS,
             tracer: Optional[Tracer] = None,
             metrics: Optional[MetricsRegistry] = None,
             device="cuda", devices=None, rank: Optional[int] = None,
             world: Optional[int] = None, store=None) -> TuneResult:
    """Run the whole closed loop once on ``device`` and return the
    :class:`TuneResult`.

    ``cfg_exec`` is what actually executes; ``cfg_full``/``shape``/``mesh``
    name the production job the re-plan prices.  ``cache_path`` ("" = no
    persistence) is the JSON calibration cache; a cached entry for this
    backend/cluster/config skips the trainer measurement unless
    ``use_cache`` is False.  ``dp >= 2`` measures on the data-parallel
    trainer, placed by ``devices`` (all ranks in this process) or by
    ``rank``/``world``/``store`` (this process's rank: rank 0's choices
    reach every rank through ``store``, and rank 0 alone writes the
    cache).  ``tracer``/``metrics`` record the pass: one span per stage
    (``bench_kernels`` / ``measure`` / ``tune_overlap`` / ``replan``) and
    the ``tune/*`` metric family the Session's ``metrics/v1`` section
    carries."""
    if tracer is None:
        tracer = Tracer(enabled=True)
    if metrics is None:
        metrics = MetricsRegistry()
    dev = resolve_device(device)
    backend = f"torch-{dev.type}"
    cluster = mesh.cluster
    cluster_name = cluster.name or f"flat{cluster.n_chips}"
    key = f"{backend}/{cluster_name}/{cfg_cache_key(cfg_exec)}"
    place = dict(device=dev, devices=devices, rank=rank, world=world,
                 store=store)
    shared = None if rank is None else dist.PrefixStore("autotune", store)

    # 1) algorithm microbenchmarks (every rank), rank 0's pick everywhere
    with tracer.span("bench_kernels", seq=bench_seq) as sp_k:
        kernels = bench_kernels(seq=bench_seq, repeats=repeats, device=dev)
        conv = choose_conv_algs(128, mesh.chip.hbm_bytes)  # Table 2's X_mini
    metrics.observe("tune/bench_kernels_s", sp_k.elapsed_s)
    kernels = _from_rank0(shared, rank, "kernels", kernels)
    for op, entry in kernels.items():
        for name, t in entry.get("times_s", {}).items():
            metrics.observe(f"tune/kernel/{op}/{name}_s", t)

    # 2) calibration: cached (rank 0's cache), or measured fresh
    cal = (cached_calibration(cache_path, key, copy_mb=triad_mb(dev))
           if cache_path and use_cache and not rank else None)
    cal = _from_rank0(shared, rank, "cached",
                      cal.to_dict() if cal is not None else None)
    if isinstance(cal, dict):
        cal = Calibration.from_dict(cal)
    measured: Dict[str, Any]
    overlap: Dict[str, Any] = {}
    metrics.set_gauge("tune/calibration_from_cache", float(cal is not None))
    if cal is not None:
        measured = {"from_cache": True, "cache_key": key,
                    **{k: v for k, v in cal.measured.items()}}
        if cal.bucket_mb > 0:  # the sweep ran (a measured 0.0 fraction counts)
            overlap = {"measured": True, "from_cache": True,
                       "chosen_bucket_mb": cal.bucket_mb,
                       "overlap_fraction": cal.overlap_fraction}
    else:
        with tracer.span("measure", steps=steps, dp=dp) as sp_m:
            measured = measure_train_steps(cfg_exec, batch=batch, seq=seq,
                                           steps=steps, dp=dp, seed=seed,
                                           topology=mesh.topology, **place)
            micro = host_microbench(device=dev, copy_mb=triad_mb(dev))
        metrics.observe("tune/measure_s", sp_m.elapsed_s)
        cal = fit_calibration(cfg_exec, batch=batch, seq=seq,
                              measured=measured, micro=micro,
                              backend=backend, cluster_name=cluster_name)
        # achieved comm/compute overlap + bucket sweet spot, calibrated
        # like the effective link bandwidth (dp >= 2 only: overlap needs
        # a data axis to hide anything under)
        with tracer.span("tune_overlap", dp=dp) as sp_o:
            overlap = tune_overlap(cfg_exec, batch=batch, seq=seq, dp=dp,
                                   seed=seed, bucket_mbs=overlap_bucket_mbs,
                                   topology=mesh.topology, **place)
        metrics.observe("tune/tune_overlap_s", sp_o.elapsed_s)
        if overlap.get("measured"):
            cal = replace(cal,
                          overlap_fraction=float(overlap["overlap_fraction"]),
                          bucket_mb=float(overlap["chosen_bucket_mb"]))
        fresh = _from_rank0(shared, rank, "measured",
                            {"measured": measured, "overlap": overlap,
                             "calibration": cal.to_dict()})
        measured, overlap = fresh["measured"], fresh["overlap"]
        cal = Calibration.from_dict(fresh["calibration"])
        if cache_path and not rank:
            save_calibration(cache_path, cal)
    metrics.set_gauge("tune/achieved_flops", cal.achieved_flops)
    metrics.set_gauge("tune/link_bw", cal.link_bw)
    if overlap.get("measured"):
        metrics.set_gauge("tune/overlap_fraction",
                          float(overlap.get("overlap_fraction", 0.0)))

    # 3) the paper's procedure on the production job + 4) re-plan on
    # measured constants
    with tracer.span("replan") as sp_r:
        base_plan = plan_fn(cfg_full, shape, mesh)
        minibatch = tune_minibatch(cfg_full, shape, mesh, base_plan)
        cal_mesh = cal.apply(mesh)
        tuned_plan = plan_fn(cfg_full, shape, cal_mesh)
    metrics.observe("tune/replan_s", sp_r.elapsed_s)

    # prediction check on the *executed* job: does the calibrated model land
    # nearer the wall clock than the data-sheet one?  (With a cached
    # calibration the wall clock is the cached run's, so the check re-uses
    # that run's batch/seq/dp.)
    b_chk, s_chk, dp_chk = batch, seq, dp
    if measured.get("from_cache"):
        b_chk = int(cal.measured.get("batch") or batch)
        s_chk = int(cal.measured.get("seq") or seq)
        dp_chk = int(cal.measured.get("dp") or max(dp, 1))
    exec_shape = ShapeConfig("tune-exec", s_chk, b_chk, "train")
    n_dev = max(dp_chk, 1)
    exec_mesh = MeshSpec(chips=n_dev, dp=n_dev, tp=1, chip=mesh.chip)
    mb_exec = max(b_chk // n_dev, 1)
    uncal_t = estimate_step_time(cfg_exec, exec_shape, exec_mesh,
                                 "none", mb_exec)["total"]
    cal_t = estimate_step_time(cfg_exec, exec_shape, cal.apply(exec_mesh),
                               "none", mb_exec)["total"]
    meas_t = float(measured.get("best_step_s", 0.0) or 0.0)
    replan = {
        "measured_step_s": meas_t,
        "est_step_time_uncalibrated_s": uncal_t,
        "est_step_time_calibrated_s": cal_t,
        "abs_err_uncalibrated_s": abs(uncal_t - meas_t),
        "abs_err_calibrated_s": abs(cal_t - meas_t),
        "calibrated_closer": abs(cal_t - meas_t) <= abs(uncal_t - meas_t),
        "flops_efficiency": cal.flops_efficiency(mesh.chip),
        "production": {
            "uncalibrated": {
                "est_step_time": base_plan.est_step_time,
                "sync_schedule": base_plan.sync_schedule,
                "microbatch": base_plan.microbatch,
            },
            "calibrated": {
                "est_step_time": tuned_plan.est_step_time,
                "sync_schedule": tuned_plan.sync_schedule,
                "microbatch": tuned_plan.microbatch,
            },
        },
    }
    metrics.set_gauge("tune/measured_step_s", meas_t)
    metrics.set_gauge("tune/est_step_calibrated_s", cal_t)
    metrics.set_gauge("tune/est_step_uncalibrated_s", uncal_t)
    return TuneResult(
        backend=backend, cluster=cluster_name, minibatch=minibatch,
        kernels=kernels, conv_alg=conv, calibration=cal, measured=measured,
        replan=replan, tuned_plan=tuned_plan, cache_path=str(cache_path),
        overlap=overlap)
