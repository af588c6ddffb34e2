"""Session — resolve a :class:`JobSpec` through the planner and execute it
(the port of ``repro.api.session``; ``plan``, ``dryrun``, ``tune``,
``train``, ``bench`` and ``serve``).

The planner (``core/planner.py``) sizes the job first, always on the FULL
architecture and the spec's production shape and mesh: microbatch,
attention algorithm, remat, sync schedule, Lemma 3.1's efficiency and
Lemma 3.2's comm time.  ``plan`` and ``dryrun`` stop at that prediction;
the measured kinds carry it beside the measurement.

**Where the port prices.**  ``mesh="single"`` is one 8 x H100 SXM node
(``h100-8``) and ``mesh="multi"`` two of them over InfiniBand
(``h100-2x8``), where the JAX package prices a 256- and a 512-chip TPU
v5e mesh: the port's numbers are the card's own.  A named ``topology``
resolves exactly as in JAX (so ``topology="2x4"`` prices on the same TPU
cluster in both packages), and the plan's ``topology.chip`` records what
it was priced on.

``Session.train()`` runs the training loop on the session's device
(``spec.dp == 0``), the 1F1B ``PipelineTrainer`` when ``spec.pipe > 1``
(``spec.dp`` or ``pipe`` entries in all, stage-major, driven by this one
process; a card may hold several stages: on one card every stage shares
it), or the data-parallel trainer on ``spec.dp`` ranks (one
thread each, or, in a process ``torchrun`` started, this process's rank:
``cuda:LOCAL_RANK`` on the job's ``TCPStore``) — the bounded-staleness
``AsyncPSTrainer`` when the spec asks for staleness or backup workers,
whose ``sync="auto"`` is the parameter server; otherwise ``sync="auto"``
is the plan's schedule (``DataParallelTrainer.from_plan``).  With
``use_planner`` the run adopts the plan's attention, remat, microbatch
and optimizer; without it the JAX package's defaults
(``RunConfig(attn_impl="auto", remat="block")``, AdamW with a tenth of
the steps as warmup).  It checkpoints into ``spec.ckpt_dir`` and resumes
from it.  ``bench`` is the same run reported as ``bench``.
``Session.serve()`` runs the spec's serving workload through the static
``BatchScheduler`` or the continuous scheduler over the paged KV cache
(sized by Eq. 5 on the mesh's chip), with GQA attention on the
hand-written kernels (``attn_impl="kernel"``: B1 for prefill, B2 for
decode, and a Mamba slot's prefill on B4) and MLA models on ``"dense"``
(:func:`serve_attn_impl`; JAX serves every model on ``"dense"``), and
reports the replica lemma's prediction beside its measurement.

``Session.tune()`` closes the loop on measurements
(``core/autotune.py``): it times the kernel variants (the four CUDA
kernels against their plain versions), measures short training steps,
fits a ``Calibration``, runs the paper's minibatch procedure and re-plans
on the measured constants.  With ``spec.tune``, ``train`` and ``bench``
adopt its attention and microbatch; a session built with
``calibration=`` prices every plan and prediction on measured constants.
Under ``torchrun`` every rank measures and adopts rank 0's choices.

``Session.sweep`` runs one of those six kinds per cell of a grid over
``JobSpec`` fields and collects the reports into a ``Campaign``
(``api/campaign.py``) with a throughput-vs-efficiency Pareto summary.

Every method returns a validated :class:`Report` whose ``measured`` dict
has the JAX package's keys (``pipeline`` for a pipelined run).  Options
whose modules are not ported (``pipe > 1`` under ``torchrun``: one
process a stage) raise ``NotImplementedError`` naming their ROADMAP item;
nothing falls back.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import time
from functools import partial
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.campaign import Campaign
from repro_torch.api.report import SERVING_SCHEMA_ID, Report
from repro_torch.api.spec import JobSpec
from repro_torch.configs.base import ModelConfig, get_config, get_shape
from repro_torch.core import amdahl, memory_model as mm, ps as ps_lib
from repro_torch.core.hardware import ClusterSpec, MeshSpec, get_cluster
from repro_torch.core.pipeline import pipeline_bubble
from repro_torch.core.planner import (Plan, estimate_step_time,
                                      plan as plan_fn, r_o_from_terms)
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import DeviceCountError, resolve_device
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs.trace import monotonic
from repro_torch.optim.adamw import OptConfig

if TYPE_CHECKING:  # core.autotune pulls in the kernels and the trainer
    from repro_torch.core.autotune import Calibration, TuneResult

# Lemma 3.1 efficiency/speedup are reported for these device counts (the
# paper's Fig. 4 sweep)
LEMMA31_G = (2, 4, 8, 16)
# the clusters the two meshes name: one H100 node, and two over InfiniBand
MESH_CLUSTERS = {"single": "h100-8", "multi": "h100-2x8"}


def serve_attn_impl(cfg: ModelConfig, device=None) -> str:
    """The attention algorithm ``Session.serve()`` runs ``cfg`` on:
    ``"kernel"`` where every attention slot is GQA (Mamba slots, mamba2
    and jamba, included: their prefill scan then runs on B4, their
    single-token step in plain PyTorch, as JAX's), ``"dense"`` for an MLA
    model, whose q/k and v head dims differ (the flash kernel, like JAX's
    Pallas kernel, takes one head dim; MLA decodes in the absorbed-latent
    form, which no kernel carries).  On a CUDA ``device`` a config whose
    dtype is not bf16 runs on ``"dense"`` too: the kernels take bf16 only
    (``kernels/_launch.py::check_inputs``), where on the CPU their plain
    versions take any dtype.

    On ``"kernel"`` every GQA prefill runs B1, with a sliding-window
    slot's window and the softcap (gemma2: window 4096 on its swa slots,
    cap 50 on all).  Decode runs B2 on every linear cache, whose slot j
    holds position j: the continuous engine's paged working cache at any
    ``s_max``, and the static engine's at ``s_max <= window``.  The
    static engine at ``s_max > window`` folds a swa slot's prefill into
    a ring of ``window`` slots, which can wrap; that slot decodes on
    plain ``"dense"``, as JAX decodes every slot
    (``models.attention.decode_impl``), and B2 launches once a step for
    each global slot only.  An int8 KV cache (``kv_quant``) decodes on
    ``"dense"`` too, as JAX's.  Chunked prefill (``prefill_chunk``) runs
    its chunks in plain PyTorch, as JAX's ``extend_step`` does."""
    mla = any(s.mixer.startswith("mla") for s in cfg.pattern)
    not_bf16_on_card = (cfg.dtype != "bfloat16" and device is not None
                        and torch.device(device).type == "cuda")
    return "dense" if mla or not_bf16_on_card else "kernel"


# What a sweep cell may raise and still be recorded as skipped: a spec that
# does not validate or a wrapper that refuses its inputs, more ranks than
# visible cards, running out of device memory, an option not ported.  All
# else propagates, a KernelError or any other CUDA error among it.
INFEASIBLE = (ValueError, DeviceCountError, torch.cuda.OutOfMemoryError,
              NotImplementedError)


class Session:
    """Execute one JobSpec on ``device`` (``cuda`` unless the caller asks
    for ``cpu``; ``cuda`` without a card raises here)."""

    def __init__(self, spec: JobSpec, *, config: Optional[ModelConfig] = None,
                 calibration: Optional["Calibration"] = None, device="cuda",
                 serve_params=None):
        self.spec = spec
        # the weights serve() runs on in place of the seeded init (a tree
        # as models.model.init_params gives), shared by every serve call
        self.serve_params = serve_params
        self.device = resolve_device(device)
        self.cfg_full = get_config(spec.arch)
        self.cfg = config if config is not None else (
            self.cfg_full.reduced() if spec.reduced else self.cfg_full)
        if spec.pipe > 1 and config is None and spec.reduced:
            # reduced() keeps one layer cycle, nothing to cut into stages:
            # deepen to two cycles a stage, as the JAX package does
            from repro_torch.models.model import main_cycles

            need = 2 * spec.pipe
            if main_cycles(self.cfg) < need:
                self.cfg = self.cfg.replace(
                    num_layers=self.cfg.first_k_dense
                    + need * len(self.cfg.pattern))
        self.shape = get_shape(spec.shape)
        # a named cluster pins the mesh geometry to its chip count (dp =
        # chips, tp = 1); the meshes name the H100 clusters
        self.cluster: ClusterSpec = get_cluster(
            spec.topology or MESH_CLUSTERS[spec.mesh])
        self.mesh_spec = MeshSpec.from_cluster(self.cluster)
        # a Calibration (core.autotune) re-prices the mesh on measured
        # constants: every plan and prediction this session emits uses them
        self.calibration = calibration
        if calibration is not None:
            self.mesh_spec = calibration.apply(self.mesh_spec)
            self.cluster = self.mesh_spec.topology
        self._config_override = config is not None
        self._plan: Optional[Plan] = None
        self._tuned: Optional["TuneResult"] = None
        # under torchrun: this process's rank and the job's store, made
        # once; each trainer built on it takes keys under a prefix of its own
        self._rank_place: Optional[Dict[str, Any]] = None
        self._runs = 0
        # telemetry of the last measured run, inspectable afterwards
        self.last_tracer: Optional[Tracer] = None
        self.last_metrics: Optional[MetricsRegistry] = None

    def _make_obs(self) -> Tuple[Tracer, MetricsRegistry]:
        tracer = Tracer(enabled=True)
        metrics = MetricsRegistry()
        self.last_tracer, self.last_metrics = tracer, metrics
        return tracer, metrics

    def _save_trace(self, kind: str, tracer: Tracer) -> Dict[str, Any]:
        if not self.spec.trace_dir:
            return {}
        path = Path(self.spec.trace_dir) / f"trace_{kind}.json"
        tracer.save(path)
        return {"trace_file": str(path), "trace_events": len(tracer)}

    # ------------------------------------------------------------------
    def _overlap_kwargs(self) -> Dict[str, Any]:
        """The overlap knobs every planner and pricing call shares: the
        spec's ``sync_overlap``/``bucket_mb``, with the hideable window
        derated to the *measured* overlap fraction when a calibration
        carries one."""
        eff = 1.0
        if self.calibration is not None and self.calibration.bucket_mb > 0:
            # bucket_mb > 0 marks a *ran* overlap sweep; its fraction is
            # the measurement even when it measured 0.0 (no hiding
            # achieved) — do not fall back to the ideal window then
            eff = self.calibration.overlap_fraction
        return dict(sync_overlap=self.spec.sync_overlap,
                    bucket_mb=self.spec.bucket_mb, overlap_efficiency=eff)

    @property
    def resolved_plan(self) -> Plan:
        if self._plan is None:
            self._plan = plan_fn(self.cfg_full, self.shape, self.mesh_spec,
                                 pipe=self.spec.pipe or None,
                                 n_microbatch=self.spec.n_microbatch,
                                 staleness=self.spec.staleness,
                                 backup_workers=self.spec.backup_workers,
                                 **self._overlap_kwargs())
        return self._plan

    @property
    def tuned(self) -> "TuneResult":
        """The autotuner's result for this spec (runs the microbenchmarks
        and the calibration on first access; kept for the session).  Its
        ``dp >= 2`` trainers are built as :meth:`_trainer` builds them:
        every rank in this process, one thread each, or, under
        ``torchrun``, this process's rank, which adopts rank 0's choices
        (rank 0 alone writes the cache)."""
        if self._tuned is None:
            from repro_torch.core import autotune

            spec = self.spec
            place: Dict[str, Any] = {"device": self.device}
            rank = self._torchrun_rank() if spec.dp else None
            if rank is not None:
                place = dict(rank, device=rank["devices"][0],
                             store=dist.PrefixStore("tune", rank["store"]))
            elif spec.dp >= 2:
                place["devices"] = self._dp_devices()
            tracer, metrics = self._make_obs()
            self._tuned = autotune.autotune(
                self.cfg, self.cfg_full, self.shape, self.mesh_spec,
                batch=spec.batch, seq=spec.seq, steps=spec.tune_steps,
                dp=spec.dp, seed=spec.seed, cache_path=spec.tune_cache,
                tracer=tracer, metrics=metrics, **place)
        return self._tuned

    def build_run_opt(self) -> Tuple[RunConfig, OptConfig]:
        """RunConfig/OptConfig for this spec: the plan's knobs when
        ``use_planner`` (its attention as ``dense`` or ``auto``, its remat,
        its microbatch capped at the batch, its optimizer), else the JAX
        package's defaults; then, with ``spec.tune``, the measured knobs
        (the tuned attention and the largest feasible microbatch)."""
        spec = self.spec
        warmup = max(spec.steps // 10, 1)
        if spec.use_planner:
            p = self.resolved_plan
            run = RunConfig(
                attn_impl="dense" if p.attn_impl == "dense" else "auto",
                remat=p.remat, microbatch=min(p.microbatch, spec.batch))
            opt = OptConfig(kind=p.opt_kind, lr=spec.lr, warmup_steps=warmup,
                            total_steps=spec.steps)
        else:
            run = RunConfig(attn_impl="auto", remat="block")
            opt = OptConfig(lr=spec.lr, warmup_steps=warmup,
                            total_steps=spec.steps)
        if spec.tune:
            t = self.tuned
            # chosen_microbatch == 0 means the production job fits at no
            # microbatch — fall back to the most frugal setting (1), never
            # to 0 (RunConfig's "no accumulation", the *maximal* footprint)
            run = dataclasses.replace(
                run, attn_impl=t.attn_impl(),
                microbatch=max(min(t.chosen_microbatch, spec.batch), 1))
        return run, opt

    # ------------------------------------------------------------------
    # Predictive kinds
    # ------------------------------------------------------------------
    def plan(self) -> Report:
        """Resolve the planner only: spec + plan + Lemma predictions."""
        return self._report("plan", {}, self._predicted())

    def dryrun(self) -> Report:
        """Analytic dry run: the plan plus the step-time roofline terms and
        the memory model's breakdown, no training."""
        p = self.resolved_plan
        pred = self._predicted()
        dp, tp = self.mesh_spec.dp, self.mesh_spec.tp
        if self.shape.kind in ("train", "prefill"):
            mem = mm.train_memory(
                self.cfg_full, self.shape, dp=dp, tp=tp, fsdp=p.fsdp,
                microbatch=p.microbatch, attn_impl=p.attn_impl, remat=p.remat,
                seq_parallel=p.seq_parallel, opt_kind=p.opt_kind)
        else:
            mem = mm.decode_memory(self.cfg_full, self.shape, dp=dp, tp=tp,
                                   fsdp=p.fsdp)
        pred["memory_bytes"] = {
            k: float(getattr(mem, k))
            for k in ("params", "grads", "opt_state", "activations",
                      "logits", "kv_cache")}
        pred["memory_bytes"]["total"] = float(mem.total)
        pred["fits"] = p.fits
        return self._report("dryrun", {}, pred)

    # ------------------------------------------------------------------
    # Measured kinds
    # ------------------------------------------------------------------
    def tune(self) -> Report:
        """Run the closed-loop autotuner (``core.autotune``): time the
        kernel variants, measure short trainer steps, calibrate the
        cluster constants, run the paper's minibatch and algorithm
        procedure, and re-plan on the measured numbers.  Returns a Report
        of kind ``tune`` whose ``measured["tuning"]`` section carries the
        ``repro.api/tuning/v1`` schema."""
        res = self.tuned
        measured: Dict[str, Any] = dict(res.measured)
        measured["tuning"] = res.section()
        if self.last_metrics is not None:
            measured["metrics"] = self.last_metrics.section()
        meta: Dict[str, Any] = {}
        rank = self._rank_place["rank"] if self._rank_place else None
        if rank is not None:  # one process per rank: rank 0 writes
            meta["process"] = {"rank": rank, "world": self.spec.dp}
        if not rank and self.last_tracer is not None:
            meta.update(self._save_trace("tune", self.last_tracer))
        return self._report("tune", measured, self._predicted(),
                            meta_extra=meta)

    def train(self) -> Report:
        """Run the training loop (``spec.dp == 0``), the 1F1B pipeline
        trainer (``spec.pipe > 1``) or the data-parallel trainer
        (``spec.dp > 0``)."""
        return self._run_train("train")

    def bench(self) -> Report:
        """A measured run reported as a benchmark artifact: the same
        execution as :meth:`train`, kind ``bench``."""
        return self._run_train("bench")

    @property
    def is_async(self) -> bool:
        """The spec runs the bounded-staleness parameter server."""
        return bool(self.spec.dp and (self.spec.staleness
                                      or self.spec.backup_workers))

    def _check_train_options(self) -> None:
        from repro_torch.distributed.trainer import torchrun_env

        spec = self.spec
        if spec.pipe > 1 and torchrun_env() is not None:
            raise NotImplementedError(
                f"pipe={spec.pipe} under torchrun: one process a stage, "
                "with point-to-point activation sends, is not ported yet "
                "(ROADMAP Next 19); run the pipeline from one process")

    def _dp_devices(self) -> List[torch.device]:
        """One device per rank (``distributed.trainer.rank_devices``):
        ``cuda:0..dp-1``, or the CPU for every rank when the session runs
        on the CPU."""
        from repro_torch.distributed.trainer import rank_devices

        return rank_devices(self.device, self.spec.dp)

    def _torchrun_rank(self) -> Optional[Dict[str, Any]]:
        """Under ``torchrun``: this process's one rank as the trainer's
        placement keywords (``devices`` — ``cuda:LOCAL_RANK``, or the CPU
        when the session runs there — ``rank``, ``world`` and the job's
        ``TCPStore``, made once a session); None outside a ``torchrun``
        job."""
        from repro_torch.distributed.trainer import (torchrun_env,
                                                     torchrun_store)

        if self._rank_place is not None:
            return self._rank_place
        env = torchrun_env()
        if env is None:
            return None
        if self.spec.dp != env.world:
            raise ValueError(f"dp={self.spec.dp} but torchrun started "
                             f"WORLD_SIZE={env.world} processes: run one "
                             "process per rank (--nproc-per-node dp)")
        dev = self.device
        if dev.type == "cuda":
            if env.local_rank >= torch.cuda.device_count():
                raise DeviceCountError(
                    f"LOCAL_RANK {env.local_rank} but only "
                    f"{torch.cuda.device_count()} cards visible")
            dev = torch.device("cuda", env.local_rank)
        self._rank_place = dict(devices=[dev], rank=env.rank,
                                world=env.world, store=torchrun_store(env))
        return self._rank_place

    def _trainer(self, run, opt, tracer, metrics):
        """The data-parallel trainer for ``spec.dp`` ranks (the
        ``AsyncPSTrainer`` for an async spec, whose ``sync="auto"`` is the
        parameter server, as in JAX; otherwise ``sync="auto"`` builds it
        from the plan, ``DataParallelTrainer.from_plan``): under
        ``torchrun``, this process's one rank (``cuda:LOCAL_RANK``, or the
        CPU when the session runs there) on the job's ``TCPStore``;
        otherwise every rank, one thread each."""
        from repro_torch.distributed.async_ps import AsyncPSTrainer
        from repro_torch.distributed.overlap import DEFAULT_BUCKET_MB
        from repro_torch.distributed.trainer import DataParallelTrainer

        spec = self.spec
        kw = dict(compression=spec.compress,
                  topology=(get_cluster(spec.topology) if spec.topology
                            else None),
                  tracer=tracer, metrics=metrics)
        if self.is_async:
            build = AsyncPSTrainer
            kw.update(staleness=spec.staleness,
                      backup_workers=spec.backup_workers,
                      strategy=("parameter_server" if spec.sync == "auto"
                                else spec.sync))
        else:
            kw.update(sync_overlap=spec.sync_overlap,
                      bucket_mb=spec.bucket_mb or DEFAULT_BUCKET_MB)
            if spec.sync == "auto":
                build = partial(DataParallelTrainer.from_plan,
                                self.resolved_plan)
            else:
                build = DataParallelTrainer
                kw.update(strategy=spec.sync)
        rank = self._torchrun_rank()
        if rank is None:
            return build(self.cfg, run, opt, devices=self._dp_devices(), **kw)
        self._runs += 1
        return build(self.cfg, run, opt, **dict(
            rank, store=dist.PrefixStore(f"run{self._runs}", rank["store"])),
            **kw)

    def _pipe_trainer(self, run, opt, tracer, metrics):
        """The 1F1B trainer for ``spec.pipe`` stages over ``spec.dp`` (or
        ``pipe``) entries, stage-major (``distributed.pipeline.
        pipeline_devices``), every stage driven by this process; the
        schedule owns the microbatches, so ``run.microbatch`` is 0, and
        ``sync="auto"`` takes the plan's strategy."""
        from repro_torch.distributed.pipeline import (PipelineTrainer,
                                                      pipeline_devices)

        spec = self.spec
        world = spec.dp or spec.pipe
        strategy = (self.resolved_plan.resolve_sync() if spec.sync == "auto"
                    else spec.sync)
        return PipelineTrainer(
            self.cfg, dataclasses.replace(run, microbatch=0), opt,
            pipe=spec.pipe, n_microbatch=spec.n_microbatch,
            strategy=strategy, compression=spec.compress,
            devices=pipeline_devices(self.device, world), tracer=tracer,
            metrics=metrics)

    def _run_train(self, kind: str) -> Report:
        from repro_torch.train.loop import train as train_loop

        spec = self.spec
        self._check_train_options()
        run, opt = self.build_run_opt()
        tracer, metrics = self._make_obs()
        loop_kw = dict(batch=spec.batch, seq=spec.seq, steps=spec.steps,
                       seed=spec.seed, log_every=spec.log_every,
                       ckpt_dir=spec.ckpt_dir or None,
                       ckpt_every=spec.ckpt_every)
        sync_rep, async_rep, pipe_rep, rank = None, None, None, None
        if spec.pipe > 1:
            trainer = self._pipe_trainer(run, opt, tracer, metrics)
            try:
                res = trainer.train(**loop_kw)
                sync_rep = trainer.report()
                pipe_rep = trainer.pipeline_report()
            finally:
                trainer.close()
        elif spec.dp:
            trainer = self._trainer(run, opt, tracer, metrics)
            rank = trainer.rank
            try:
                res = trainer.train(**loop_kw)
                sync_rep = trainer.report()
                if self.is_async:
                    async_rep = trainer.async_report()
            finally:
                trainer.close()
        else:
            res = train_loop(self.cfg, run, opt, device=self.device,
                             tracer=tracer, **loop_kw)
            # the loop has no phase-publishing step, so the session
            # publishes its StepTimes into the registry
            for t in res.step_times:
                metrics.inc("train/steps")
                metrics.observe("train/compute_s", t.compute)
                metrics.observe("train/dist_update_s", t.dist_update)
                metrics.observe("train/param_update_s", t.param_update)
                metrics.observe("train/step_s",
                                t.compute + t.dist_update + t.param_update)
        measured = res.summary()
        metrics.set_gauge("train/tokens_per_s", measured["tokens_per_s"])
        metrics.set_gauge("train/r_o", measured["r_o"])
        if sync_rep is not None:
            measured["sync"] = sync_rep.as_dict()
        if pipe_rep is not None:
            measured["pipeline"] = pipe_rep.as_dict()
        if async_rep is not None:
            measured["async_ps"] = async_rep.as_dict()
        if spec.tune:  # the run adopted tuned knobs: record what they were
            measured["tuning"] = self.tuned.section()
        measured["metrics"] = metrics.section()
        meta: Dict[str, Any] = {}
        if rank is not None:  # one process per rank: rank 0 writes
            meta["process"] = {"rank": rank, "world": spec.dp}
        if not rank:
            meta.update(self._save_trace(kind, tracer))
        return self._report(kind, measured,
                            self._predicted(measured_r_o=measured["r_o"]),
                            meta_extra=meta)

    # ------------------------------------------------------------------
    def serve(self) -> Report:
        """Batched generation, measured end to end.  ``spec.serve_mode``
        picks the runtime: ``continuous`` (in-flight batching over the
        paged KV cache) or ``static`` (the FIFO Engine/BatchScheduler).
        GQA models run attention on the kernels (B1 prefill, B2 decode)
        and Mamba slots their prefill scan on B4;
        an MLA model (minicpm3-4b, deepseek-v2-236b) runs on ``"dense"``,
        as JAX serves every model (:func:`serve_attn_impl`)."""
        if self.spec.serve_mode == "continuous":
            return self._serve_continuous()
        return self._serve_static()

    def _serve_workload(self):
        """The seeded synthetic workload both serve modes share: ragged
        prompt lengths in [8, 48) and ragged ``n_new`` in
        [max(1, n_new/4), n_new], prompts (n,) or (n, K) for a K-codebook
        model — the same draws as the JAX package."""
        spec, cfg = self.spec, self.cfg
        rng = np.random.default_rng(spec.seed)
        k = cfg.num_codebooks
        reqs = []
        for _ in range(spec.requests):
            n = int(rng.integers(8, 48))
            n_new = int(rng.integers(max(1, spec.n_new // 4),
                                     spec.n_new + 1))
            shape = (n, k) if k else (n,)
            prompt = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
            reqs.append((prompt, n, n_new))
        return reqs

    def kv_pool_blocks(self) -> int:
        """KV pool size: ``spec.max_kv_blocks`` when pinned, else the
        Eq. 5 analogue (``memory_model.max_kv_blocks`` on this mesh's chip)
        capped at this run's working set (``max_batch`` full-length rows —
        reduced configs would otherwise derive pools of millions of
        blocks)."""
        spec = self.spec
        if spec.max_kv_blocks:
            return spec.max_kv_blocks
        cap = spec.max_batch * math.ceil(spec.s_max / spec.kv_block)
        derived = mm.max_kv_blocks(self.cfg, self.mesh_spec.chip.hbm_bytes,
                                   block_size=spec.kv_block,
                                   max_batch=spec.max_batch)
        return min(derived, cap) if derived > 0 else cap

    @staticmethod
    def _latency_stats(latencies) -> Dict[str, float]:
        xs = np.asarray(sorted(latencies), float)
        return {"p50": float(np.percentile(xs, 50)),
                "p95": float(np.percentile(xs, 95)),
                "p99": float(np.percentile(xs, 99)),
                "mean": float(xs.mean()), "max": float(xs.max())}

    def _serving_section(self, *, mode: str, kv_stats: Dict[str, Any],
                         latencies, stats: Dict[str, Any], wall: float,
                         n_tokens: int, n_news, lengths,
                         metrics) -> Dict[str, Any]:
        """The ``repro.api/serving/v1`` block: the measured distribution
        and the inference replica lemma's prediction beside it."""
        spec = self.spec
        lat = self._latency_stats(latencies)
        tps = n_tokens / max(wall, 1e-9)
        # measured per-step decode time (the lemma's t_step, observed)
        dh = metrics.histogram("serve/decode_s")
        t_step_meas = dh.sum / dh.count if dh.count else 0.0
        ph = metrics.histogram("serve/prefill_s")
        t_pre_meas = ph.sum / ph.count if ph.count else 0.0
        # predicted t_step from the cost model: decode is HBM-bound —
        # stream bf16 weights + the resident KV once per step (priced on
        # this session's chip)
        chip = self.mesh_spec.chip
        param_bytes = 2.0 * mm.n_params(self.cfg)
        kv_bytes = spec.max_batch * spec.s_max * mm.kv_token_bytes(self.cfg)
        t_step_pred = ps_lib.decode_step_time(param_bytes, kv_bytes,
                                              chip.hbm_bw)
        mean_prompt = float(np.mean(list(lengths)))
        mean_n_new = float(np.mean(list(n_news)))
        # prefill prediction: per-token memory-bound like decode (crude
        # but unit-consistent; the measured column sits right next to it)
        t_pre_pred = mean_prompt * t_step_pred / max(spec.max_batch, 1)
        slo_s = spec.slo_ms / 1e3 if spec.slo_ms else 2.0 * lat["mean"]
        t_svc_pred = ps_lib.service_time(t_pre_pred, int(round(mean_n_new)),
                                         t_step_pred)
        # offered load for the lemma: spec-pinned, else 2x one replica
        rate = spec.arrival_rate or 2.0 * spec.max_batch / max(t_svc_pred,
                                                               1e-9)
        predicted = ps_lib.serve_replica_plan(
            arrival_rate=rate, t_prefill_s=t_pre_pred,
            t_step_s=t_step_pred, n_new=int(round(mean_n_new)),
            batch=spec.max_batch, slo_s=slo_s)
        return {
            "schema": SERVING_SCHEMA_ID,
            "mode": mode,
            "scheduler": {
                "max_batch": spec.max_batch,
                "requests": spec.requests,
                "arrival": spec.arrival,
                "prefill_chunk": spec.prefill_chunk,
            },
            "kv_cache": kv_stats,
            "latency_s": lat,
            "throughput": {
                "tokens_per_s": tps,
                "decode_token_steps": int(stats.get("decode_token_steps", 0)),
                "wasted_decode_steps": int(stats.get("wasted_decode_steps", 0)),
                "engine_steps": int(stats.get("engine_steps", 0)),
                "delivered_tokens": int(stats.get("delivered_tokens",
                                                  n_tokens)),
            },
            "slo": {"slo_s": slo_s, "attained": bool(lat["p99"] <= slo_s)},
            "replica_lemma": {
                "predicted": predicted,
                "measured": {
                    "t_step_s": t_step_meas,
                    "t_prefill_s": t_pre_meas,
                    "t_service_s": lat["mean"],
                    "tokens_per_s": tps,
                },
            },
        }

    @staticmethod
    def _per_request(results, latencies) -> List[Dict[str, Any]]:
        out = []
        for rid in sorted(results):
            toks = np.asarray(results[rid])
            out.append({"rid": rid, "tokens": int(toks.shape[0]),
                        "head": toks[:8].tolist(),
                        "latency_s": float(latencies.get(rid, 0.0))})
        return out

    _STATIC_KV_STATS = {"block_size": 0, "n_blocks": 0, "used_blocks": 0,
                        "peak_blocks": 0, "peak_occupancy": 0.0,
                        "shared_block_hits": 0, "block_bytes": 0.0}

    def _serve_static(self) -> Report:
        """The FIFO Engine/BatchScheduler runtime (linear cache)."""
        from repro_torch.serve.engine import BatchScheduler, Engine

        spec, cfg = self.spec, self.cfg
        tracer, metrics = self._make_obs()
        eng = Engine(cfg,
                     RunConfig(attn_impl=serve_attn_impl(cfg, self.device)),
                     self.serve_params, s_max=spec.s_max,
                     seed=spec.seed, device=self.device, tracer=tracer,
                     metrics=metrics)
        sched = BatchScheduler(eng, max_batch=spec.max_batch)
        lengths, n_news = [], []
        for prompt, n, n_new in self._serve_workload():
            sched.submit(prompt, n_new)
            lengths.append(n)
            n_news.append(n_new)
        t0 = monotonic()
        results = sched.run()
        wall = monotonic() - t0
        return self._finish("static", tracer, metrics, results, sched,
                            dict(self._STATIC_KV_STATS), lengths, n_news,
                            wall,
                            {"batches": [g.stats() for g in sched.history]})

    def _serve_continuous(self) -> Report:
        """In-flight batching over the paged KV cache."""
        from repro_torch.serve.arrivals import make_trace
        from repro_torch.serve.continuous import (ContinuousEngine,
                                                  ContinuousScheduler)
        from repro_torch.serve.kvcache import PagedKVCache

        spec, cfg = self.spec, self.cfg
        tracer, metrics = self._make_obs()
        eng = ContinuousEngine(cfg,
                               RunConfig(attn_impl=serve_attn_impl(
                                   cfg, self.device)),
                               self.serve_params,
                               s_max=spec.s_max, max_batch=spec.max_batch,
                               prefill_chunk=spec.prefill_chunk,
                               seed=spec.seed, device=self.device,
                               tracer=tracer, metrics=metrics)
        kv = PagedKVCache(cfg, block_size=spec.kv_block,
                          n_blocks=self.kv_pool_blocks(), s_max=spec.s_max,
                          device=self.device)
        sched = ContinuousScheduler(eng, kv)
        arrivals = make_trace(spec.arrival, spec.requests, seed=spec.seed)
        lengths, n_news = [], []
        for (prompt, n, n_new), step in zip(self._serve_workload(), arrivals):
            sched.submit(prompt, n_new, arrival_step=step)
            lengths.append(n)
            n_news.append(n_new)
        t0 = monotonic()
        results = sched.run()
        wall = monotonic() - t0
        return self._finish("continuous", tracer, metrics, results, sched,
                            kv.stats(), lengths, n_news, wall, {})

    def _finish(self, mode, tracer, metrics, results, sched, kv_stats,
                lengths, n_news, wall, extra) -> Report:
        spec = self.spec
        per_request = self._per_request(results, sched.latencies)
        n_tokens = sum(r["tokens"] for r in per_request)
        metrics.set_gauge("serve/wall_s", wall)
        metrics.set_gauge("serve/delivered_tokens_per_s",
                          n_tokens / max(wall, 1e-9))
        serving = self._serving_section(
            mode=mode, kv_stats=kv_stats,
            latencies=list(sched.latencies.values()), stats=sched.stats,
            wall=wall, n_tokens=n_tokens, n_news=n_news, lengths=lengths,
            metrics=metrics)
        measured = {
            "requests": spec.requests,
            "n_new": spec.n_new,
            "prompt_lengths": lengths,
            "n_tokens": n_tokens,
            "wall_s": wall,
            "tokens_per_s": n_tokens / max(wall, 1e-9),
            **extra,
            "per_request": per_request,
            "serving": serving,
            "metrics": metrics.section(),
        }
        return self._report("serve", measured, self._predicted(),
                            meta_extra=self._save_trace("serve", tracer))

    # ------------------------------------------------------------------
    # Campaigns: the paper's guidelines as one queryable sweep
    # ------------------------------------------------------------------
    SWEEP_KINDS = ("plan", "dryrun", "train", "bench", "serve", "tune")

    @classmethod
    def sweep(cls, base: JobSpec, grid: Dict[str, Sequence[Any]], *,
              kind: str = "plan", progress: bool = False,
              calibration: Optional["Calibration"] = None,
              device="cuda") -> Campaign:
        """Fan the cartesian product of ``grid`` out over ``base`` and run
        one Session method per cell on ``device``.

        ``grid`` maps JobSpec field names to the values to sweep; each cell
        is ``base.replace(**overrides)``, the keys taken in sorted order.
        ``kind`` picks what runs per cell: ``plan``/``dryrun`` stay
        predictive, ``train``/``bench``/``serve``/``tune`` execute.
        ``calibration`` (e.g. ``Session(spec).tuned.calibration``)
        re-prices every cell on measured constants.

        An infeasible cell (``INFEASIBLE``) lands in ``Campaign.skipped``
        with its error and the campaign goes on: a spec that does not
        validate, ``dp`` ranks beyond the visible cards, a cell that runs
        out of device memory, an option that is not ported.  Any other
        exception propagates: a kernel that fails to build or launch
        (``KernelError``), any other CUDA error, a bug of the port.  On a card each finished cell's session is dropped
        and collected before the next one starts, so its weights and
        optimizer state are not held while the next cell allocates.

        Predictive kinds only differentiate plan-affecting fields
        (``arch``/``shape``/``mesh``/``topology``/``sync_overlap``): sweep
        execution knobs (batch/compress/dp/sync) with ``kind="train"``.
        """
        if kind not in cls.SWEEP_KINDS:
            raise ValueError(f"sweep kind must be one of {cls.SWEEP_KINDS}, "
                             f"got {kind!r}")
        if not grid:
            raise ValueError("sweep needs a non-empty grid")
        dev = resolve_device(device)  # no card: raise here, not per cell
        keys = sorted(grid)
        values = [list(grid[k]) for k in keys]
        reports: List[Report] = []
        cells: List[Dict[str, Any]] = []
        skipped: List[Dict[str, Any]] = []
        for combo in itertools.product(*values):
            overrides = dict(zip(keys, combo))
            try:
                spec = base.replace(**overrides)
                rep = getattr(cls(spec, calibration=calibration,
                                  device=dev), kind)()
            except INFEASIBLE as e:  # record, keep sweeping
                skipped.append({"cell": overrides,
                                "error": f"{type(e).__name__}: {e}"})
                if progress:
                    print(f"sweep[{kind}] {overrides} SKIPPED: {e}")
                continue
            finally:
                if dev.type == "cuda":
                    gc.collect()
                    torch.cuda.empty_cache()
            reports.append(rep)
            cells.append(overrides)
            if progress:
                print(f"sweep[{kind}] {overrides} ok")
        return Campaign(kind=kind, grid={k: list(grid[k]) for k in keys},
                        cells=cells, reports=reports,
                        skipped=skipped).validate()

    # ------------------------------------------------------------------
    # Shared prediction / report assembly
    # ------------------------------------------------------------------
    def _predicted(self, *, measured_r_o: Optional[float] = None) -> Dict:
        p = self.resolved_plan
        out: Dict[str, Any] = {
            "est_step_time_s": p.est_step_time,
            "est_memory_gb": p.est_memory_gb,
            "efficiency_planned": p.efficiency,
        }
        # roofline terms (train-kind shapes only; decode is memory-bound)
        r_o_model = 0.0
        if self.shape.kind in ("train", "prefill"):
            terms = estimate_step_time(self.cfg_full, self.shape,
                                       self.mesh_spec, p.remat,
                                       max(p.microbatch, 1), pipe=p.pipe,
                                       n_microbatch=p.n_microbatch,
                                       **self._overlap_kwargs())
            out["step_time_terms"] = terms
            # with overlap on, only the exposed collective share is overhead
            r_o_model = r_o_from_terms(terms)
        if p.pipe > 1:
            out["pipeline"] = {
                "pipe": p.pipe,
                "n_microbatch": p.n_microbatch,
                "stage_cut": list(p.stage_cut or ()),
                "bubble_model": pipeline_bubble(p.pipe, p.n_microbatch),
            }
        # Lemma 3.1: efficiency/speedup curve from the best available R_O
        r_o = measured_r_o if measured_r_o is not None else r_o_model
        out["lemma31"] = {
            "r_o": r_o,
            "source": "measured" if measured_r_o is not None else "model",
            "per_device": {
                str(g): {"efficiency": amdahl.efficiency(g, r_o),
                         "speedup": amdahl.speedup(g, r_o)}
                for g in LEMMA31_G},
        }
        # Lemma 3.2: comm-time prediction for the planned schedule, priced
        # on the plan's topology tiers
        if p.sync_schedule in ("-", "") or not p.grad_bytes or p.link_bw <= 0:
            out["lemma32"] = {"schedule": p.sync_schedule or "-"}
            return out
        dp = p.mesh[0]
        t_c = (p.est_step_time if math.isfinite(p.est_step_time) else 1.0)
        n_ps = ps_lib.n_parameter_servers(p.grad_bytes, dp, p.link_bw,
                                          max(t_c, 1e-9))
        comm = ps_lib.predicted_comm_time(
            p.sync_schedule, p.grad_bytes, dp, p.link_bw, n_ps=n_ps,
            tiers=p.dp_tiers())
        out["lemma32"] = {
            "schedule": p.sync_schedule,
            "dp": dp,
            "grad_bytes": p.grad_bytes,
            "link_bw": p.link_bw,
            "n_parameter_servers": n_ps,
            "predicted_comm_s": comm,
            "t_c_s": t_c,
            "masked": comm <= t_c,
            "bottleneck_tier": p.bottleneck_tier,
        }
        if p.sync_overlap:
            # the overlapped refinement of the same lemma: comm that stays
            # exposed after hiding under the backward pass
            n_buckets = ps_lib.bucket_count(p.grad_bytes, p.bucket_mb)
            eff = self._overlap_kwargs()["overlap_efficiency"]
            exposed = ps_lib.overlap_exposed_comm(
                comm, (1.0 - ps_lib.FWD_FRACTION) * t_c, n_buckets,
                overlap_efficiency=eff)
            out["lemma32"]["overlap"] = {
                "n_buckets": n_buckets,
                "bucket_mb": p.bucket_mb or ps_lib.DEFAULT_BUCKET_MB,
                "overlap_efficiency": eff,
                "exposed_comm_s": exposed,
                "hidden_comm_s": comm - exposed,
                "masked_after_overlap": exposed <= t_c,
            }
        cluster = p.cluster
        if cluster is not None and not cluster.uniform:
            # tier-aware PS placement: B_ps in-node vs cross-node
            out["lemma32"]["ps_placement"] = ps_lib.ps_placement_plan(
                p.grad_bytes, dp, cluster, max(t_c, 1e-9))
        if self.spec.staleness or self.spec.backup_workers:
            # bounded-staleness refinement: pull traffic amortized over s+1
            # steps, straggler wait bought back by backup workers
            out["lemma32"]["async_ps"] = ps_lib.async_step_time(
                p.grad_bytes, dp, n_ps, p.link_bw, max(t_c, 1e-9),
                staleness=self.spec.staleness,
                backup_workers=self.spec.backup_workers)
        return out

    def report_meta(self) -> Dict[str, Any]:
        """Provenance shared by every Report this session emits: the config
        that executed (which, with ``config=`` or ``reduced=True``, differs
        from the arch the spec and plan name) and the device it ran on."""
        dev = self.device
        meta: Dict[str, Any] = {
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "executed_config": {
                "name": self.cfg.name,
                "d_model": self.cfg.d_model,
                "num_layers": self.cfg.num_layers,
                "vocab_size": self.cfg.vocab_size,
                "n_params": int(mm.n_params(self.cfg)),
            },
            "config_override": self._config_override,
            "device": {
                "type": dev.type,
                "name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu"),
                "count": torch.cuda.device_count() if dev.type == "cuda" else 1,
            },
        }
        if self.calibration is not None:
            meta["calibration"] = {
                "key": self.calibration.key,
                "achieved_flops": self.calibration.achieved_flops,
                "link_bw": self.calibration.link_bw,
            }
        if (self.spec.topology and self.spec.dp
                and self.spec.dp != self.cluster.n_chips):
            meta["topology_note"] = (
                f"spec.dp={self.spec.dp} != topology "
                f"{self.spec.topology!r} chips={self.cluster.n_chips}: "
                "predicted blocks are priced on the full topology; the "
                "measured run executes on spec.dp devices, where the sync "
                "strategy may degenerate (see measured.sync.tiers)")
        return meta

    def _report(self, kind: str, measured: Dict, predicted: Dict, *,
                meta_extra: Optional[Dict[str, Any]] = None) -> Report:
        meta = self.report_meta()
        if meta_extra:
            meta.update(meta_extra)
        return Report(kind=kind, spec=self.spec.to_dict(),
                      plan=self.resolved_plan.to_dict(),
                      measured=measured, predicted=predicted,
                      meta=meta).validate()
