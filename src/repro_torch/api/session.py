"""Session — execute a :class:`JobSpec` (the port of
``repro.api.session``; ``train``, ``bench`` and ``serve``).

``Session.train()`` runs the training loop on the session's device
(``spec.dp == 0``) or the data-parallel trainer on ``spec.dp`` ranks (one
thread each, or, in a process ``torchrun`` started, this process's rank:
``cuda:LOCAL_RANK`` on the job's ``TCPStore``) — the bounded-staleness
``AsyncPSTrainer`` when the spec asks for staleness or backup workers —
with the JAX package's run configuration when the planner is off
(``RunConfig(attn_impl="auto", remat="block")``, AdamW with a tenth of the
steps as warmup), checkpointing into ``spec.ckpt_dir`` and resuming from
it.  ``bench`` is the same run reported as ``bench``.
``Session.serve()`` runs the spec's serving workload through the static
``BatchScheduler`` or the continuous scheduler over the paged KV cache,
with attention on the hand-written kernels (``attn_impl="kernel"``).

Every method returns a :class:`Report` whose ``measured`` dict has the JAX
package's keys.  The planner's ``predicted`` block is left out: the
planner (``core/planner.py``) is not ported yet, so there is no
prediction to report.  For the same reason the serving section carries
the measured half of the replica lemma only, and the KV pool is the
working-set cap ``max_batch * ceil(s_max / kv_block)`` unless
``max_kv_blocks`` pins it.  Options whose modules are not ported raise
``NotImplementedError`` naming their ROADMAP item; nothing falls back.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.spec import JobSpec
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import param_count, resolve_device
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs.trace import monotonic
from repro_torch.optim.adamw import OptConfig

SERVING_SCHEMA_ID = "repro.api/serving/v1"


@dataclass
class Report:
    """What a Session method returns: the kind (train | bench | serve), the
    spec, the measured dict, and provenance (the config that ran and the
    device it ran on)."""

    kind: str
    spec: Dict[str, Any]
    measured: Dict[str, Any]
    meta: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "spec": self.spec,
                "measured": self.measured, "meta": self.meta}

    def save(self, path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_dict(), indent=2))
        return p


class Session:
    """Execute one JobSpec on ``device`` (``cuda`` unless the caller asks
    for ``cpu``; ``cuda`` without a card raises here)."""

    def __init__(self, spec: JobSpec, *, config: Optional[ModelConfig] = None,
                 device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.cfg_full = get_config(spec.arch)
        self.cfg = config if config is not None else (
            self.cfg_full.reduced() if spec.reduced else self.cfg_full)
        self._config_override = config is not None
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
    def build_run_opt(self) -> Tuple[RunConfig, OptConfig]:
        """RunConfig/OptConfig for this spec: the JAX package's settings
        without the planner."""
        spec = self.spec
        if spec.use_planner:
            raise NotImplementedError(
                "use_planner: the planner (core/planner.py) is not ported "
                "yet (ROADMAP Next 5)")
        if spec.tune:
            raise NotImplementedError(
                "tune: the autotuner beyond bench_kernels is not ported yet "
                "(ROADMAP Next 6, the rest of Session.tune())")
        run = RunConfig(attn_impl="auto", remat="block")
        opt = OptConfig(lr=spec.lr, warmup_steps=max(spec.steps // 10, 1),
                        total_steps=spec.steps)
        return run, opt

    def train(self) -> Report:
        """Run the training loop (``spec.dp == 0``) or the data-parallel
        trainer (``spec.dp > 0``)."""
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
        spec = self.spec
        if spec.pipe > 1:
            raise NotImplementedError(
                f"pipe={spec.pipe}: 1F1B pipeline parallelism "
                "(distributed/pipeline.py) is not ported yet (ROADMAP Next 3)")
        if spec.dp and spec.sync == "auto" and not self.is_async:
            raise NotImplementedError(
                "sync='auto' with dp > 0 resolves the planner's "
                "sync_schedule (DataParallelTrainer.from_plan); the planner "
                "is not ported yet (ROADMAP Next 5): name a schedule")

    def _dp_devices(self) -> List[torch.device]:
        """One device per rank: ``cuda:0..dp-1``, or the CPU for every
        rank when the session runs on the CPU."""
        dp = self.spec.dp
        if self.device.type == "cpu":
            return [self.device] * dp
        n = torch.cuda.device_count()
        if n < dp:
            raise RuntimeError(f"dp={dp} but only {n} devices visible")
        return [torch.device("cuda", i) for i in range(dp)]

    def _trainer(self, run, opt, tracer, metrics):
        """The data-parallel trainer for ``spec.dp`` ranks (the
        ``AsyncPSTrainer`` for an async spec, whose ``sync="auto"`` is the
        parameter server, as in JAX): under ``torchrun``, this process's
        one rank (``cuda:LOCAL_RANK``, or the CPU when the session runs
        there) on the job's ``TCPStore``; otherwise every rank, one thread
        each."""
        from repro_torch.core.hardware import get_cluster
        from repro_torch.distributed.async_ps import AsyncPSTrainer
        from repro_torch.distributed.overlap import DEFAULT_BUCKET_MB
        from repro_torch.distributed.trainer import (DataParallelTrainer,
                                                     torchrun_env,
                                                     torchrun_store)

        spec = self.spec
        kw = dict(compression=spec.compress,
                  topology=(get_cluster(spec.topology) if spec.topology
                            else None),
                  tracer=tracer, metrics=metrics)
        if self.is_async:
            cls = AsyncPSTrainer
            kw.update(staleness=spec.staleness,
                      backup_workers=spec.backup_workers,
                      strategy=("parameter_server" if spec.sync == "auto"
                                else spec.sync))
        else:
            cls = DataParallelTrainer
            kw.update(strategy=spec.sync, sync_overlap=spec.sync_overlap,
                      bucket_mb=spec.bucket_mb or DEFAULT_BUCKET_MB)
        env = torchrun_env()
        if env is None:
            return cls(self.cfg, run, opt, devices=self._dp_devices(), **kw)
        if spec.dp != env.world:
            raise ValueError(f"dp={spec.dp} but torchrun started "
                             f"WORLD_SIZE={env.world} processes: run one "
                             "process per rank (--nproc-per-node dp)")
        dev = self.device
        if dev.type == "cuda":
            if env.local_rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {env.local_rank} but only "
                    f"{torch.cuda.device_count()} cards visible")
            dev = torch.device("cuda", env.local_rank)
        return cls(self.cfg, run, opt, devices=[dev], rank=env.rank,
                   world=env.world, store=torchrun_store(env), **kw)

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
        sync_rep, async_rep, rank = None, None, None
        if spec.dp:
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
        if async_rep is not None:
            measured["async_ps"] = async_rep.as_dict()
        measured["metrics"] = metrics.section()
        meta = self.report_meta()
        if rank is not None:  # one process per rank: rank 0 writes
            meta["process"] = {"rank": rank, "world": spec.dp}
        if not rank:
            meta.update(self._save_trace(kind, tracer))
        return Report(kind, spec.to_dict(), measured, meta)

    # ------------------------------------------------------------------
    def serve(self) -> Report:
        """Batched generation, measured end to end.  ``spec.serve_mode``
        picks the runtime: ``continuous`` (in-flight batching over the
        paged KV cache) or ``static`` (the FIFO Engine/BatchScheduler)."""
        if self.spec.serve_mode == "continuous":
            return self._serve_continuous()
        return self._serve_static()

    def _serve_workload(self):
        """The seeded synthetic workload both serve modes share: ragged
        prompt lengths in [8, 48) and ragged ``n_new`` in
        [max(1, n_new/4), n_new] — the same draws as the JAX package."""
        spec, cfg = self.spec, self.cfg
        rng = np.random.default_rng(spec.seed)
        reqs = []
        for _ in range(spec.requests):
            n = int(rng.integers(8, 48))
            n_new = int(rng.integers(max(1, spec.n_new // 4),
                                     spec.n_new + 1))
            prompt = rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            reqs.append((prompt, n, n_new))
        return reqs

    def kv_pool_blocks(self) -> int:
        """KV pool size: ``spec.max_kv_blocks`` when pinned, else the run's
        working set (``max_batch`` full-length rows)."""
        spec = self.spec
        if spec.max_kv_blocks:
            return spec.max_kv_blocks
        return spec.max_batch * math.ceil(spec.s_max / spec.kv_block)

    @staticmethod
    def _latency_stats(latencies) -> Dict[str, float]:
        xs = np.asarray(sorted(latencies), float)
        return {"p50": float(np.percentile(xs, 50)),
                "p95": float(np.percentile(xs, 95)),
                "p99": float(np.percentile(xs, 99)),
                "mean": float(xs.mean()), "max": float(xs.max())}

    def _serving_section(self, *, mode: str, kv_stats: Dict[str, Any],
                         latencies, stats: Dict[str, Any], wall: float,
                         n_tokens: int, metrics) -> Dict[str, Any]:
        """The ``repro.api/serving/v1`` block, measured numbers only."""
        spec = self.spec
        lat = self._latency_stats(latencies)
        tps = n_tokens / max(wall, 1e-9)
        dh = metrics.histogram("serve/decode_s")
        ph = metrics.histogram("serve/prefill_s")
        slo_s = spec.slo_ms / 1e3 if spec.slo_ms else 2.0 * lat["mean"]
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
                "measured": {
                    "t_step_s": dh.sum / dh.count if dh.count else 0.0,
                    "t_prefill_s": ph.sum / ph.count if ph.count else 0.0,
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
        eng = Engine(cfg, RunConfig(attn_impl="kernel"), s_max=spec.s_max,
                     seed=spec.seed, device=self.device, tracer=tracer,
                     metrics=metrics)
        sched = BatchScheduler(eng, max_batch=spec.max_batch)
        lengths = []
        for prompt, n, n_new in self._serve_workload():
            sched.submit(prompt, n_new)
            lengths.append(n)
        t0 = monotonic()
        results = sched.run()
        wall = monotonic() - t0
        return self._finish("static", tracer, metrics, results, sched,
                            dict(self._STATIC_KV_STATS), lengths, wall,
                            {"batches": [g.stats() for g in sched.history]})

    def _serve_continuous(self) -> Report:
        """In-flight batching over the paged KV cache."""
        from repro_torch.serve.arrivals import make_trace
        from repro_torch.serve.continuous import (ContinuousEngine,
                                                  ContinuousScheduler)
        from repro_torch.serve.kvcache import PagedKVCache

        spec, cfg = self.spec, self.cfg
        tracer, metrics = self._make_obs()
        eng = ContinuousEngine(cfg, RunConfig(attn_impl="kernel"),
                               s_max=spec.s_max, max_batch=spec.max_batch,
                               prefill_chunk=spec.prefill_chunk,
                               seed=spec.seed, device=self.device,
                               tracer=tracer, metrics=metrics)
        kv = PagedKVCache(cfg, block_size=spec.kv_block,
                          n_blocks=self.kv_pool_blocks(), s_max=spec.s_max,
                          device=self.device)
        sched = ContinuousScheduler(eng, kv)
        arrivals = make_trace(spec.arrival, spec.requests, seed=spec.seed)
        lengths = []
        for (prompt, n, n_new), step in zip(self._serve_workload(), arrivals):
            sched.submit(prompt, n_new, arrival_step=step)
            lengths.append(n)
        t0 = monotonic()
        results = sched.run()
        wall = monotonic() - t0
        return self._finish("continuous", tracer, metrics, results, sched,
                            kv.stats(), lengths, wall, {})

    def _finish(self, mode, tracer, metrics, results, sched, kv_stats,
                lengths, wall, extra) -> Report:
        spec = self.spec
        per_request = self._per_request(results, sched.latencies)
        n_tokens = sum(r["tokens"] for r in per_request)
        metrics.set_gauge("serve/wall_s", wall)
        metrics.set_gauge("serve/delivered_tokens_per_s",
                          n_tokens / max(wall, 1e-9))
        serving = self._serving_section(
            mode=mode, kv_stats=kv_stats,
            latencies=list(sched.latencies.values()), stats=sched.stats,
            wall=wall, n_tokens=n_tokens, metrics=metrics)
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
        meta = self.report_meta()
        meta.update(self._save_trace("serve", tracer))
        return Report("serve", spec.to_dict(), measured, meta)

    def report_meta(self) -> Dict[str, Any]:
        """Provenance: the config that executed and the device it ran on."""
        dev = self.device
        return {
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "executed_config": {
                "name": self.cfg.name,
                "d_model": self.cfg.d_model,
                "num_layers": self.cfg.num_layers,
                "vocab_size": self.cfg.vocab_size,
                "n_params": param_count(M.model_specs(self.cfg)),
            },
            "config_override": self._config_override,
            "device": {
                "type": dev.type,
                "name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu"),
                "count": torch.cuda.device_count() if dev.type == "cuda" else 1,
            },
        }
