"""Session — execute a :class:`JobSpec` (the port of
``repro.api.session``; ``serve`` only).

``Session.serve()`` runs the spec's serving workload through the static
``BatchScheduler`` or the continuous scheduler over the paged KV cache,
with attention on the hand-written kernels (``attn_impl="kernel"``), and
returns a :class:`ServeReport` whose ``measured`` dict has the same keys as
the JAX package's.  The serving section carries the measured half of the
replica lemma only: its prediction and the Eq.-5-derived KV pool need the
planner math (``core/ps``, ``core/memory_model``, ``core/hardware``),
which is not ported yet (ROADMAP).  The pool is the working-set cap
``max_batch * ceil(s_max / kv_block)`` unless ``max_kv_blocks`` pins it.
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

SERVING_SCHEMA_ID = "repro.api/serving/v1"


@dataclass
class ServeReport:
    """What ``Session.serve`` returns: the spec, the measured dict, and
    provenance (the config that ran and the device it ran on)."""

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
    def serve(self) -> ServeReport:
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

    def _serve_static(self) -> ServeReport:
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

    def _serve_continuous(self) -> ServeReport:
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
                lengths, wall, extra) -> ServeReport:
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
        return ServeReport("serve", spec.to_dict(), measured, meta)

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
