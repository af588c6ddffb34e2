"""Report — the one JSON artifact every entry point emits (a copy of
``repro.api.report``: the same schema, so either package validates the
other's reports).

    {"schema": "repro.api/report/v1",
     "kind":   plan | dryrun | train | serve | bench | tune,
     "spec":      the JobSpec that produced it,
     "plan":      the planner's Plan (runtime knobs + Lemma 3.1/3.2 inputs),
     "measured":  StepTimes means / SyncReport / serving stats (empty for
                  the purely predictive kinds),
     "predicted": Lemma 3.1 efficiency/speedup + Lemma 3.2 comm time +
                  the napkin step-time model,
     "meta":      free-form provenance}

``validate_report`` is the shared schema check: every report the port's
``Session`` returns has passed it, ``Session.tune()``'s tuning section
(``repro.api/tuning/v1``) too.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Union

from repro_torch.obs.metrics import validate_metrics

SCHEMA_ID = "repro.api/report/v1"
# the autotuner's section under measured["tuning"] (Session.tune emits it;
# the autotuner's TUNING_SCHEMA_ID mirrors this literal — layering keeps
# core from importing api)
TUNING_SCHEMA_ID = "repro.api/tuning/v1"
# the serving runtime's section under measured["serving"] (Session.serve
# emits it; the serve layer mirrors nothing — the literal lives here and the
# serve layer stays unimported, same layering rule as TUNING_SCHEMA_ID)
SERVING_SCHEMA_ID = "repro.api/serving/v1"
KINDS = ("plan", "dryrun", "train", "serve", "bench", "tune")

# kinds whose `measured` section must be populated, and the keys that make a
# measurement comparable across entry points (bench artifacts range from a
# full trajectory to a throughput sweep, so only the headline is required)
_MEASURED_REQUIRED = {
    "train": ("steps", "loss_last", "tokens_per_s", "r_o", "step_times_mean",
              "metrics"),
    "bench": ("tokens_per_s", "metrics"),
    "serve": ("requests", "tokens_per_s", "metrics", "serving"),
    "tune": ("tuning",),
}
# any report carrying a tuning section (kind "tune", or a train run that
# adopted tuned knobs) must carry a complete one
_TUNING_REQUIRED = ("minibatch", "kernels", "calibration", "replan")
_SPEC_REQUIRED = ("arch", "shape", "reduced", "steps", "batch", "seq", "seed")
_PLAN_REQUIRED = ("arch", "mesh", "microbatch", "attn_impl", "remat",
                  "sync_schedule", "est_step_time")
_PREDICTED_REQUIRED = ("lemma31", "lemma32")


@dataclass
class Report:
    kind: str
    spec: Dict[str, Any]
    plan: Dict[str, Any]
    measured: Dict[str, Any] = field(default_factory=dict)
    predicted: Dict[str, Any] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {"schema": SCHEMA_ID, **d}

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json())
        return p

    def validate(self) -> "Report":
        validate_report(self.to_dict())
        return self

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Report":
        validate_report(d)
        return cls(kind=d["kind"], spec=d["spec"], plan=d["plan"],
                   measured=d.get("measured", {}),
                   predicted=d.get("predicted", {}), meta=d.get("meta", {}))

    @classmethod
    def from_json(cls, s: str) -> "Report":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Shared schema check (hand-rolled: no jsonschema dependency in the image)
# ---------------------------------------------------------------------------


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"invalid Report: {msg}")


def validate_report(d: Dict[str, Any]) -> Dict[str, Any]:
    """Raise ValueError unless ``d`` is a valid v1 Report dict; returns it."""
    _require(isinstance(d, dict), f"expected dict, got {type(d).__name__}")
    for key in ("schema", "kind", "spec", "plan", "measured", "predicted"):
        _require(key in d, f"missing top-level key {key!r}")
    _require(d["schema"] == SCHEMA_ID,
             f"schema {d['schema']!r} != {SCHEMA_ID!r}")
    _require(d["kind"] in KINDS, f"kind {d['kind']!r} not in {KINDS}")
    for sect in ("spec", "plan", "measured", "predicted"):
        _require(isinstance(d[sect], dict), f"{sect} must be a dict")
    for key in _SPEC_REQUIRED:
        _require(key in d["spec"], f"spec missing {key!r}")
    for key in _PLAN_REQUIRED:
        _require(key in d["plan"], f"plan missing {key!r}")
    for key in _PREDICTED_REQUIRED:
        _require(key in d["predicted"], f"predicted missing {key!r}")
    need = _MEASURED_REQUIRED.get(d["kind"], ())
    for key in need:
        _require(key in d["measured"],
                 f"measured missing {key!r} for kind {d['kind']!r}")
    if "pipe" in d["plan"]:
        _validate_pipe(d["plan"])
    if "tuning" in d["measured"]:
        _validate_tuning(d["measured"]["tuning"])
    if "serving" in d["measured"]:
        _validate_serving(d["measured"]["serving"])
    if "sync" in d["measured"]:
        _validate_sync(d["measured"]["sync"])
    if "async_ps" in d["measured"]:
        _validate_async(d["measured"]["async_ps"])
    spec = d["spec"]
    if (d["kind"] in ("train", "bench")
            and (spec.get("staleness") or spec.get("backup_workers"))):
        _require("async_ps" in d["measured"],
                 f"kind {d['kind']!r} with spec.staleness/backup_workers "
                 "must carry a measured.async_ps section")
    if "metrics" in d["measured"]:
        # any report may carry telemetry; delegate to repro_torch.obs.metrics
        validate_metrics(d["measured"]["metrics"])
    return d


def _validate_pipe(plan: Dict[str, Any]):
    """Pipeline-shape invariants, checked whenever a plan declares a
    ``pipe`` field (legacy plan dicts without one skip this — ``Plan``'s
    from_dict migration fills the no-pipelining defaults): the stage count
    must be a positive divisor of the world the topology names
    (``pipe * dp * tp == world``), and 1F1B needs at least ``pipe``
    microbatches to fill its warmup."""
    pipe = plan["pipe"]
    _require(isinstance(pipe, int) and pipe >= 1,
             f"plan.pipe must be an int >= 1, got {pipe!r}")
    if pipe <= 1:
        return
    _require("n_microbatch" in plan,
             "pipelined plan (pipe > 1) missing 'n_microbatch'")
    m = plan["n_microbatch"]
    _require(isinstance(m, int) and m >= pipe,
             f"plan.n_microbatch {m!r} must be an int >= pipe {pipe} "
             "(1F1B needs a full warmup)")
    topo = plan.get("topology")
    if isinstance(topo, dict) and topo.get("tiers"):
        world = 1
        for t in topo["tiers"]:
            world *= int(t["size"])
        dp, tp = plan["mesh"]
        _require(pipe * int(dp) * int(tp) == world,
                 f"plan.pipe * dp * tp = {pipe}*{dp}*{tp} != world {world} "
                 "(topology tier-size product)")


# keys an overlapped SyncReport must carry in measured["sync"] (see
# repro_torch.distributed.trainer.SyncReport's bucketed-overlap block and
# docs/schemas.md)
_SYNC_OVERLAP_REQUIRED = ("n_buckets", "overlap_fraction",
                          "exposed_comm_time", "measured_comm_s",
                          "bucket_sizes_bytes", "per_bucket_comm_s",
                          "overlapped_step_s")


def _validate_sync(s: Any):
    """Schema check for a measured SyncReport dict; the overlap fields are
    required — and bounded — whenever the run declared ``sync_overlap``."""
    _require(isinstance(s, dict),
             f"measured.sync must be a dict, got {type(s).__name__}")
    for key in ("strategy", "dp", "measured_comm_s", "predicted_comm_s"):
        _require(key in s, f"measured.sync missing {key!r}")
    if not s.get("sync_overlap"):
        return
    for key in _SYNC_OVERLAP_REQUIRED:
        _require(key in s, f"overlapped measured.sync missing {key!r}")
    frac = s["overlap_fraction"]
    _require(isinstance(frac, (int, float)) and 0.0 <= frac <= 1.0,
             f"sync.overlap_fraction must be in [0, 1], got {frac!r}")
    _require(int(s["n_buckets"]) >= 1,
             f"sync.n_buckets must be >= 1, got {s['n_buckets']!r}")
    _require(float(s["exposed_comm_time"])
             <= float(s["measured_comm_s"]) + 1e-12,
             "sync.exposed_comm_time exceeds the serial measured_comm_s")


# the bounded-staleness async-PS section under measured["async_ps"] (see
# repro_torch.distributed.async_ps.AsyncPSReport and docs/checkpointing.md)
_ASYNC_REQUIRED = ("staleness", "backup_workers", "dp", "steps", "refreshes",
                   "mean_age", "max_age", "drops", "t_step_model")


def _validate_async(a: Any):
    """Schema check for a measured AsyncPSReport dict: staleness bounds the
    measured worker-param ages (the trainer's core invariant), drops are
    consistent with the backup-worker count, and the cost-model terms from
    :func:`repro_torch.core.ps.async_step_time` ride along."""
    _require(isinstance(a, dict),
             f"measured.async_ps must be a dict, got {type(a).__name__}")
    for key in _ASYNC_REQUIRED:
        _require(key in a, f"measured.async_ps missing {key!r}")
    s = a["staleness"]
    _require(isinstance(s, int) and s >= 0,
             f"async_ps.staleness must be an int >= 0, got {s!r}")
    _require(float(a["max_age"]) <= s + 1e-12,
             f"async_ps.max_age {a['max_age']!r} exceeds the staleness "
             f"bound {s} — the trainer's invariant is broken")
    _require(0.0 <= float(a["mean_age"]) <= float(a["max_age"]) + 1e-12,
             "async_ps.mean_age must be in [0, max_age]")
    k = a["backup_workers"]
    _require(isinstance(k, int) and 0 <= k < int(a["dp"]),
             f"async_ps.backup_workers must be in [0, dp), got {k!r}")
    _require(int(a["drops"]) == k * int(a["steps"]),
             f"async_ps.drops {a['drops']!r} != backup_workers * steps "
             f"({k} * {a['steps']!r})")
    model = a["t_step_model"]
    _require(isinstance(model, dict),
             f"async_ps.t_step_model must be a dict, "
             f"got {type(model).__name__}")
    for key in ("push", "pull", "straggler_wait", "efficiency", "wall_step"):
        _require(key in model, f"async_ps.t_step_model missing {key!r}")


# the ``repro.api/serving/v1`` section: scheduler configuration, KV-block
# occupancy, the latency distribution, throughput accounting, the SLO
# verdict, and the replica lemma's prediction next to the measurement it
# came from (see docs/serving.md and docs/schemas.md)
_SERVING_REQUIRED = ("schema", "mode", "scheduler", "kv_cache", "latency_s",
                     "throughput", "slo", "replica_lemma")
_SERVING_SUBKEYS = {
    "scheduler": ("max_batch", "requests", "arrival"),
    "kv_cache": ("block_size", "n_blocks", "peak_blocks", "peak_occupancy",
                 "block_bytes"),
    "latency_s": ("p50", "p95", "p99", "mean", "max"),
    "throughput": ("tokens_per_s", "decode_token_steps",
                   "wasted_decode_steps", "engine_steps"),
    "slo": ("slo_s", "attained"),
    "replica_lemma": ("predicted", "measured"),
}
_SERVING_MODES = ("continuous", "static")


def _validate_serving(s: Any):
    """Schema check for the ``repro.api/serving/v1`` section."""
    _require(isinstance(s, dict),
             f"measured.serving must be a dict, got {type(s).__name__}")
    _require(s.get("schema") == SERVING_SCHEMA_ID,
             f"serving schema {s.get('schema')!r} != {SERVING_SCHEMA_ID!r}")
    for key in _SERVING_REQUIRED:
        _require(key in s, f"serving missing {key!r}")
    for sect, keys in _SERVING_SUBKEYS.items():
        _require(isinstance(s[sect], dict), f"serving.{sect} must be a dict, "
                 f"got {type(s[sect]).__name__}")
        for key in keys:
            _require(key in s[sect], f"serving.{sect} missing {key!r}")
    _require(s["mode"] in _SERVING_MODES,
             f"serving.mode {s['mode']!r} not in {_SERVING_MODES}")
    occ = s["kv_cache"]["peak_occupancy"]
    _require(isinstance(occ, (int, float)) and 0.0 <= occ <= 1.0,
             f"serving.kv_cache.peak_occupancy must be in [0, 1], got {occ!r}")
    lat = s["latency_s"]
    _require(float(lat["p50"]) <= float(lat["p99"]) + 1e-12,
             "serving.latency_s p50 exceeds p99")
    _require(float(lat["p99"]) <= float(lat["max"]) + 1e-12,
             "serving.latency_s p99 exceeds max")
    _require("replicas" in s["replica_lemma"]["predicted"],
             "serving.replica_lemma.predicted missing 'replicas'")


def _validate_tuning(t: Any):
    """Schema check for the ``repro.api/tuning/v1`` section."""
    _require(isinstance(t, dict),
             f"measured.tuning must be a dict, got {type(t).__name__}")
    _require(t.get("schema") == TUNING_SCHEMA_ID,
             f"tuning schema {t.get('schema')!r} != {TUNING_SCHEMA_ID!r}")
    for key in _TUNING_REQUIRED:
        _require(key in t, f"tuning missing {key!r}")
    for key in _TUNING_REQUIRED:
        _require(isinstance(t[key], dict), f"tuning.{key} must be a dict, "
                 f"got {type(t[key]).__name__}")
    _require("chosen" in t["minibatch"], "tuning.minibatch missing 'chosen'")
    for op, entry in t["kernels"].items():
        _require(isinstance(entry, dict) and "chosen" in entry,
                 f"tuning.kernels[{op!r}] missing 'chosen'")
    for key in ("measured_step_s", "est_step_time_calibrated_s",
                "est_step_time_uncalibrated_s"):
        _require(key in t["replan"], f"tuning.replan missing {key!r}")
    if "overlap" in t and isinstance(t["overlap"], dict) \
            and t["overlap"].get("measured"):
        ov = t["overlap"]
        _require("chosen_bucket_mb" in ov,
                 "measured tuning.overlap missing 'chosen_bucket_mb'")
        frac = ov.get("overlap_fraction")
        _require(isinstance(frac, (int, float)) and 0.0 <= frac <= 1.0,
                 f"tuning.overlap.overlap_fraction must be in [0, 1], "
                 f"got {frac!r}")
