"""JobSpec — the one declarative object that names a job end to end
(a copy of ``repro.api.spec``, with the same fields and validation).

The paper's procedure is: pick the minibatch size and per-layer algorithms,
size the mesh and the parameter servers, then run.  A :class:`JobSpec` is
that procedure written down once: architecture + input shape + mesh, the
data-parallel degree and gradient-sync/compression choice, and the run
extent (steps/batch/seq/seed).  ``Session`` resolves it through the planner
and executes it; every entry point (launchers, benchmarks, examples) builds
one of these instead of hand-plumbing ``get_config -> plan -> RunConfig``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict

from repro_torch.configs.base import ARCH_IDS, SHAPES
from repro_torch.core import ps as ps_lib
from repro_torch.core.hardware import CLUSTERS

MESHES = ("single", "multi")
SYNCS = ("auto",) + ps_lib.SCHEDULES
# "" = the mesh's flat equivalent
TOPOLOGIES = ("",) + tuple(sorted(CLUSTERS))
# names mirror repro_torch.distributed.compression.COMPRESSORS (kept
# import-light: the spec does not pull in torch.distributed)
COMPRESSIONS = ("none", "bf16", "int8", "topk")


@dataclass(frozen=True)
class JobSpec:
    """Declarative description of one job (train / serve / bench / dryrun)."""

    arch: str
    reduced: bool = True          # reduced family member vs FULL config
    shape: str = "train_4k"       # planner ShapeConfig name
    mesh: str = "single"          # planner mesh: single | multi pod
    topology: str = ""            # named ClusterSpec (hardware.CLUSTERS);
                                  # "" = flat cluster equivalent to `mesh`
    steps: int = 100
    batch: int = 8
    seq: int = 128
    lr: float = 1e-3
    seed: int = 0
    use_planner: bool = False     # adopt planner knobs (microbatch/attn/remat/opt)
    dp: int = 0                   # >0: explicit data-parallel trainer on dp devices
    pipe: int = 0                 # >0: 1F1B pipeline trainer with this many
                                  # stages (devices split pipe x data);
                                  # 0 = planner-resolved / no pipelining
    n_microbatch: int = 0         # 1F1B microbatches per step; 0 = pipe
    sync: str = "auto"            # gradient-sync schedule, or planner-resolved
    compress: str = "none"        # gradient compression
    sync_overlap: bool = False    # bucketed comm/compute overlap (trainer +
                                  # overlap-aware cost model)
    bucket_mb: float = 0.0        # sync-bucket size target [MiB]; 0 = the
                                  # shared default (core.ps.DEFAULT_BUCKET_MB)
    staleness: int = 0            # bounded-staleness async PS: max worker
                                  # params age in steps (0 = synchronous)
    backup_workers: int = 0       # drop the slowest k of dp gradients per
                                  # step (0 = wait for every worker)
    ckpt_dir: str = ""
    ckpt_every: int = 0
    log_every: int = 10
    trace_dir: str = ""           # write a Chrome-trace JSON per run here
                                  # ("" = tracing stays in-memory only)
    # autotuning (the JAX package's Session.tune):
    tune: bool = False            # run the autotuner; train/bench adopt its
                                  # measured kernel + microbatch choices
    tune_steps: int = 3           # measured trainer steps per calibration
    tune_cache: str = ""          # JSON calibration-cache path ("" = no
                                  # persistence across sessions)
    # serving knobs
    s_max: int = 256              # decode cache length
    max_batch: int = 4            # scheduler batch size
    n_new: int = 16               # tokens generated per request
    requests: int = 6             # synthetic request count
    serve_mode: str = "continuous"  # continuous (in-flight batching, paged
                                  # KV) | static (FIFO BatchScheduler)
    kv_block: int = 16            # paged-KV block size [tokens]
    max_kv_blocks: int = 0        # KV pool cap; 0 = derive from the Eq. 5
                                  # analogue (memory_model.max_kv_blocks)
    prefill_chunk: int = 0        # chunked prefill size; 0 = whole-prompt
    arrival: str = ""             # arrival trace spec ("" | poisson:RATE |
                                  # burst:NxGAP), see serve.arrivals
    slo_ms: float = 0.0           # per-request latency SLO for the replica
                                  # lemma; 0 = 2x the measured mean latency
    arrival_rate: float = 0.0     # offered load [req/s] for the lemma;
                                  # 0 = 2x one replica's capacity

    def __post_init__(self):
        if self.arch not in ARCH_IDS:
            raise ValueError(f"unknown arch {self.arch!r}; known: {ARCH_IDS}")
        if self.shape not in SHAPES:
            raise ValueError(f"unknown shape {self.shape!r}; "
                             f"known: {sorted(SHAPES)}")
        if self.mesh not in MESHES:
            raise ValueError(f"mesh must be one of {MESHES}, got {self.mesh!r}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"known: {TOPOLOGIES}")
        if self.sync not in SYNCS:
            raise ValueError(f"sync must be one of {SYNCS}, got {self.sync!r}")
        if self.compress not in COMPRESSIONS:
            raise ValueError(f"compress must be one of {COMPRESSIONS}, "
                             f"got {self.compress!r}")
        for name in ("steps", "batch", "seq", "s_max", "max_batch", "n_new",
                     "requests", "tune_steps", "kv_block"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        if self.serve_mode not in ("continuous", "static"):
            raise ValueError(f"serve_mode must be 'continuous' or 'static', "
                             f"got {self.serve_mode!r}")
        for name in ("max_kv_blocks", "prefill_chunk"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.slo_ms < 0 or self.arrival_rate < 0:
            raise ValueError("slo_ms and arrival_rate must be >= 0")
        if self.arrival:
            # numpy-only module: safe to import from a backend-free spec
            from repro_torch.serve.arrivals import parse_trace
            parse_trace(self.arrival)  # raises ValueError on a bad spec
        if self.dp < 0:
            raise ValueError("dp must be >= 0 (0 = single-process loop)")
        if self.pipe < 0 or self.n_microbatch < 0:
            raise ValueError("pipe and n_microbatch must be >= 0")
        if self.pipe > 1 and self.n_microbatch and self.n_microbatch < self.pipe:
            raise ValueError(f"n_microbatch {self.n_microbatch} must be >= "
                             f"pipe {self.pipe} (1F1B needs a full warmup)")
        if self.bucket_mb < 0:
            raise ValueError("bucket_mb must be >= 0 (0 = default bucket size)")
        if self.dp and self.batch % self.dp:
            raise ValueError(f"batch {self.batch} not divisible by dp={self.dp}")
        if self.staleness < 0 or self.backup_workers < 0:
            raise ValueError("staleness and backup_workers must be >= 0")
        if self.staleness or self.backup_workers:
            if not self.dp:
                raise ValueError("staleness/backup_workers need an explicit "
                                 "data-parallel trainer: set dp > 0")
            if self.pipe > 1:
                raise ValueError("async PS assumes one flat data axis; "
                                 "incompatible with pipe > 1")
            if self.sync_overlap:
                raise ValueError("staleness already amortizes the pull "
                                 "traffic; incompatible with sync_overlap")
            if self.backup_workers >= self.dp:
                raise ValueError(f"backup_workers {self.backup_workers} must "
                                 f"be < dp {self.dp}")

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "JobSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, s: str) -> "JobSpec":
        return cls.from_dict(json.loads(s))
