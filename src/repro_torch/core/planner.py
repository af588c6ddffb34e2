"""End-to-end configurator — the paper's methodology automated (a copy of
``repro.core.planner``; it returns the JAX planner's plan for the same
inputs, float for float).

Given (arch config, input shape, mesh spec) it:
  1. builds the memory model (M_bound analogue, §3.1.3),
  2. runs a branch-and-bound search (``core.ilp.search_bnb``, the Eq.-6
     machinery generalized) over the unified candidate grid — pipeline
     stages × microbatch count (the X_mini knob) × attention impl
     {dense, chunked} × remat {save, recompute} — priced by the roofline
     under the HBM bound,
  3. estimates step time from a napkin roofline (compute/memory/collective,
     plus the 1F1B bubble and p2p terms when a pipeline cut is searched),
  4. applies Lemma 3.1 to report efficiency/speedup for the mesh size and
     Lemma 3.2 to pick the gradient-sync schedule,
  5. emits a Plan with every runtime knob the launcher needs.

The functions price the ``MeshSpec`` they are given: a TPU mesh as the JAX
package does, an H100 cluster (``MeshSpec.from_cluster(get_cluster(
"h100-8"))``) on the card's data-sheet constants.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import amdahl, memory_model as mm, ps
from repro_torch.core.hardware import ClusterSpec, MeshSpec, SINGLE_POD, Tier
from repro_torch.core.ilp import Dim, search_bnb
from repro_torch.core.pipeline import balanced_stage_cut, pipeline_bubble
from repro_torch.models import model as M


@dataclass
class Plan:
    arch: str
    shape: str
    mesh: Tuple[int, int]  # (dp, tp)
    fsdp: bool
    microbatch: int
    attn_impl: str
    remat: str
    seq_parallel: bool
    opt_kind: str
    sync_schedule: str
    est_step_time: float
    est_memory_gb: float
    fits: bool
    efficiency: float
    grad_bytes: float = 0.0  # S_p: fp32 grad payload per TP shard
    # serialized ClusterSpec (tiers with bandwidths) the plan was priced on;
    # replaces the old scalar `link_bw` field
    topology: Optional[Dict] = None
    bottleneck_tier: str = ""  # slowest spanning tier for the sync schedule
    # True when the mesh carried measured (autotune-calibrated) constants
    # instead of datasheet numbers (the JAX package's autotune Calibration)
    calibrated: bool = False
    # bucketed comm/compute overlap (distributed.overlap): whether the
    # plan was priced with sync hidden under the backward pass, the bucket
    # size target [MiB] (0 = the shared default), and — when a trainer or
    # test attached one — the serialized leaf-level BucketPlan dict
    sync_overlap: bool = False
    bucket_mb: float = 0.0
    bucket_plan: Optional[Dict] = None
    # pipeline parallelism (1F1B): stage count, microbatch count per step,
    # and the contiguous layer-cycle cut boundaries (len pipe + 1).  Legacy
    # plan dicts predate these fields and migrate to the defaults (no
    # pipelining) through from_dict's known-field filter.
    pipe: int = 1
    n_microbatch: int = 1
    stage_cut: Optional[List[int]] = None
    # bounded-staleness async PS (distributed.async_ps): max worker
    # params age in steps (0 = synchronous) and slowest-k gradient drops
    # per step.  Legacy plan dicts migrate to the synchronous defaults
    # through from_dict's known-field filter.
    staleness: int = 0
    backup_workers: int = 0
    notes: List[str] = field(default_factory=list)

    def run_config_kwargs(self) -> Dict:
        return dict(attn_impl=self.attn_impl, remat=self.remat,
                    microbatch=self.microbatch)

    def to_job_kwargs(self) -> Dict:
        """Every runtime knob a Session/launcher adopts from this plan:
        the RunConfig knobs plus optimizer kind, the sync schedule, the
        overlap knobs, and the pipeline shape."""
        return dict(self.run_config_kwargs(), opt_kind=self.opt_kind,
                    sync=self.sync_schedule, sync_overlap=self.sync_overlap,
                    bucket_mb=self.bucket_mb, pipe=self.pipe,
                    n_microbatch=self.n_microbatch, staleness=self.staleness,
                    backup_workers=self.backup_workers)

    # -- topology view -----------------------------------------------------
    @property
    def cluster(self) -> Optional[ClusterSpec]:
        return ClusterSpec.from_dict(self.topology) if self.topology else None

    @property
    def link_bw(self) -> float:
        """Bandwidth of the topology's narrowest spanning tier — what the
        flat (topology-blind) schedules are priced at.  Kept as a property
        for consumers of the pre-topology scalar field."""
        c = self.cluster
        return c.min_bw if c is not None else 0.0

    def dp_tiers(self) -> Tuple[Tier, ...]:
        """The data axis's per-tier fan-out (TP packed innermost)."""
        c = self.cluster
        dp = self.mesh[0]
        if c is None:
            return (Tier("flat", dp, 1.0),)
        try:
            return c.dp_view(dp, self.mesh[1])
        except ValueError:  # mesh geometry disagrees with the topology
            return (Tier(c.bottleneck_tier, dp, c.min_bw),)

    # -- round-trip serialization (benchmark artifacts carry the plan) -----
    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict) -> "Plan":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["mesh"] = tuple(kw["mesh"])
        kw["notes"] = list(kw.get("notes", []))
        # pre-topology plans carried a scalar link_bw: rebuild the
        # equivalent flat single-tier cluster so pricing still works
        if not kw.get("topology") and d.get("link_bw"):
            dp, tp = kw["mesh"]
            kw["topology"] = ClusterSpec.flat(
                dp * tp, float(d["link_bw"])).to_dict()
        return cls(**kw)

    @classmethod
    def from_json(cls, s: str) -> "Plan":
        return cls.from_dict(json.loads(s))

    def resolve_sync(self, *, link_bw: Optional[float] = None):
        """Resolve ``sync_schedule`` to a runnable strategy
        (:class:`repro_torch.distributed.collectives.SyncStrategy`) instead of a
        string. For the parameter-server schedule the shard count comes from
        Lemma 3.2 (``ps.n_parameter_servers``) sized for this plan's mesh,
        payload, and estimated step time; for ``hier_all_reduce`` the tier
        fan-out comes from the plan's topology."""
        from repro_torch.distributed.collectives import get_strategy

        if self.sync_schedule in ("-", ""):
            raise ValueError(f"plan for {self.arch}/{self.shape} has no "
                             "gradient sync (decode plan?)")
        if self.sync_schedule == "hier_all_reduce":
            sizes = tuple(t.size for t in self.dp_tiers())
            return get_strategy("hier_all_reduce", tiers=sizes)
        n_servers = None
        if self.sync_schedule == "parameter_server" and self.grad_bytes:
            dp = self.mesh[0]
            bw = link_bw or self.link_bw
            if bw <= 0:
                raise ValueError("resolve_sync: no link bandwidth on this "
                                 "Plan; pass link_bw=")
            t_c = self.est_step_time if math.isfinite(self.est_step_time) else 1.0
            n_servers = ps.n_parameter_servers(self.grad_bytes, dp, bw, t_c)
        return get_strategy(self.sync_schedule, n_servers=n_servers)


# ---------------------------------------------------------------------------
# Napkin step-time model
# ---------------------------------------------------------------------------


def train_flops_per_step(cfg: ModelConfig, shape: ShapeConfig, remat: str) -> float:
    """6*N_active*D (+ remat recompute ~2*N*D) + attention quadratic part."""
    tokens = shape.global_batch * shape.seq_len
    n_act = mm.n_active_params(cfg)
    mult = 8.0 if remat == "block" else 6.0
    base = mult * n_act * tokens
    # causal attention: 2 * 0.5 * S^2 * width, fwd+bwd(2x) [+remat fwd]
    attn = 0.0
    cycles = M.main_cycles(cfg)
    for s in cfg.pattern:
        if s.mixer == "mamba":
            attn += cycles * tokens * cfg.ssm_state * cfg.d_inner * 2 * 3
            continue
        win = cfg.sliding_window if s.mixer == "swa" else cfg.attn_window_override
        s_eff = min(shape.seq_len, win) if win else shape.seq_len
        width = cfg.num_heads * cfg.head_dim if not cfg.is_mla else (
            cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                             + cfg.v_head_dim))
        fwd = 2 * 0.5 * s_eff * tokens * width * 2  # qk + pv
        attn += cycles * fwd * (4.0 if remat == "block" else 3.0) / 2
    return base + attn


def _dp_tiers(mesh: MeshSpec) -> Tuple[Tier, ...]:
    """Data-axis tier view of the mesh's cluster, with a flat fallback when
    the logical dp x tp geometry does not factor along the topology."""
    c = mesh.cluster
    try:
        return c.dp_view(mesh.dp, mesh.tp)
    except ValueError:
        return (Tier(c.bottleneck_tier, mesh.dp, c.min_bw),)


def r_o_from_terms(terms: Dict[str, float]) -> float:
    """Lemma 3.1's overhead ratio R_O from the roofline terms — the one
    place the accounting lives (plan_train and Session._predicted both
    call it): only the *effective* (post-overlap) collective share counts
    as overhead on top of compute."""
    return (max(terms["collective_effective"] + terms["memory"]
                - terms["compute"], 0.0)
            / max(terms["compute"], 1e-9))


def grad_sync_time(s_p: float, dp_tiers: Tuple[Tier, ...]) -> Tuple[float, str]:
    """Cheapest gradient-sync comm time for a payload of ``s_p`` bytes per
    worker over the tiered data axis, and the winning schedule — one call
    into :func:`ps.grad_sync_plan` so the step-time model and the plan's
    stored ``sync_schedule`` share one selection rule.  (With nonzero
    per-tier latency the winner can still depend on the payload size; the
    plan's stored schedule — selected on the sync payload — is the
    authoritative one.)"""
    if not any(t.size > 1 for t in dp_tiers):
        return 0.0, "none"
    plan = ps.grad_sync_plan(s_p, dp_tiers, t_c=1.0)
    return plan.comm_time, plan.schedule


def estimate_step_time(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                       remat: str, microbatch: int, *,
                       sync_overlap: bool = False, bucket_mb: float = 0.0,
                       overlap_efficiency: float = 1.0,
                       pipe: int = 1,
                       n_microbatch: int = 0,
                       staleness: int = 0,
                       backup_workers: int = 0,
                       mean_delay: float = 0.0) -> Dict[str, float]:
    """Napkin roofline terms [s].  With ``sync_overlap`` the gradient-sync
    collective is priced through the bucketed-overlap model
    (:func:`repro_torch.core.ps.overlap_exposed_comm`): only the comm that sticks
    out past the backward pass counts against the step.  ``collective``
    always reports the serial sum; ``collective_effective`` is what the
    ``total`` uses and degrades to ``collective`` exactly when
    ``sync_overlap`` is off (or the payload yields a single bucket).
    ``overlap_efficiency`` derates the hideable window to a *measured*
    overlap fraction (autotune calibration).

    With ``pipe > 1`` the mesh's data axis is split ``pipe x (dp/pipe)``:
    compute stretches by the 1F1B fill/drain factor ``(m+p-1)/m``
    (``pipeline_bubble``), each stage holds and syncs ``1/pipe`` of the
    params, per-stage param re-reads scale with the microbatch count, and
    a ``collective_p2p`` term prices the boundary activation transfers on
    the innermost tier.

    ``staleness``/``backup_workers`` price the bounded-staleness async-PS
    relaxation (``repro_torch.core.ps.async_step_time``'s terms threaded into
    the roofline): the grad-sync pull amortizes over ``s + 1`` steps
    (traffic factor ``(1 + 1/(s+1))/2``), a ``straggler_wait`` term is
    added (order statistics at ``mean_delay``), and the ``total`` divides
    by :func:`ps.staleness_efficiency` so stale progress pays its
    statistical price.  The synchronous defaults leave every term exactly
    as before."""
    pipe = max(int(pipe), 1)
    m = max(int(n_microbatch) or pipe, pipe)
    dp_data = max(mesh.dp // pipe, 1)
    flops = train_flops_per_step(cfg, shape, remat) / mesh.chips
    t_compute = flops / mesh.chip.peak_flops
    bubble = pipeline_bubble(pipe, m)
    if pipe > 1:
        t_compute *= (m + pipe - 1) / m  # == 1 / (1 - bubble)
    # memory term: params read per microbatch pass + activations traffic
    n = mm.n_params(cfg)
    if pipe > 1:
        # each stage re-reads its 1/pipe param slice once per microbatch
        param_traffic = 2 * n / pipe / mesh.tp * 3 * m
    else:
        n_micro = max(shape.global_batch // mesh.dp, 1) // max(microbatch, 1)
        param_traffic = 2 * n / mesh.tp * 3 * max(n_micro, 1)
    act_traffic = 12 * shape.global_batch * shape.seq_len * cfg.d_model * 2 / mesh.chips
    t_mem = (param_traffic + act_traffic) / mesh.chip.hbm_bw
    # collectives, priced per topology tier: the fp32 grad sync rides the
    # data axis (flat ring at the bottleneck bw, or the hierarchical
    # schedule when the tree is cheaper); TP activation collectives stay on
    # the innermost (fastest) tier, where TP ranks are packed
    cluster = mesh.cluster
    tiers = _dp_tiers(mesh)
    grad_bytes = 4 * n / mesh.tp / pipe
    t_grad, _ = grad_sync_time(grad_bytes, tiers)
    # bounded-staleness relaxation: push every step, pull every s+1 steps
    t_wait = 0.0
    if staleness > 0 or backup_workers > 0:
        t_grad *= (1.0 + 1.0 / (staleness + 1)) / 2.0
        t_wait = ps.straggler_wait(dp_data, backup_workers, mean_delay)
    stat_eff = ps.staleness_efficiency(staleness)
    tp_wire = (4 * cfg.num_layers * shape.global_batch * shape.seq_len
               * cfg.d_model * 2 / mesh.chips)
    t_tp = tp_wire / cluster.tiers[0].bw
    # stage-boundary activation p2p: every microbatch ships its (rows x S
    # x D) bf16 slab forward and its cotangent back across each boundary
    t_p2p = 0.0
    if pipe > 1:
        rows = max(shape.global_batch // dp_data // m, 1)
        t_p2p = (2 * (pipe - 1) / pipe * m * rows * shape.seq_len
                 * cfg.d_model * 2 / cluster.tiers[0].bw)
    t_coll = t_grad + t_tp + t_p2p
    # overlap: the exposed share of the grad sync under the bucketed model
    t_grad_exposed, overlap_frac, n_buckets = t_grad, 0.0, 1
    if sync_overlap and t_grad > 0:
        n_buckets = ps.bucket_count(grad_bytes, bucket_mb)
        t_bwd = (1.0 - ps.FWD_FRACTION) * t_compute
        t_grad_exposed = ps.overlap_exposed_comm(
            t_grad, t_bwd, n_buckets, overlap_efficiency=overlap_efficiency)
        overlap_frac = (t_grad - t_grad_exposed) / t_grad
    t_coll_eff = t_grad_exposed + t_tp + t_p2p
    return {"compute": t_compute, "memory": t_mem, "collective": t_coll,
            "collective_grad": t_grad, "collective_tp": t_tp,
            "collective_p2p": t_p2p,
            "collective_grad_exposed": t_grad_exposed,
            "collective_effective": t_coll_eff,
            "overlap_fraction": overlap_frac,
            "overlap_n_buckets": float(n_buckets),
            "pipeline_bubble": bubble,
            "straggler_wait": t_wait,
            "staleness_efficiency": stat_eff,
            "total": (max(t_compute, t_mem, t_coll_eff) + t_wait) / stat_eff}


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


def train_search_space(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, *,
                       fsdp: bool, opt_kind: str,
                       sync_overlap: bool = False, bucket_mb: float = 0.0,
                       overlap_efficiency: float = 1.0,
                       pipe: Optional[int] = None, n_microbatch: int = 0,
                       staleness: Union[int, Tuple[int, ...], None] = None,
                       backup_workers: int = 0, mean_delay: float = 0.0
                       ) -> Tuple[List[Dim],
                                  Callable[[Dict], Tuple[float, float, bool]],
                                  Callable[[Dict], float]]:
    """The unified auto-parallel grid for one (arch, shape, mesh):
    ``(dims, evaluate, lower_bound)`` ready for
    :func:`repro_torch.core.ilp.search_bnb` — and for
    :func:`repro_torch.core.ilp.search_exhaustive`, the oracle the optimality
    tests compare against.

    Dimensions, in tie-break order: the joint ``pipe_m = (pipe,
    n_microbatch)`` candidates with the no-pipeline cell ``(1, 1)`` first,
    then the per-device microbatch rows, attention impl, and remat — the
    historical enumeration order, so strict-< keeps legacy picks stable.
    ``evaluate`` prices a cell with :func:`estimate_step_time` under the
    Eq.-5 memory bound (0.9 x HBM, via ``mm.train_memory``); non-canonical
    cells (microbatch not dividing the replica batch; an explicit row count
    alongside a pipeline cut, where ``m`` already fixes the rows) price as
    infeasible with infinite memory so they can never win the frugal pick.
    ``lower_bound`` is admissible: 0.98 x the compute-only roofline under
    the best unassigned remat, times the 1F1B stretch once a cut is fixed.

    Pass ``pipe``/``n_microbatch`` to clamp the grid to a user-forced
    pipeline shape (``launch/train.py --pipe/--microbatch``).

    ``staleness`` adds the bounded-staleness async-PS dimension: ``None``
    keeps the synchronous single candidate ``(0,)`` (legacy plans and
    goldens are byte-stable), an int clamps it, and a tuple lets the B&B
    trade pull amortization + straggler savings against the
    :func:`ps.staleness_efficiency` discount.  ``backup_workers`` /
    ``mean_delay`` price the slowest-k drop at every staleness
    candidate."""
    overlap_kw = dict(sync_overlap=sync_overlap, bucket_mb=bucket_mb,
                      overlap_efficiency=overlap_efficiency)
    hbm = mesh.chip.hbm_bytes
    b_rep = max(shape.global_batch // mesh.dp, 1)
    cycles = M.main_cycles(cfg)

    pipe_m: List[Tuple[int, int]] = []
    for p in ((1, 2, 4, 8) if pipe is None else (int(pipe),)):
        if p < 1 or mesh.dp % p or p > cycles:
            continue
        if p == 1:
            pipe_m.append((1, 1))
            continue
        b_data = max(shape.global_batch // (mesh.dp // p), 1)
        for m in ((n_microbatch,) if n_microbatch else (p, 2 * p, 4 * p)):
            if p <= m <= b_data and b_data % m == 0:
                pipe_m.append((p, m))
    if not pipe_m:
        raise ValueError(
            f"no valid (pipe, n_microbatch) candidates for pipe={pipe}, "
            f"n_microbatch={n_microbatch} on dp={mesh.dp} "
            f"({cycles} layer cycles)")

    if staleness is None:
        stale_cands: Tuple[int, ...] = (0,)
    elif isinstance(staleness, int):
        stale_cands = (int(staleness),)
    else:
        stale_cands = tuple(sorted(set(int(s) for s in staleness)))
    if any(s < 0 for s in stale_cands):
        raise ValueError(f"staleness candidates must be >= 0: {stale_cands}")

    dims = [Dim("pipe_m", tuple(pipe_m)),
            Dim("microbatch", (1, 2, 4, 8, 16, 32)),
            Dim("attn_impl", ("dense", "chunked")),
            Dim("remat", ("block", "none")),
            Dim("staleness", stale_cands)]

    def stage_rows(p: int, m: int) -> int:
        return max(shape.global_batch // (mesh.dp // p) // m, 1)

    def evaluate(config: Dict) -> Tuple[float, float, bool]:
        p, m = config["pipe_m"]
        mb, attn_impl, remat = (config["microbatch"], config["attn_impl"],
                                config["remat"])
        s = config["staleness"]
        if s and p > 1:  # async PS assumes one flat data axis (no pipe)
            return float("inf"), float("inf"), False
        if p == 1:
            if mb > b_rep or b_rep % mb:
                return float("inf"), float("inf"), False
            rows = mb
            mem = mm.train_memory(
                cfg, shape, dp=mesh.dp, tp=mesh.tp, fsdp=fsdp,
                microbatch=mb, attn_impl=attn_impl, remat=remat,
                seq_parallel=True, opt_kind=opt_kind)
        else:
            if mb != 1:  # m already fixes the per-pass rows
                return float("inf"), float("inf"), False
            rows = stage_rows(p, m)
            mem = mm.train_memory(
                cfg, shape, dp=mesh.dp // p, tp=mesh.tp, fsdp=fsdp,
                microbatch=rows, attn_impl=attn_impl, remat=remat,
                seq_parallel=True, opt_kind=opt_kind,
                pipe=p, n_microbatch=m)
        t = estimate_step_time(cfg, shape, mesh, remat, rows,
                               pipe=p, n_microbatch=m, staleness=s,
                               backup_workers=backup_workers,
                               mean_delay=mean_delay, **overlap_kw)["total"]
        # dense attention has no flash overhead; tiny bonus at short S
        if attn_impl == "dense" and shape.seq_len <= 4096:
            t *= 0.98
        return t, mem.total, mem.total <= 0.9 * hbm

    t_comp = {r: train_flops_per_step(cfg, shape, r)
              / mesh.chips / mesh.chip.peak_flops for r in ("block", "none")}

    def lower_bound(partial: Dict) -> float:
        factor = 1.0
        if "pipe_m" in partial:
            p, m = partial["pipe_m"]
            if p > 1:
                factor = (m + p - 1) / m
        return 0.98 * factor * t_comp.get(partial.get("remat"),
                                          min(t_comp.values()))

    return dims, evaluate, lower_bound


def plan_train(cfg: ModelConfig, shape: ShapeConfig,
               mesh: MeshSpec = SINGLE_POD, *,
               sync_overlap: bool = False, bucket_mb: float = 0.0,
               overlap_efficiency: float = 1.0,
               pipe: Optional[int] = None, n_microbatch: int = 0,
               staleness: Union[int, Tuple[int, ...], None] = None,
               backup_workers: int = 0, mean_delay: float = 0.0) -> Plan:
    overlap_kw = dict(sync_overlap=sync_overlap, bucket_mb=bucket_mb,
                      overlap_efficiency=overlap_efficiency)
    async_kw = dict(staleness=staleness, backup_workers=backup_workers,
                    mean_delay=mean_delay)
    notes: List[str] = []
    if mesh.chip.calibrated:
        notes.append(f"priced on measured constants ({mesh.chip.name}: "
                     f"{mesh.chip.peak_flops:.3g} FLOP/s achieved)")
    hbm = mesh.chip.hbm_bytes

    n_bytes_bf16 = 2 * mm.n_params(cfg)
    fsdp = n_bytes_bf16 / mesh.tp > 0.25 * hbm
    if fsdp:
        notes.append(f"FSDP on: bf16 params/TP = "
                     f"{n_bytes_bf16 / mesh.tp / 2**30:.1f} GiB > 25% HBM")

    # optimizer: AdamW unless its state cannot fit even fully sharded
    opt_kind = "adamw"
    if 12 * mm.n_params(cfg) / mesh.chips > 0.55 * hbm:
        opt_kind = "momentum"
        notes.append("AdamW state exceeds 55% HBM fully sharded -> "
                     "paper-era momentum SGD (4 B/param)")

    # Eq.-6 unified: branch-and-bound over pipeline cut x microbatch x
    # attention x remat, priced by the roofline under the HBM bound
    dims, evaluate, lb = train_search_space(
        cfg, shape, mesh, fsdp=fsdp, opt_kind=opt_kind,
        pipe=pipe, n_microbatch=n_microbatch, **overlap_kw, **async_kw)
    found = search_bnb(dims, evaluate, lower_bound=lb)
    p, n_micro = found.config["pipe_m"]
    stale = int(found.config["staleness"])
    attn_impl, remat = found.config["attn_impl"], found.config["remat"]
    dp_data = mesh.dp // p
    mb = (found.config["microbatch"] if p == 1
          else max(shape.global_batch // dp_data // n_micro, 1))
    t_best = found.time if found.feasible else float("inf")
    if not found.feasible:
        notes.append("NO feasible microbatch found — does not fit this mesh")
    if p > 1:
        cut = balanced_stage_cut(M.main_cycles(cfg), p)
        notes.append(
            f"1F1B pipeline: {p} stages x {n_micro} microbatches, model "
            f"bubble {pipeline_bubble(p, n_micro):.1%}, stage cut {list(cut)}")
    else:
        cut = None

    mem = mm.train_memory(cfg, shape, dp=dp_data, tp=mesh.tp, fsdp=fsdp,
                          microbatch=mb, attn_impl=attn_impl, remat=remat,
                          seq_parallel=True, opt_kind=opt_kind,
                          pipe=p, n_microbatch=n_micro if p > 1 else 0)
    fits = mem.total <= hbm

    # Lemma 3.2 (tier-aware): can grad sync hide behind compute, and does
    # the topology make the hierarchical schedule the better vehicle?
    sync = ps.grad_sync_plan(
        2 * mm.n_params(cfg) / mesh.tp / p, _dp_tiers(mesh),
        t_c=t_best if math.isfinite(t_best) else 1.0)
    notes.append(f"Lemma3.2: {sync.note}")
    if sync.bottleneck_tier:
        notes.append(f"bottleneck tier: {sync.bottleneck_tier}")

    # Lemma 3.1: overhead ratio from the non-compute roofline terms — with
    # overlap on, only the *exposed* collective share counts as overhead
    terms = estimate_step_time(cfg, shape, mesh, remat, mb,
                               pipe=p, n_microbatch=n_micro, staleness=stale,
                               backup_workers=backup_workers,
                               mean_delay=mean_delay, **overlap_kw)
    r_o = r_o_from_terms(terms)
    if stale > 0 or backup_workers > 0:
        notes.append(
            f"async PS: staleness={stale} (pull amortized "
            f"1/{stale + 1}), backup_workers={backup_workers}, straggler "
            f"wait {terms['straggler_wait']:.3g}s, statistical efficiency "
            f"{terms['staleness_efficiency']:.2f}")
    eff = amdahl.efficiency(mesh.chips, r_o / mesh.chips)  # R_O already aggregate
    if sync_overlap:
        exposed = terms["collective_grad_exposed"]
        serial = terms["collective_grad"]
        bound = ("comm-bound" if exposed + terms["collective_tp"]
                 > max(terms["compute"], terms["memory"]) else "compute-bound")
        notes.append(
            f"overlap: {int(terms['overlap_n_buckets'])} buckets hide "
            f"{terms['overlap_fraction']:.0%} of grad sync "
            f"({serial:.3g}s -> {exposed:.3g}s exposed); {bound} after "
            "overlap")
    return Plan(
        arch=cfg.name, shape=shape.name, mesh=(dp_data, mesh.tp), fsdp=fsdp,
        microbatch=mb, attn_impl=attn_impl, remat=remat, seq_parallel=True,
        opt_kind=opt_kind, sync_schedule=sync.schedule,
        est_step_time=t_best, est_memory_gb=mem.total / 2**30, fits=fits,
        efficiency=eff, grad_bytes=4.0 * mm.n_params(cfg) / mesh.tp / p,
        topology=mesh.cluster.to_dict(),
        bottleneck_tier=sync.bottleneck_tier,
        calibrated=mesh.chip.calibrated,
        sync_overlap=sync_overlap, bucket_mb=bucket_mb,
        pipe=p, n_microbatch=n_micro,
        stage_cut=list(cut) if cut else None,
        staleness=stale, backup_workers=backup_workers, notes=notes,
    )


def plan_decode(cfg: ModelConfig, shape: ShapeConfig,
                mesh: MeshSpec = SINGLE_POD) -> Plan:
    notes: List[str] = []
    hbm = mesh.chip.hbm_bytes
    window = 0
    if shape.seq_len > 100_000 and not cfg.subquadratic:
        window = 8192
        notes.append("long-context SWA-8192 variant (DESIGN.md policy)")
    fsdp = 2 * mm.n_params(cfg) / mesh.tp > 0.5 * hbm
    mem = mm.decode_memory(cfg, shape, dp=mesh.dp, tp=mesh.tp, fsdp=fsdp,
                           window_override=window)
    fits = mem.total <= hbm
    if not fits:
        notes.append(f"decode memory {mem.total/2**30:.1f} GiB > HBM")
    # decode is memory-bound: step time ~ (params + cache) / HBM bw
    t = (mem.params + mem.kv_cache) / mesh.chip.hbm_bw
    return Plan(
        arch=cfg.name, shape=shape.name, mesh=(mesh.dp, mesh.tp), fsdp=fsdp,
        microbatch=0, attn_impl="dense", remat="none", seq_parallel=False,
        opt_kind="-", sync_schedule="-", est_step_time=t,
        est_memory_gb=mem.total / 2**30, fits=fits,
        efficiency=1.0, topology=mesh.cluster.to_dict(),
        calibrated=mesh.chip.calibrated, notes=notes,
    )


def plan(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec = SINGLE_POD, *,
         sync_overlap: bool = False, bucket_mb: float = 0.0,
         overlap_efficiency: float = 1.0,
         pipe: Optional[int] = None, n_microbatch: int = 0,
         staleness: Union[int, Tuple[int, ...], None] = None,
         backup_workers: int = 0, mean_delay: float = 0.0) -> Plan:
    if shape.kind == "train" or shape.kind == "prefill":
        return plan_train(cfg, shape, mesh, sync_overlap=sync_overlap,
                          bucket_mb=bucket_mb,
                          overlap_efficiency=overlap_efficiency,
                          pipe=pipe, n_microbatch=n_microbatch,
                          staleness=staleness,
                          backup_workers=backup_workers,
                          mean_delay=mean_delay)
    return plan_decode(cfg, shape, mesh)  # decode has no gradient sync
