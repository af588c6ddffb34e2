"""DataParallelTrainer (the port of ``repro.distributed.trainer``): the
training loop under an explicit gradient-sync strategy.

Each rank has its own device (``cuda:r``, or the CPU when asked) and its
own replica of the parameters and optimizer state.  The trainer runs in
one of two modes, over one per-rank code path:

- **all ranks** (``rank=None``, the default): one process owns every
  rank, one thread each, all in one process group built on an in-process
  ``HashStore``.  JAX runs its dp devices in one process the same way; the
  CPU tests use this mode.
- **one rank** (``rank=r, world=N, store=store``): the trainer owns rank r
  alone, on its one device, and its groups come from the store passed in
  (a ``TCPStore`` when ``torchrun`` starts one process per card, see
  :func:`torchrun_store`).  On cards this is the mode that scales: the
  rank threads of the first mode share one interpreter lock for their
  eager dispatch.

Groups are gloo on the CPU and NCCL on cards; the hierarchical strategy's
node sub-groups live under ``PrefixStore``s.  The strategies see only a
:class:`Group` and a rank.

The serial step is three phases, each a tracer span whose wall clock is
the measurement that lands in ``StepTimes`` and :class:`SyncReport`:

  1. **compute**      — each rank's gradients on its batch shard; it ends
     when every rank has finished (all-ranks mode: every thread joined and
     its card synchronized; one-rank mode: a device synchronize and a
     barrier on the rank's groups),
  2. **dist_update**  — compress + sync collectives (the Lemma 3.2 payload),
  3. **param_update** — each rank's optimizer update on the synced mean.

With ``sync_overlap=True`` the strict 3-phase step gives way to the
bucketed overlap schedule (``repro_torch.distributed.overlap``): the first
:data:`~DataParallelTrainer.N_CALIB_STEPS` steps run serial-bucketed (one
blocking compress + sync per bucket, each a ``bucket_sync`` span), and
every later step is one ``fused_step`` span in which autograd hooks hand
each bucket to the rank's communication thread (and, on a card, its own
stream) as soon as the backward pass has finished the bucket's gradients;
every bucket is waited on before the optimizer update.  Both paths run the
same per-leaf collectives over the same payloads as the serial step, so
the parameters are the same.

Each rank computes the mean loss over its shard and the strategy returns
the mean over ranks, so with equal shards the synced gradient is the
full-batch gradient up to reduction order.

Checkpointing is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import H100_NODE, ClusterSpec
from repro_torch.core.pipeline import StepTimes
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.distributed.collectives import (Group, SyncStrategy,
                                                 get_strategy)
from repro_torch.distributed.compression import Compressor, get_compressor
from repro_torch.distributed.overlap import (DEFAULT_BUCKET_MB, BucketPlan,
                                             bucket_span_args,
                                             build_bucket_plan, mb_to_bytes)
from repro_torch.launch.steps import build_grad_fn
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import (materialize, param_count,
                                       resolve_device, tree_items, tree_map,
                                       tree_unflatten)
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.optim import adamw as opt_lib
from repro_torch.train import loop as loop_lib

# "link" bandwidth for the Lemma 3.2 prediction when the caller gives none
# and the ranks run on the CPU (bytes/s; the JAX package's CPU-emulation
# default)
DEFAULT_LINK_BW = 4e9
# how long a collective may wait for its peers before the group fails
GROUP_TIMEOUT = timedelta(seconds=300)


def default_link_bw(devices, topology: Optional[ClusterSpec]) -> float:
    """Lemma 3.2's link bandwidth when the caller names none: on cards with
    no topology, the in-node (NVLink) tier of one H100 node; otherwise the
    JAX package's CPU-emulation default."""
    if topology is None and any(torch.device(d).type == "cuda"
                                for d in devices):
        return H100_NODE.tiers[0].bw
    return DEFAULT_LINK_BW


@dataclass
class SyncReport:
    """Measured-vs-predicted Lemma 3.1/3.2 numbers for one training run
    (the JAX package's fields).  For a serial run the sync is fully
    exposed: ``exposed_comm_time == measured_comm_s`` and
    ``overlap_fraction == 0``.  For an overlapped run ``measured_comm_s``
    is the serial comm measured on the bucketed calibration steps,
    ``exposed_comm_time`` what the fused steps still pay on the wall clock,
    and ``overlap_fraction`` the hidden share."""

    strategy: str
    compression: str
    dp: int
    n_servers: Optional[int]
    grad_bytes: float           # S_p: fp32 gradient payload
    wire_bytes: float           # after compression, per Lemma's worker view
    link_bw: float
    measured_comm_s: float      # mean dist_update over steady-state steps
    predicted_comm_s: float     # Lemma 3.2 for this schedule + payload
    measured_compute_s: float   # mean T_C
    measured_update_s: float
    masked_measured: bool       # comm <= T_C on the wall clock
    masked_predicted: bool      # comm <= T_C per the lemma
    r_o_measured: float         # Lemma 3.1 overhead ratio from StepTimes
    tiers: Optional[Tuple[int, ...]] = None
    wire_bytes_by_tier: Optional[Tuple[float, ...]] = None
    sync_overlap: bool = False
    bucket_mb: float = 0.0            # bucket size target [MiB] (0 = unbucketed)
    n_buckets: int = 1
    bucket_sizes_bytes: Optional[Tuple[float, ...]] = None
    per_bucket_comm_s: Optional[Tuple[float, ...]] = None  # serial calibration
    exposed_comm_time: float = 0.0    # comm left outside compute [s]
    overlap_fraction: float = 0.0     # hidden comm / serial comm, in [0, 1]
    overlapped_step_s: float = 0.0    # best fused-step wall clock [s]

    @property
    def effective_link_bw(self) -> float:
        """Measured bytes/s the sync phase moved per worker (0.0 when
        nothing crossed the wire)."""
        if self.measured_comm_s <= 0:
            return 0.0
        return self.wire_bytes / self.measured_comm_s

    def as_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in self.__dataclass_fields__}
        d["effective_link_bw"] = self.effective_link_bw
        return d


def _new_group(store, rank: int, size: int, device: torch.device,
               timeout: timedelta = GROUP_TIMEOUT) -> Group:
    if device.type == "cuda":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return Group(dist.ProcessGroupNCCL(store, rank, size, opts))
    return Group(dist.ProcessGroupGloo(store, rank, size, timeout))


# ---------------------------------------------------------------------------
# torchrun: one process per card
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TorchrunEnv:
    """What ``torchrun`` tells each process it starts."""

    rank: int
    world: int
    local_rank: int
    master_addr: str
    master_port: int


def torchrun_env() -> Optional[TorchrunEnv]:
    """This process's place in a ``torchrun`` job, or None outside one.
    Raises when ``torchrun`` started the process but a variable the store
    needs is missing."""
    if not dist.is_torchelastic_launched():
        return None
    env = {}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        if not os.environ.get(var):
            raise RuntimeError(f"torchrun launched this process but {var} "
                               "is not set")
        env[var] = os.environ[var]
    return TorchrunEnv(int(env["RANK"]), int(env["WORLD_SIZE"]),
                       int(env["LOCAL_RANK"]), env["MASTER_ADDR"],
                       int(env["MASTER_PORT"]))


def torchrun_store(env: TorchrunEnv,
                   timeout: timedelta = GROUP_TIMEOUT) -> dist.TCPStore:
    """The job's ``TCPStore`` at MASTER_ADDR:MASTER_PORT: rank 0 serves it,
    unless the ``torchrun`` agent already does (it then tells its workers
    so with TORCHELASTIC_USE_AGENT_STORE, and every rank is a client, as
    ``torch.distributed``'s env:// rendezvous does)."""
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    return dist.TCPStore(env.master_addr, env.master_port, env.world,
                         is_master=env.rank == 0 and not agent,
                         timeout=timeout)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def _step_metrics(losses, gnorm, t_comm: float, t_update: float):
    """A step's metrics for the loop: the mean of the local ranks' losses
    and the phase wall times it splits out of compute."""
    return {"loss": float(np.mean(np.asarray(losses, np.float32))),
            "grad_norm": gnorm, "t_comm": t_comm, "t_update": t_update}


# per-rank steady-state numbers the report reads; one-rank trainers
# all-gather them once, at the end of train()
_SUMMARY_KEYS = ("compute", "comm", "update", "r_o", "step", "peak_bytes",
                 "calib_compute", "calib_comm", "calib_update", "exposed",
                 "fused_wall")


class DataParallelTrainer:
    """Run ``repro_torch.train.loop.train`` under an explicit sync strategy.

    All-ranks mode (``rank=None``): one rank per entry of ``devices``
    (default every visible card), one thread each.  One-rank mode: rank
    ``rank`` of ``world`` on ``devices[0]`` (default the current card),
    with its groups on ``store``; every rank's process builds the same
    trainer.  The strategy and compressor may be names or instances.
    ``link_bw`` (bytes/s) prices Lemma 3.2; None takes
    :func:`default_link_bw`.  ``group_timeout`` bounds how long a
    collective waits for its peers."""

    # serial-bucketed calibration steps at the head of an overlapped run:
    # step 0 absorbs the one-time costs, step 1 supplies the clean serial
    # decomposition (compute / per-bucket comm / update) the fused steps
    # are measured against
    N_CALIB_STEPS = 2

    def __init__(self, cfg: ModelConfig, run: RunConfig,
                 opt: opt_lib.OptConfig, *,
                 strategy: Union[str, SyncStrategy] = "all_reduce",
                 compression: Union[str, Compressor] = "none",
                 devices: Optional[List] = None,
                 link_bw: Optional[float] = None,
                 topology: Optional[ClusterSpec] = None,
                 sync_overlap: bool = False,
                 bucket_mb: float = DEFAULT_BUCKET_MB,
                 rank: Optional[int] = None,
                 world: Optional[int] = None,
                 store=None,
                 group_timeout: timedelta = GROUP_TIMEOUT,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
        self.cfg, self.run, self.opt = cfg, run, opt
        # the phase spans ARE the measurements: always a live clock
        self.tracer = (tracer if tracer is not None and tracer.enabled
                       else Tracer(enabled=True))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.sync_overlap = bool(sync_overlap)
        self.bucket_mb = float(bucket_mb)
        self.strategy = (get_strategy(strategy)
                         if isinstance(strategy, str) else strategy)
        self.compressor = (get_compressor(compression)
                           if isinstance(compression, str) else compression)
        self.rank = rank
        if rank is None:
            if world is not None or store is not None:
                raise ValueError("world and store are for one-rank mode: "
                                 "pass rank too")
            if devices is None:
                devices = [f"cuda:{i}"
                           for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("DataParallelTrainer: no devices (no card "
                                   "visible; pass devices=['cpu', ...])")
            self.devices = [resolve_device(d) for d in devices]
            self.dp = len(self.devices)
            self.ranks = list(range(self.dp))
            store = dist.HashStore()
            self._pool: Optional[ThreadPoolExecutor] = ThreadPoolExecutor(
                max_workers=self.dp, thread_name_prefix="dp-rank")
        else:
            if world is None or store is None or not 0 <= rank < world:
                raise ValueError(f"one-rank mode needs 0 <= rank < world and "
                                 f"a store; got rank={rank}, world={world}")
            devices = ["cuda"] if devices is None else list(devices)
            if len(devices) != 1:
                raise ValueError(f"one-rank mode takes one device, got "
                                 f"{devices}")
            dev = resolve_device(devices[0])
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self.devices = [dev]
            self.dp = int(world)
            self.ranks = [rank]
            self._pool = None
        self.topology = topology
        self.link_bw = (default_link_bw(self.devices, topology)
                        if link_bw is None else link_bw)
        self._tier_bws: Optional[Tuple[float, ...]] = None
        nested = None
        if self.strategy.hierarchical:
            sizes = self._resolve_tiers(topology)
            self.strategy = dataclasses.replace(self.strategy, tiers=sizes)
            if topology is not None and topology.tier_sizes == sizes:
                self._tier_bws = topology.tier_bws
            if len(sizes) > 1 and self.dp // sizes[0] > 1:
                nested = sizes[0]  # in-node ranks per node
        self._times: List[StepTimes] = []
        specs = M.model_specs(cfg)
        self._grad_bytes = 4.0 * param_count(specs)
        self._plan: Optional[BucketPlan] = None
        self._bucket_of: Dict[int, int] = {}  # leaf index -> its bucket
        if self.sync_overlap:
            self._plan = build_bucket_plan(specs, mb_to_bytes(self.bucket_mb))
            self._bucket_of = {j: k for k, b in enumerate(self._plan.buckets)
                               for j in b}
        self._calib: Dict[str, Any] = {}
        self._fused_steps: List[Dict[str, float]] = []
        self._summary: Optional[Dict[str, Any]] = None
        self._grads_of = build_grad_fn(cfg, run)
        self._axes = self._each(
            lambda i: self._make_axis(store, i, nested, group_timeout),
            sync=False)
        # overlapped steps: one communication thread per local rank, and
        # on a card a stream of its own for the bucket collectives
        self._comm: List[ThreadPoolExecutor] = []
        self._streams: List[Optional[torch.cuda.Stream]] = []
        if self.sync_overlap:
            self._comm = [ThreadPoolExecutor(1, thread_name_prefix="dp-comm")
                          for _ in self.devices]
            self._streams = [torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in self.devices]

    def _resolve_tiers(self, topology: Optional[ClusterSpec]) -> Tuple[int, ...]:
        """dp-axis fan-out per tier for the hierarchical strategy: the
        strategy's own sizing when it matches the rank count, else the
        topology's, else an adapted or degenerate split (JAX's rule)."""
        cands = []
        if self.strategy.tiers:
            cands.append(tuple(self.strategy.tiers))
        if topology is not None:
            cands.append(tuple(topology.tier_sizes))
        for sizes in cands:
            if math.prod(sizes) == self.dp:
                return sizes
        for sizes in cands:  # keep the in-node fan-out if it divides dp
            if sizes[0] > 1 and self.dp % sizes[0] == 0:
                return (sizes[0], self.dp // sizes[0])
        return (self.dp,)

    def _make_axis(self, store, i: int, inner: Optional[int],
                   timeout: timedelta):
        """Local rank i's group(s): the whole world, or (across nodes, in
        node) with ranks numbered node-major, as JAX's (nodes, data) mesh.
        Every rank builds its groups in the same order."""
        r, dev = self.ranks[i], self.devices[i]
        if inner is None:
            return _new_group(dist.PrefixStore("dp", store), r, self.dp, dev,
                              timeout)
        node, local = divmod(r, inner)
        in_node = _new_group(dist.PrefixStore(f"node{node}", store), local,
                             inner, dev, timeout)
        across = _new_group(dist.PrefixStore(f"across{local}", store), node,
                            self.dp // inner, dev, timeout)
        return (across, in_node)

    def _groups(self, i: int) -> Tuple[Group, ...]:
        """Local rank i's groups, in-node first."""
        axis = self._axes[i]
        return axis[::-1] if isinstance(axis, tuple) else (axis,)

    # ------------------------------------------------------------------
    def _each(self, fn, *, sync: bool = True) -> List[Any]:
        """Run ``fn(i)`` for every local rank i at once, each on its rank's
        device (and, with ``sync``, synchronized there before it returns),
        and return the results in rank order; a rank's exception is raised
        here.  One-rank mode runs ``fn(0)`` on the calling thread."""

        def task(i):
            dev = self.devices[i]
            if dev.type != "cuda":
                return fn(i)
            with torch.cuda.device(dev):
                out = fn(i)
                if sync:
                    torch.cuda.synchronize(dev)
                return out

        if self._pool is None:
            return [task(0)]
        futures = [self._pool.submit(task, i)
                   for i in range(len(self.devices))]
        return [f.result() for f in futures]

    def barrier(self, value: float = 0.0) -> float:
        """One-rank mode: wait until every rank gets here (a one-element
        all-reduce on each of this rank's groups, in-node first, then a
        device synchronize); returns the sum of every rank's ``value``."""

        def bar(i):
            t = torch.tensor([value], dtype=torch.float64,
                             device=self.devices[i])
            for g in self._groups(i):
                g.all_reduce(t)
            return t

        return float(self._each(bar)[0].item())

    def _losses(self, losses: List[float]) -> List[float]:
        """The local ranks' losses, or, in one-rank mode, the mean over
        every rank (one all-reduce)."""
        if self.rank is None:
            return losses
        return [self.barrier(losses[0]) / self.dp]

    def all_gather(self, vec: torch.Tensor) -> torch.Tensor:
        """(world, n): every rank's ``vec`` (float64, n entries), in rank
        order (one-rank mode)."""

        def gather(i):
            out = vec.to(self.devices[i])
            for g in self._groups(i):  # in-node, then across: node-major
                out = g.all_gather(out)
            return out.cpu()

        return self._each(gather)[0].reshape(self.dp, -1)

    def close(self) -> None:
        """Shut the process groups down and stop the rank threads."""

        def shutdown(i):
            for group in self._groups(i):
                group.pg.shutdown()

        self._each(shutdown, sync=False)
        for pool in self._comm:
            pool.shutdown(wait=True)
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    def replicate(self, params, opt_state=None):
        """Per-rank replicas of one parameter tree (and optimizer state;
        fresh when None, with an ``"ef"`` slot per rank when the
        compressor carries error feedback).  The first local rank keeps
        the tensors it is given when they already lie on its device, so
        they are updated in place; every other rank gets its own copy."""

        def to(tree, i):
            dev = self.devices[i]
            if i == 0:
                return tree_map(lambda a: a.to(dev), tree)
            return tree_map(lambda a: a.to(dev, copy=True), tree)

        n = len(self.devices)
        ps = [to(params, i) for i in range(n)]
        if opt_state is None:
            states = [opt_lib.init_state(
                self.opt, p, error_feedback=self.compressor.stateful)
                for p in ps]
        else:
            states = []
            for i in range(n):
                s = {k: (to(v, i) if isinstance(v, dict) else v)
                     for k, v in opt_state.items()}
                if self.compressor.stateful and "ef" not in s:
                    s["ef"] = tree_map(torch.zeros_like, ps[i])
                states.append(s)
        return ps, states

    def init(self, seed: int = 0):
        """Replicated params (``materialize`` on the first local rank's
        device, copied; a seeded draw, so every process of a one-rank job
        makes the same values) and optimizer states, one per local rank."""
        params = materialize(M.model_specs(self.cfg), seed, self.devices[0])
        return self.replicate(params)

    # ------------------------------------------------------------------
    def _compute(self, params, batch, i):
        loss, _, grads = self._grads_of(
            params[i], {k: v[i] for k, v in batch.items()})
        return float(loss), grads

    def _update(self, params, states, synced, i):
        _, states[i], gnorm = opt_lib.apply_updates(
            self.opt, params[i], synced[i], states[i])
        return gnorm

    def _compute_phase(self, params, batch):
        """The compute span: every local rank's gradients, ended (one-rank
        mode) by a barrier, timed into ``train/barrier_s``.  Returns the
        losses (one-rank mode: the mean over every rank), the local ranks'
        gradient trees and the span's wall time."""
        with self.tracer.span("compute") as sp:
            outs = self._each(lambda i: self._compute(params, batch, i))
            losses = [o[0] for o in outs]
            if self.rank is not None:  # the barrier carries the loss sum
                with self.tracer.span("barrier") as sp_b:
                    losses = self._losses(losses)
                self.metrics.observe("train/barrier_s", sp_b.elapsed_s)
        return losses, [o[1] for o in outs], sp.elapsed_s

    def step_fn(self):
        """A loop-compatible step: (per-rank params, per-rank opt states,
        batch of per-rank shards) -> (params, states, metrics).  The phase
        wall times ride in ``metrics`` as ``t_comm`` / ``t_update``.

        With ``sync_overlap`` the first :data:`N_CALIB_STEPS` steps run the
        serial-bucketed calibration path and every later step the fused
        overlapped one; ``t_comm`` then reports the *exposed* comm only."""
        strat, comp, dp = self.strategy, self.compressor, self.dp

        def sync(grads, states, i):
            ef = states[i].get("ef")
            g, ef = comp.apply(grads[i], ef)
            if ef is not None:
                states[i]["ef"] = ef
            return strat.sync(g, self._axes[i], dp)

        def serial(params, opt_state, batch):
            tr = self.tracer
            losses, grads, t_c = self._compute_phase(params, batch)
            with tr.span("dist_update") as sp_s:
                synced = self._each(lambda i: sync(grads, opt_state, i))
            del grads
            with tr.span("param_update") as sp_u:
                gnorms = self._each(
                    lambda i: self._update(params, opt_state, synced, i))
            self._publish_phases(t_c, sp_s.elapsed_s, sp_u.elapsed_s)
            return params, opt_state, _step_metrics(
                losses, gnorms[0], sp_s.elapsed_s, sp_u.elapsed_s)

        if not self.sync_overlap:
            return serial
        counter = {"k": 0}

        def step(params, opt_state, batch):
            k = counter["k"]
            counter["k"] = k + 1
            fn = (self._calib_step if k < self.N_CALIB_STEPS
                  else self._overlap_step)
            return fn(params, opt_state, batch)

        return step

    def _publish_phases(self, compute_s: float, comm_s: float,
                        update_s: float) -> None:
        """Per-step phase histograms (the metrics/v1 ``train/*`` family)."""
        m = self.metrics
        m.inc("train/steps")
        m.observe("train/compute_s", compute_s)
        m.observe("train/dist_update_s", comm_s)
        m.observe("train/param_update_s", update_s)
        m.observe("train/step_s", compute_s + comm_s + update_s)

    # ------------------------------------------------------------------
    # Bucketed overlap (repro_torch.distributed.overlap)
    # ------------------------------------------------------------------
    def _sync_bucket(self, i: int, k: int, g_leaves, ef_leaves, out) -> None:
        """Compress + sync bucket k of local rank i's flatten-order
        gradient leaves into ``out``; a stateful compressor's residuals are
        written back into ``ef_leaves``.  A bucket is a tree keyed in
        bucket order, so every strategy and compressor applies as is."""
        idx = self._plan.buckets[k]
        keys = [f"{n:06d}" for n in range(len(idx))]
        g = dict(zip(keys, (g_leaves[j] for j in idx)))
        ef = (None if ef_leaves is None
              else dict(zip(keys, (ef_leaves[j] for j in idx))))
        g, ef = self.compressor.apply(g, ef)
        if ef is not None:
            for key, j in zip(keys, idx):
                ef_leaves[j] = ef[key]
        synced = self.strategy.sync(g, self._axes[i], self.dp)
        for key, j in zip(keys, idx):
            out[j] = synced[key]

    def _ef_leaves(self, states, i):
        """Local rank i's error-feedback leaves (flatten order) or None."""
        ef = states[i].get("ef")
        return None if ef is None else [v for _, v in tree_items(ef)]

    def _finish(self, params, states, out, ef_leaves, i):
        """Rebuild rank i's synced gradient (and residual) trees from their
        flatten-order leaves and apply the optimizer update."""
        paths = [p for p, _ in tree_items(params[i])]
        if ef_leaves is not None:
            states[i]["ef"] = tree_unflatten(zip(paths, ef_leaves))
        synced = tree_unflatten(zip(paths, out))
        _, states[i], gnorm = opt_lib.apply_updates(
            self.opt, params[i], synced, states[i])
        return gnorm

    def _calib_step(self, params, states, batch):
        """Serial-bucketed step: the fused path's numerics, but each
        bucket's sync blocks, giving the per-bucket serial decomposition
        the overlap measurement is set against (``per_bucket_comm_s`` is
        the ``bucket_sync`` span durations)."""
        plan, tr = self._plan, self.tracer
        losses, grads, t_c = self._compute_phase(params, batch)
        n = len(self.devices)
        g_leaves = [[g for _, g in tree_items(t)] for t in grads]
        ef_leaves = [self._ef_leaves(states, i) for i in range(n)]
        out = [[None] * plan.n_leaves for _ in range(n)]
        per_bucket: List[float] = []
        with tr.span("dist_update", n_buckets=plan.n_buckets) as sp_s:
            for k in range(plan.n_buckets):
                with tr.span("bucket_sync",
                             **bucket_span_args(plan, k)) as sp_b:
                    self._each(lambda i: self._sync_bucket(
                        i, k, g_leaves[i], ef_leaves[i], out[i]))
                per_bucket.append(sp_b.elapsed_s)
        del grads, g_leaves
        with tr.span("param_update") as sp_u:
            gnorms = self._each(lambda i: self._finish(
                params, states, out[i], ef_leaves[i], i))
        # the last calibration step is the clean one
        self._calib = {"compute": t_c, "comm": sp_s.elapsed_s,
                       "update": sp_u.elapsed_s,
                       "per_bucket": tuple(per_bucket)}
        self._publish_phases(t_c, sp_s.elapsed_s, sp_u.elapsed_s)
        for t in per_bucket:
            self.metrics.observe("train/bucket_comm_s", t)
        return params, states, _step_metrics(losses, gnorms[0],
                                             sp_s.elapsed_s, sp_u.elapsed_s)

    def _fused(self, params, states, batch, i):
        """Local rank i's overlapped step: the backward pass hands each
        bucket to the rank's communication thread as soon as autograd has
        finished its leaves (in bucket order, so every rank issues the
        same collectives in the same order); every bucket is waited on
        before the optimizer update.  On a card the bucket work runs on the
        rank's own stream, after an event the hook records on the
        backward's stream."""
        plan, dev = self._plan, self.devices[i]
        stream, pool = self._streams[i], self._comm[i]
        g_leaves: List[Optional[torch.Tensor]] = [None] * plan.n_leaves
        ef_leaves = self._ef_leaves(states, i)
        out: List[Optional[torch.Tensor]] = [None] * plan.n_leaves
        missing = [len(b) for b in plan.buckets]
        futures = []

        def comm(k, ready):
            if stream is None:
                return self._sync_bucket(i, k, g_leaves, ef_leaves, out)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_event(ready)
                for j in plan.buckets[k]:  # made on the backward's stream
                    g_leaves[j].record_stream(stream)
                    if ef_leaves is not None:
                        ef_leaves[j].record_stream(stream)
                self._sync_bucket(i, k, g_leaves, ef_leaves, out)

        def on_leaf(j, g):
            g_leaves[j] = g
            missing[self._bucket_of[j]] -= 1
            while len(futures) < plan.n_buckets and not missing[len(futures)]:
                ready = None
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(dev))
                futures.append(pool.submit(comm, len(futures), ready))

        loss, _, grads = self._grads_of(
            params[i], {k: v[i] for k, v in batch.items()}, on_leaf=on_leaf)
        for j, (_, g) in enumerate(tree_items(grads)):
            if g_leaves[j] is None:  # a leaf the loss does not reach
                on_leaf(j, g)
        for f in futures:
            f.result()
        if stream is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_stream(stream)
            for t in out:
                t.record_stream(cur)
        del grads, g_leaves
        return float(loss), self._finish(params, states, out, ef_leaves, i)

    def _overlap_step(self, params, states, batch):
        """Fused overlapped step, timed as one span; the serial calibration
        decomposition attributes the wall clock to exposed comm versus the
        compute and update it hid under."""
        with self.tracer.span("fused_step") as sp:
            outs = self._each(lambda i: self._fused(params, states, batch, i))
        wall = sp.elapsed_s
        comm_s = self._calib.get("comm", 0.0)
        comp_s = self._calib.get("compute", 0.0)
        upd_s = self._calib.get("update", 0.0)
        exposed = min(max(wall - comp_s - upd_s, 0.0), comm_s)
        self._fused_steps.append({"wall_s": wall, "exposed_comm_s": exposed,
                                  "serial_comm_s": comm_s})
        m = self.metrics
        m.inc("train/steps")
        m.observe("train/step_s", wall)
        m.observe("train/fused_step_s", wall)
        m.observe("train/exposed_comm_s", exposed)
        t_update = min(upd_s, max(wall - exposed, 0.0))
        losses = self._losses([o[0] for o in outs])  # after the span
        return params, states, _step_metrics(losses, outs[0][1], exposed,
                                             t_update)

    # ------------------------------------------------------------------
    def train(self, *, batch: int, seq: int, steps: int, seed: int = 0,
              log_every: int = 10, params=None, opt_state=None,
              ckpt_dir: Optional[str] = None,
              ckpt_every: int = 0) -> loop_lib.TrainResult:
        """Train ``steps`` steps of a global batch of ``batch`` rows (each
        rank takes its 1/dp shard).  ``params`` / ``opt_state`` are one
        tree (replicated, see :meth:`replicate`) or None for a fresh init.
        The final per-rank replicas are kept in ``self.params`` /
        ``self.opt_states``.  A one-rank trainer logs only on rank 0 and,
        at the end, all-gathers every rank's steady-state phase means for
        :meth:`report`."""
        if batch % self.dp:
            raise ValueError(f"batch {batch} not divisible by dp={self.dp} "
                             "(equal shards are required for exact means)")
        # fresh measurements per run
        self._calib, self._fused_steps, self._summary = {}, [], None
        if params is None:
            params, states = self.init(seed)
        else:
            params, states = self.replicate(params, opt_state)
        loader = None
        if self.rank is not None:
            loader = PrefetchLoader(self.cfg, batch, seq,
                                    device=self.devices, seed=seed,
                                    shard=(self.rank, self.dp))
            log_every = log_every if self.rank == 0 else 0
        try:
            res = loop_lib.train(
                self.cfg, self.run, self.opt, batch=batch, seq=seq,
                steps=steps, seed=seed, device=self.devices, loader=loader,
                log_every=log_every, params=params, opt_state=states,
                step_fn=self.step_fn(), ckpt_dir=ckpt_dir,
                ckpt_every=ckpt_every, tracer=self.tracer)
        finally:
            if loader is not None:
                loader.close()
        self.params, self.opt_states = params, states
        self._times = res.step_times
        self._summary = self._gather_summary(self._local_summary())
        return res

    # ------------------------------------------------------------------
    def _local_summary(self) -> Dict[str, Any]:
        """This process's steady-state numbers: phase means over the steps
        after the warmup (an overlapped run also skips its first fused
        step), the calibration decomposition, and the best fused step."""
        warmup = (self.N_CALIB_STEPS + 1) if self.sync_overlap else 2
        steady = self._times[warmup:] or self._times

        def mean(f):
            return float(np.mean([f(t) for t in steady])) if steady else 0.0

        fused = self._fused_steps[1:] or self._fused_steps
        dev = self.devices[0]
        s = {"compute": mean(lambda t: t.compute),
             "comm": mean(lambda t: t.dist_update),
             "update": mean(lambda t: t.param_update),
             "r_o": mean(lambda t: t.r_o()),
             "step": mean(lambda t: t.compute + t.dist_update
                          + t.param_update),
             "peak_bytes": (float(torch.cuda.max_memory_allocated(dev))
                            if dev.type == "cuda" else 0.0),
             "calib_compute": float(self._calib.get("compute", 0.0)),
             "calib_comm": float(self._calib.get("comm", 0.0)),
             "calib_update": float(self._calib.get("update", 0.0)),
             # best-of, like autotune's timing: host noise inflates a fused
             # step, it never deflates one; -1 marks "no fused step ran"
             "exposed": (min(f["exposed_comm_s"] for f in fused)
                         if fused else -1.0),
             "fused_wall": min(f["wall_s"] for f in fused) if fused else 0.0}
        s["per_bucket"] = tuple(self._calib.get("per_bucket", ()))
        return s

    def _gather_summary(self, local: Dict[str, Any]) -> Dict[str, Any]:
        """One-rank mode: every rank's summary, all-gathered once, and the
        slowest rank's (the largest steady step) kept, so every rank
        reports the same numbers.  All-ranks mode: ``local``."""
        if self.rank is None:
            return local
        vec = torch.tensor([local[k] for k in _SUMMARY_KEYS]
                           + list(local["per_bucket"]), dtype=torch.float64)
        rows = self.all_gather(vec)
        slow = rows[int(torch.argmax(rows[:, _SUMMARY_KEYS.index("step")]))]
        out = {k: float(v) for k, v in zip(_SUMMARY_KEYS, slow.tolist())}
        out["per_bucket"] = tuple(slow[len(_SUMMARY_KEYS):].tolist())
        out["slowest_rank"] = int(torch.argmax(
            rows[:, _SUMMARY_KEYS.index("step")]))
        return out

    @property
    def summary(self) -> Dict[str, Any]:
        """The steady-state numbers :meth:`report` reads (after
        :meth:`train`): phase means (s), R_O, the mean step, peak device
        memory (bytes; 0 on the CPU), the overlap calibration and the best
        fused step; in one-rank mode the slowest rank's."""
        if self._summary is None:
            self._summary = self._gather_summary(self._local_summary())
        return self._summary

    def report(self) -> SyncReport:
        """Measured comm against the Lemma 3.2 prediction.  Steady state:
        the first two steps, which pay one-time setup, are left out; an
        overlapped run also leaves out its first fused step, takes
        ``measured_comm_s`` from the bucketed calibration step and reports
        how much of it the fused steps hid.  A one-rank trainer reports
        the slowest rank's numbers (every rank the same)."""
        s = self.summary
        comm, compute, upd = s["comm"], s["compute"], s["update"]
        s_p = self._grad_bytes
        wire_payload = self.compressor.wire_bytes(s_p)
        wire = self.strategy.wire_bytes(wire_payload, self.dp)
        predicted = self.strategy.predicted_comm_time(
            wire_payload, self.dp, self.link_bw, tier_bws=self._tier_bws)
        plan = self._plan
        exposed, frac, fused_wall = comm, 0.0, 0.0
        if self.sync_overlap:
            comm = s["calib_comm"] if s["calib_comm"] > 0 else comm
            # no fused step ran (too few steps): fully exposed
            exposed = s["exposed"] if s["exposed"] >= 0 else comm
            fused_wall = s["fused_wall"]
            frac = (min(max(1.0 - exposed / comm, 0.0), 1.0)
                    if comm > 0 else 0.0)
        m = self.metrics
        m.set_gauge("train/measured_comm_s", comm)
        m.set_gauge("train/overlap_fraction", frac)
        m.set_gauge("train/exposed_comm_time_s", exposed)
        m.set_gauge("train/n_buckets", plan.n_buckets if plan else 1)
        m.set_gauge("train/effective_link_bw", wire / comm if comm > 0 else 0.0)
        return SyncReport(
            strategy=self.strategy.name, compression=self.compressor.name,
            dp=self.dp, n_servers=self.strategy.n_servers,
            grad_bytes=s_p, wire_bytes=wire, link_bw=self.link_bw,
            measured_comm_s=comm, predicted_comm_s=predicted,
            measured_compute_s=compute, measured_update_s=upd,
            masked_measured=comm <= compute,
            masked_predicted=predicted <= compute,
            r_o_measured=s["r_o"],
            tiers=self.strategy.tiers,
            wire_bytes_by_tier=(
                self.strategy.wire_bytes_by_tier(wire_payload, self.dp)
                if self.strategy.hierarchical else None),
            sync_overlap=self.sync_overlap,
            bucket_mb=self.bucket_mb if self.sync_overlap else 0.0,
            n_buckets=plan.n_buckets if plan else 1,
            bucket_sizes_bytes=plan.sizes_bytes if plan else None,
            per_bucket_comm_s=s["per_bucket"] or None,
            exposed_comm_time=exposed,
            overlap_fraction=frac,
            overlapped_step_s=fused_wall)
