"""DataParallelTrainer (the port of ``repro.distributed.trainer``, the
serial three-phase step): the training loop under an explicit
gradient-sync strategy.

JAX runs its dp devices in one process; so does the port: one thread per
rank, each with its own device (``cuda:r``, or the CPU when asked) and
its own replica of the parameters and optimizer state, all ranks in one
process group built on an in-process ``HashStore`` (gloo on the CPU,
NCCL on cards; the hierarchical strategy's node sub-groups under
``PrefixStore``s).  The strategies see only a :class:`Group` and a rank,
so they would run the same with one process per card.

The step is three phases, each a tracer span that ends once every rank
has finished it (and, on cards, synchronized), so the span wall clocks are
the measurements that land in ``StepTimes`` and :class:`SyncReport`:

  1. **compute**      — each rank's gradients on its batch shard,
  2. **dist_update**  — compress + sync collectives (the Lemma 3.2 payload),
  3. **param_update** — each rank's optimizer update on the synced mean.

Each rank computes the mean loss over its shard and the strategy returns
the mean over ranks, so with equal shards the synced gradient is the
full-batch gradient up to reduction order.

Bucketed overlap (``sync_overlap``) and checkpointing are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import ClusterSpec
from repro_torch.core.pipeline import StepTimes
from repro_torch.distributed.collectives import (Group, SyncStrategy,
                                                 get_strategy)
from repro_torch.distributed.compression import Compressor, get_compressor
from repro_torch.launch.steps import build_grad_fn
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import (materialize, param_count,
                                       resolve_device, tree_map)
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.optim import adamw as opt_lib
from repro_torch.train import loop as loop_lib

# "link" bandwidth for the Lemma 3.2 prediction when the caller gives none
# (bytes/s; the JAX package's CPU-emulation default)
DEFAULT_LINK_BW = 4e9
# how long a collective may wait for its peers before the group fails
GROUP_TIMEOUT = timedelta(seconds=300)


@dataclass
class SyncReport:
    """Measured-vs-predicted Lemma 3.1/3.2 numbers for one training run
    (the JAX package's fields; the overlap fields keep their serial
    values: the sync is fully exposed)."""

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
    bucket_mb: float = 0.0
    n_buckets: int = 1
    bucket_sizes_bytes: Optional[Tuple[float, ...]] = None
    per_bucket_comm_s: Optional[Tuple[float, ...]] = None
    exposed_comm_time: float = 0.0
    overlap_fraction: float = 0.0
    overlapped_step_s: float = 0.0

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


def _new_group(store, rank: int, size: int, device: torch.device) -> Group:
    if device.type == "cuda":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = GROUP_TIMEOUT
        return Group(dist.ProcessGroupNCCL(store, rank, size, opts))
    return Group(dist.ProcessGroupGloo(store, rank, size, GROUP_TIMEOUT))


class DataParallelTrainer:
    """Run ``repro_torch.train.loop.train`` under an explicit sync strategy
    on ``devices`` (one rank each; default every visible card).  The
    strategy and compressor may be names or instances."""

    def __init__(self, cfg: ModelConfig, run: RunConfig,
                 opt: opt_lib.OptConfig, *,
                 strategy: Union[str, SyncStrategy] = "all_reduce",
                 compression: Union[str, Compressor] = "none",
                 devices: Optional[List] = None,
                 link_bw: float = DEFAULT_LINK_BW,
                 topology: Optional[ClusterSpec] = None,
                 sync_overlap: bool = False,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if sync_overlap:
            raise NotImplementedError(
                "bucketed overlap (sync_overlap) is not ported yet "
                "(ROADMAP A12, distributed/overlap.py)")
        self.cfg, self.run, self.opt = cfg, run, opt
        # the phase spans ARE the measurements: always a live clock
        self.tracer = (tracer if tracer is not None and tracer.enabled
                       else Tracer(enabled=True))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.strategy = (get_strategy(strategy)
                         if isinstance(strategy, str) else strategy)
        self.compressor = (get_compressor(compression)
                           if isinstance(compression, str) else compression)
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("DataParallelTrainer: no devices (no card "
                               "visible; pass devices=['cpu', ...])")
        self.devices = [resolve_device(d) for d in devices]
        self.dp = len(self.devices)
        self.topology = topology
        self.link_bw = link_bw
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
        self._grad_bytes = 4.0 * param_count(M.model_specs(cfg))
        self._grads_of = build_grad_fn(cfg, run)
        self._pool = ThreadPoolExecutor(max_workers=self.dp,
                                        thread_name_prefix="dp-rank")
        store = dist.HashStore()
        self._axes = self._each(lambda r: self._make_axis(store, r, nested),
                                sync=False)

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

    def _make_axis(self, store, r: int, inner: Optional[int]):
        """Rank ``r``'s group(s): the whole world, or (across nodes, in
        node) with ranks numbered node-major, as JAX's (nodes, data) mesh."""
        dev = self.devices[r]
        if inner is None:
            return _new_group(dist.PrefixStore("dp", store), r, self.dp, dev)
        node, local = divmod(r, inner)
        in_node = _new_group(dist.PrefixStore(f"node{node}", store), local,
                             inner, dev)
        across = _new_group(dist.PrefixStore(f"across{local}", store), node,
                            self.dp // inner, dev)
        return (across, in_node)

    # ------------------------------------------------------------------
    def _each(self, fn, *, sync: bool = True) -> List[Any]:
        """Run ``fn(rank)`` for every rank at once, each on its rank's
        device (and, with ``sync``, synchronized there before it returns),
        and return the results in rank order; a rank's exception is
        raised here."""

        def task(r):
            dev = self.devices[r]
            if dev.type != "cuda":
                return fn(r)
            with torch.cuda.device(dev):
                out = fn(r)
                if sync:
                    torch.cuda.synchronize(dev)
                return out

        futures = [self._pool.submit(task, r) for r in range(self.dp)]
        return [f.result() for f in futures]

    def close(self) -> None:
        """Shut the process groups down and stop the rank threads."""

        def shutdown(r):
            axis = self._axes[r]
            for group in (axis if isinstance(axis, tuple) else (axis,)):
                group.pg.shutdown()

        self._each(shutdown, sync=False)
        self._pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    def replicate(self, params, opt_state=None):
        """Per-rank replicas of one parameter tree (and optimizer state;
        fresh when None, with an ``"ef"`` slot per rank when the
        compressor carries error feedback).  Rank 0 keeps the tensors it
        is given when they already lie on its device, so they are updated
        in place; every other rank gets its own copy."""

        def to(tree, r):
            dev = self.devices[r]
            if r == 0:
                return tree_map(lambda a: a.to(dev), tree)
            return tree_map(lambda a: a.to(dev, copy=True), tree)

        ps = [to(params, r) for r in range(self.dp)]
        if opt_state is None:
            states = [opt_lib.init_state(
                self.opt, p, error_feedback=self.compressor.stateful)
                for p in ps]
        else:
            states = []
            for r in range(self.dp):
                s = {k: (to(v, r) if isinstance(v, dict) else v)
                     for k, v in opt_state.items()}
                if self.compressor.stateful and "ef" not in s:
                    s["ef"] = tree_map(torch.zeros_like, ps[r])
                states.append(s)
        return ps, states

    def init(self, seed: int = 0):
        """Replicated params (``materialize`` on rank 0's device, copied)
        and optimizer states, one per rank."""
        params = materialize(M.model_specs(self.cfg), seed, self.devices[0])
        return self.replicate(params)

    def step_fn(self):
        """A loop-compatible step: (per-rank params, per-rank opt states,
        batch of per-rank shards) -> (params, states, metrics).  The phase
        wall times ride in ``metrics`` as ``t_comm`` / ``t_update``."""
        strat, comp, dp = self.strategy, self.compressor, self.dp

        def compute(params, batch, r):
            loss, _, grads = self._grads_of(
                params[r], {k: v[r] for k, v in batch.items()})
            return float(loss), grads

        def sync(grads, states, r):
            ef = states[r].get("ef")
            g, ef = comp.apply(grads[r], ef)
            if ef is not None:
                states[r]["ef"] = ef
            return strat.sync(g, self._axes[r], dp)

        def update(params, states, synced, r):
            _, states[r], gnorm = opt_lib.apply_updates(
                self.opt, params[r], synced[r], states[r])
            return gnorm

        def step(params, opt_state, batch):
            tr = self.tracer
            with tr.span("compute") as sp_c:
                outs = self._each(lambda r: compute(params, batch, r))
            losses = [o[0] for o in outs]
            grads = [o[1] for o in outs]
            with tr.span("dist_update") as sp_s:
                synced = self._each(lambda r: sync(grads, opt_state, r))
            del grads
            with tr.span("param_update") as sp_u:
                gnorms = self._each(
                    lambda r: update(params, opt_state, synced, r))
            self._publish_phases(sp_c.elapsed_s, sp_s.elapsed_s,
                                 sp_u.elapsed_s)
            metrics = {"loss": float(np.mean(np.asarray(losses, np.float32))),
                       "grad_norm": gnorms[0],
                       "t_comm": sp_s.elapsed_s, "t_update": sp_u.elapsed_s}
            return params, opt_state, metrics

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
    def train(self, *, batch: int, seq: int, steps: int, seed: int = 0,
              log_every: int = 10, params=None, opt_state=None,
              ckpt_dir: Optional[str] = None,
              ckpt_every: int = 0) -> loop_lib.TrainResult:
        """Train ``steps`` steps.  ``params`` / ``opt_state`` are one tree
        (replicated, see :meth:`replicate`) or None for a fresh init.
        The final per-rank replicas are kept in ``self.params`` /
        ``self.opt_states``."""
        if batch % self.dp:
            raise ValueError(f"batch {batch} not divisible by dp={self.dp} "
                             "(equal shards are required for exact means)")
        if params is None:
            params, states = self.init(seed)
        else:
            params, states = self.replicate(params, opt_state)
        res = loop_lib.train(
            self.cfg, self.run, self.opt, batch=batch, seq=seq, steps=steps,
            seed=seed, device=self.devices, log_every=log_every,
            params=params, opt_state=states, step_fn=self.step_fn(),
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, tracer=self.tracer)
        self.params, self.opt_states = params, states
        self._times = res.step_times
        return res

    # ------------------------------------------------------------------
    def report(self) -> SyncReport:
        """Measured comm against the Lemma 3.2 prediction (steady state:
        the first two steps, which pay one-time setup, are left out)."""
        steady = self._times[2:] or self._times
        comm = float(np.mean([t.dist_update for t in steady])) if steady else 0.0
        compute = float(np.mean([t.compute for t in steady])) if steady else 0.0
        upd = float(np.mean([t.param_update for t in steady])) if steady else 0.0
        s_p = self._grad_bytes
        wire_payload = self.compressor.wire_bytes(s_p)
        wire = self.strategy.wire_bytes(wire_payload, self.dp)
        predicted = self.strategy.predicted_comm_time(
            wire_payload, self.dp, self.link_bw, tier_bws=self._tier_bws)
        r_o = float(np.mean([t.r_o() for t in steady])) if steady else 0.0
        m = self.metrics
        m.set_gauge("train/measured_comm_s", comm)
        m.set_gauge("train/overlap_fraction", 0.0)
        m.set_gauge("train/exposed_comm_time_s", comm)
        m.set_gauge("train/n_buckets", 1)
        m.set_gauge("train/effective_link_bw", wire / comm if comm > 0 else 0.0)
        return SyncReport(
            strategy=self.strategy.name, compression=self.compressor.name,
            dp=self.dp, n_servers=self.strategy.n_servers,
            grad_bytes=s_p, wire_bytes=wire, link_bw=self.link_bw,
            measured_comm_s=comm, predicted_comm_s=predicted,
            measured_compute_s=compute, measured_update_s=upd,
            masked_measured=comm <= compute,
            masked_predicted=predicted <= compute,
            r_o_measured=r_o,
            tiers=self.strategy.tiers,
            wire_bytes_by_tier=(
                self.strategy.wire_bytes_by_tier(wire_payload, self.dp)
                if self.strategy.hierarchical else None),
            exposed_comm_time=comm)
