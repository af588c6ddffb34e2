"""PipelineTrainer (the port of ``repro.distributed.pipeline``): executable
1F1B pipeline parallelism over ``pipe`` stages x ``dp`` data shards.

The model's cycle stack is cut into ``pipe`` contiguous stage groups
(:func:`repro_torch.core.pipeline.balanced_stage_cut`); each stage holds
only its slice of the stacked slot parameters (stage 0 also the
embedding, the last stage the final norm and the LM head).  One process
drives every stage, as JAX's single controller does: a step runs the
non-interleaved 1F1B schedule (:func:`schedule_1f1b`) in order, and every
``(stage, fwd|bwd, microbatch)`` op is one call per data shard of that
stage, each on its shard's device (the shards in threads, as
``DataParallelTrainer`` runs its ranks), timed as a tracer span
(``pipe_fwd`` / ``pipe_bwd`` with ``stage`` and ``micro`` args) that ends
when every shard's device has synchronized.  The measured span durations
replay through :func:`simulate_1f1b` to set the measured bubble against
the analytic ``(p-1)/(m+p-1)``: that is :meth:`pipeline_report`.

``devices`` holds ``pipe * dp`` entries, stage-major (stage s owns
entries ``s*dp .. s*dp + dp - 1``).  A card may appear in several stages:
on a one-card machine every stage shares ``cuda:0``
(:func:`pipeline_devices`).  The data shards of one stage need cards of
their own (an NCCL group takes one rank a card).

The numerics are those of the single-stage
:class:`~repro_torch.distributed.trainer.DataParallelTrainer` on ``dp``
ranks with ``run.microbatch`` set to this trainer's rows per microbatch
and shard, on the same token stream:

* a stage runs the single-stage op sequence (``cast_params`` → embed →
  the ``first_k_dense`` prelude → the stage's cycles
  (``models.model.run_cycles``) → final norm → logits → masked CE +
  0.01·aux), split at cycle boundaries: both paths call the same helpers
  of ``models/model.py``.  Stage 0 runs the embedding and the prelude;
* the carry between stages is ``(h, aux)``, as in JAX: the activations
  and the running MoE aux-loss sum, to which each stage adds its slots'
  aux one at a time (as the single-stage stack does), so the last
  stage's loss is ``ce + 0.01·aux`` of the same sum.  Every stage's aux
  cotangent is the constant 0.01 (d loss / d aux), so the backward does
  not thread it; a stage without MoE slots carries the float 0.0;
* the **fwd** op runs under ``torch.no_grad()`` and keeps only the stage's
  input; the **bwd** op recomputes the stage forward with grad enabled and
  takes ``torch.autograd.grad`` (JAX's ``jax.vjp`` recompute), which keeps
  1F1B's memory to the stages' inputs;
* gradients accumulate as ``launch.steps.build_grad_fn`` does:
  ``x.float().clone()``, then ``add_`` in microbatch order (1F1B finishes
  the backwards in index order on every stage), divided by ``m`` in the
  sync;
* each stage syncs its accumulated shard over its own dp-wide group with
  the same strategy and compressor: every strategy is element-wise over
  the data ranks, so a stage's sync of its slice is the slice of the
  full sync, up to the reduction order the backend picks for a tensor of
  that size;
* the synced shards reassemble into the full gradient tree (slot slices
  concatenate along the cycle axis; the tied embedding's head cotangent
  reaches stage 0 and is added to the lookup cotangent per microbatch,
  before the accumulation, as autograd adds a shared leaf's two uses) and
  ONE ``optim.adamw.apply_updates`` runs on the fp32 masters, one tree on
  ``devices[0]``, so the global-norm clip sees the single-stage leaf set.

The tied-embedding add is the single-stage one only at ``dtype="float32"``
(under bf16 the single-stage path sums the two cotangents in bf16 before
the cast's backward).

Refused, with JAX's exception types: multi-codebook embeddings and image
prefixes (``NotImplementedError``), ``run.microbatch`` (``ValueError``:
the trainer owns the microbatches), stateful (error-feedback)
compressors (``NotImplementedError``), ``n_microbatch < pipe``, a device
list that ``pipe`` does not divide, and (in :meth:`train`) a batch that
``dp * n_microbatch`` does not divide (``ValueError``).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline import (StepTimes, balanced_stage_cut,
                                       pipeline_bubble, schedule_1f1b,
                                       simulate_1f1b, simulate_serial)
from repro_torch.distributed.collectives import SyncStrategy, get_strategy
from repro_torch.distributed.compression import Compressor, get_compressor
from repro_torch.distributed.trainer import (GROUP_TIMEOUT, SyncReport,
                                             _new_group, default_link_bw)
from repro_torch.launch.steps import torch_grad
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import (param_count, resolve_device,
                                       tree_items, tree_map, tree_unflatten)
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.optim import adamw as opt_lib
from repro_torch.train import loop as loop_lib


@dataclass
class PipelineReport:
    """Measured-vs-model 1F1B schedule numbers for one training run."""

    pipe: int
    n_microbatch: int
    stage_cut: Tuple[int, ...]
    bubble_measured: float      # span durations replayed via simulate_1f1b
    bubble_model: float         # (p-1)/(m+p-1)
    bubble_serial: float        # the no-overlap reference schedule
    makespan_s: float
    stage_busy_s: Tuple[float, ...]
    fwd_times_s: Tuple[Tuple[float, ...], ...]   # [stage][micro]
    bwd_times_s: Tuple[Tuple[float, ...], ...]

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


def _stage_params(params, cfg: ModelConfig, cut: Tuple[int, ...], s: int):
    """Stage ``s``'s parameter slice: slot stacks cut ``cut[s]:cut[s+1]``
    along the cycle axis (views), plus the embedding on stage 0 and the
    final norm (+ LM head, or the tied embedding under the ``embed_out``
    key so its head cotangent stays separable) on the last stage."""
    p = len(cut) - 1
    sp: Dict[str, Any] = {
        "slots": tree_map(lambda a: a[cut[s]:cut[s + 1]], params["slots"])
    }
    if s == 0:
        sp["embed"] = params["embed"]
        if "prelude" in params:
            sp["prelude"] = params["prelude"]
    if s == p - 1:
        sp["final_norm"] = params["final_norm"]
        if cfg.tie_embeddings:
            if p > 1:
                sp["embed_out"] = params["embed"]
            # p == 1: the stage's own "embed" serves lookup AND head, so
            # autograd itself sums the two cotangents, as single-stage does
        elif "lm_head" in params:
            sp["lm_head"] = params["lm_head"]
    return sp


def _to(carry, dev):
    """A stage's ``(h, aux)`` carry on ``dev`` (aux may be the float 0.0)."""
    h, aux = carry
    return h.to(dev), (aux.to(dev) if torch.is_tensor(aux) else aux)


def pipeline_devices(device, world: int) -> List[torch.device]:
    """``world`` stage-major entries for a pipeline trainer: ``device`` for
    every entry on the CPU; on cards ``cuda:(i % count)``, so that with
    fewer cards than entries the stages share them (every stage on
    ``cuda:0`` on a one-card machine)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * world
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(world)]


class PipelineTrainer:
    """1F1B over ``pipe`` stages x ``len(devices) // pipe`` data shards,
    loop-compatible (``step_fn`` / ``train`` / ``report``) with the
    DataParallelTrainer so the Session can swap it in.  ``devices``
    defaults to every visible card; ``link_bw`` (bytes/s) prices Lemma
    3.2, None taking ``distributed.trainer.default_link_bw``."""

    def __init__(self, cfg: ModelConfig, run: RunConfig,
                 opt: opt_lib.OptConfig, *,
                 pipe: int, n_microbatch: int = 0,
                 strategy: Union[str, SyncStrategy] = "all_reduce",
                 compression: Union[str, Compressor] = "none",
                 devices: Optional[List] = None,
                 link_bw: Optional[float] = None,
                 group_timeout: timedelta = GROUP_TIMEOUT,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if cfg.num_codebooks:
            raise NotImplementedError(
                "pipeline stages need a single token embedding "
                "(multi-codebook unsupported)")
        if cfg.num_image_tokens:
            raise NotImplementedError(
                "pipeline trainer does not take VLM image prefixes")
        if run.microbatch:
            raise ValueError(
                "set n_microbatch on the trainer, not run.microbatch — "
                "1F1B owns the microbatch loop")
        M.check_ported(cfg)
        self.cfg, self.run, self.opt = cfg, run, opt
        # the op spans ARE the measurements: always a live clock
        self.tracer = (tracer if tracer is not None and tracer.enabled
                       else Tracer(enabled=True))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.strategy = (get_strategy(strategy)
                         if isinstance(strategy, str) else strategy)
        self.compressor = (get_compressor(compression)
                           if isinstance(compression, str) else compression)
        if self.compressor.stateful:
            raise NotImplementedError(
                "stateful (error-feedback) compressors are not supported "
                "under the pipeline trainer")
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devs = [resolve_device(d) for d in devices]
        if pipe < 1 or not devs or len(devs) % pipe:
            raise ValueError(f"pipe={pipe} must divide the {len(devs)} "
                             "devices")
        self.pipe = int(pipe)
        self.dp = len(devs) // self.pipe          # data shards per stage
        self.n_microbatch = int(n_microbatch) or self.pipe
        if self.n_microbatch < self.pipe:
            raise ValueError(f"n_microbatch={self.n_microbatch} must be >= "
                             f"pipe={self.pipe} (1F1B needs a full fill)")
        self.devices = devs
        self.grid = [devs[s * self.dp:(s + 1) * self.dp]
                     for s in range(self.pipe)]
        for row in self.grid:
            cards = [d for d in row if d.type == "cuda"]
            if len(set(cards)) != len(cards):
                raise ValueError(f"the data shards of a stage need a card "
                                 f"each, got {row}")
        if self.strategy.hierarchical:
            # per-stage groups are flat: the degenerate single-tier sizing
            # the single-stage trainer resolves without a topology
            self.strategy = dataclasses.replace(self.strategy,
                                                tiers=(self.dp,))
        self.stage_cut = balanced_stage_cut(M.main_cycles(cfg), self.pipe)
        self.link_bw = (default_link_bw(devs, None) if link_bw is None
                        else link_bw)
        self._grad_bytes = 4.0 * param_count(M.model_specs(cfg))
        self._times: List[StepTimes] = []
        # per-step measured op durations: [step][stage][micro]
        self._fwd_obs: List[List[List[float]]] = []
        self._bwd_obs: List[List[List[float]]] = []
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(self.dp, thread_name_prefix="pipe-shard")
            if self.dp > 1 else None)
        # one group per data shard of each stage, over that stage's dp
        # shards (gloo on the CPU, NCCL on cards)
        store = dist.HashStore()
        self._groups = [self._each(s, lambda d, s=s: _new_group(
            dist.PrefixStore(f"stage{s}", store), d, self.dp,
            self.grid[s][d], group_timeout), sync=False)
            for s in range(self.pipe)]

    # ------------------------------------------------------------------
    @classmethod
    def from_plan(cls, plan, cfg: ModelConfig, run: RunConfig,
                  opt: opt_lib.OptConfig, **kw) -> "PipelineTrainer":
        """Trainer whose stage count, microbatching and sync strategy come
        from a planner ``Plan`` (``resolve_sync()`` supplies the
        Lemma-3.2-sized strategy instance); the other keywords
        (compression, devices, link_bw, telemetry) pass through."""
        return cls(cfg, run, opt, pipe=int(getattr(plan, "pipe", 1) or 1),
                   n_microbatch=int(getattr(plan, "n_microbatch", 0) or 0),
                   strategy=plan.resolve_sync(), **kw)

    def _each(self, s: int, fn, *, sync: bool = True) -> List[Any]:
        """``fn(d)`` for every data shard d of stage s at once, each on its
        shard's device (and, with ``sync``, synchronized there before it
        returns); the results in shard order."""

        def task(d):
            dev = self.grid[s][d]
            if dev.type != "cuda":
                return fn(d)
            with torch.cuda.device(dev):
                out = fn(d)
                if sync:
                    torch.cuda.synchronize(dev)
                return out

        if self._pool is None:
            return [task(0)]
        futures = [self._pool.submit(task, d) for d in range(self.dp)]
        return [f.result() for f in futures]

    def close(self) -> None:
        """Shut the process groups down and stop the shard threads."""
        for s, groups in enumerate(self._groups):
            self._each(s, lambda d, g=groups: g[d].pg.shutdown(), sync=False)
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    # Stage computations
    # ------------------------------------------------------------------
    def _stage_forward(self, s: int, sp, x, labels=None):
        """Stage ``s`` on its input: tokens (rows, S) on stage 0, else the
        previous stage's ``(h, aux)``.  Returns ``(h, aux)``, or on the
        last stage the loss (the single-stage ``loss_fn``'s op sequence,
        split at cycle boundaries)."""
        cfg, p = self.cfg, self.pipe
        cp = M.cast_params(sp, cfg)
        if s == 0:
            h = M.embed_tokens(cp, {"tokens": x}, cfg)
            h, _ = M.run_prelude(cp, h, M.positions_of(h), cfg, self.run)
            aux = 0.0
        else:
            h, aux = x
        n = self.stage_cut[s + 1] - self.stage_cut[s]
        h, _, aux = M.run_cycles(cp["slots"], h, M.positions_of(h), cfg,
                                 self.run, n, aux=aux)
        if s < p - 1:
            return h, aux
        head = {"final_norm": cp["final_norm"]}
        if cfg.tie_embeddings:
            head["embed"] = cp["embed_out" if p > 1 else "embed"]
        else:
            head["lm_head"] = cp["lm_head"]
        loss, _ = M.masked_loss(M.head_logits(head, h, cfg), labels, aux)
        return loss

    def _stage_grads(self, s: int, sp, x, labels=None, gy=None):
        """The bwd op's recompute: the stage forward with grad enabled and
        the gradients of its params (a tree) and, past stage 0, of its
        input ``h`` (the cotangent the previous stage's bwd takes).  ``gy``
        is the cotangent of this stage's output ``h`` (None on the last);
        its aux output takes the constant cotangent ``M.AUX_WEIGHT``."""
        items = [(path, a.detach().requires_grad_())
                 for path, a in tree_items(sp)]
        leaves = [a for _, a in items]
        h_in = None if s == 0 else x[0].detach().requires_grad_()
        with torch.enable_grad():
            out = self._stage_forward(s, tree_unflatten(items),
                                      x if h_in is None else (h_in, x[1]),
                                      labels)
            outs, cots = out, gy
            if s < self.pipe - 1:
                outs, cots = [out[0]], [gy]
                aux = out[1]
                if torch.is_tensor(aux) and aux.requires_grad:
                    outs.append(aux)
                    cots.append(torch.full_like(aux, M.AUX_WEIGHT))
            wrt = leaves if h_in is None else leaves + [h_in]
            grads = torch_grad(outs, wrt, cots)
        gp = tree_unflatten((path, g) for (path, _), g in zip(items, grads))
        return gp, (None if h_in is None else grads[-1])

    # ------------------------------------------------------------------
    def init(self, seed: int = 0):
        """The fp32 master params (``init_params`` on ``devices[0]``) and
        their optimizer state: one tree each, which every step updates in
        place."""
        params = M.init_params(self.cfg, seed, self.devices[0])
        return params, opt_lib.init_state(self.opt, params)

    def _stage_views(self, params):
        """The Fig.-1 'parameter refresh': each stage's slice on every
        device of that stage, ``[stage][shard]`` (views where the device is
        the masters' own, copies elsewhere)."""
        return [[tree_map(lambda a, dev=dev: a.to(dev),
                          _stage_params(params, self.cfg, self.stage_cut, s))
                 for dev in self.grid[s]] for s in range(self.pipe)]

    def _microbatches(self, batch) -> List[Dict[str, torch.Tensor]]:
        """``[j][key]`` -> (dp, rows, ...): microbatch j's rows, dp-major, so
        data shard d gets exactly the rows the single-stage trainer's rank
        d takes in its accumulation step j."""
        m, dp = self.n_microbatch, self.dp
        out = [{} for _ in range(m)]
        for k, v in batch.items():
            rows = v.shape[0] // (dp * m)
            split = v.reshape((dp, m, rows) + tuple(v.shape[1:]))
            for j in range(m):
                out[j][k] = split[:, j]
        return out

    def _reassemble(self, synced):
        """The full gradient tree on ``devices[0]`` from each stage's synced
        shard (shard 0's: every shard holds the same mean), leaf by leaf so
        the shards free as the tree fills."""
        dev = self.devices[0]
        shards = [dict(tree_items(g)) for g in synced]
        synced.clear()
        full: Dict[Tuple[str, ...], torch.Tensor] = {}
        for path in list(shards[0]):
            if path[0] == "slots":
                full[path] = torch.cat([t.pop(path).to(dev) for t in shards],
                                       dim=0)
        # the tied head cotangents were folded into stage 0's embed
        # gradient per microbatch, so "embed" is complete here
        full[("embed",)] = shards[0].pop(("embed",)).to(dev)
        for path in [q for q in shards[0] if q[0] == "prelude"]:
            full[path] = shards[0].pop(path).to(dev)
        for key in ("final_norm", "lm_head"):
            if (key,) in shards[-1]:
                full[(key,)] = shards[-1].pop((key,)).to(dev)
        return tree_unflatten(full.items())

    # ------------------------------------------------------------------
    def step_fn(self):
        """Loop-compatible step: one 1F1B round over ``m`` microbatches,
        per-stage sync, one optimizer update of the masters."""
        p, m = self.pipe, self.n_microbatch
        order = schedule_1f1b(p, m)
        tr = self.tracer

        def step(params, opt_state, batch):
            with tr.span("param_refresh"):
                views = self._stage_views(params)
            micro = self._microbatches(batch)
            fwd_t = [[0.0] * m for _ in range(p)]
            bwd_t = [[0.0] * m for _ in range(p)]
            # stage inputs and outputs, cotangents and the tied head's,
            # keyed (stage, micro, shard); per stage and shard the fp32
            # accumulators (flatten order, paths[stage]); per shard the
            # loss sum
            st = {"inputs": {}, "outputs": {}, "cot": {}, "emb": {},
                  "acc": [[None] * self.dp for _ in range(p)],
                  "paths": [None] * p, "loss": [None] * self.dp}
            with tr.span("compute"):
                for (s, kind, j) in order:
                    name = "pipe_fwd" if kind == "fwd" else "pipe_bwd"
                    with tr.span(name, stage=s, micro=j) as sp:
                        if kind == "fwd":
                            self._run_fwd(s, j, views, micro, st)
                        else:
                            self._run_bwd(s, j, views, micro, st)
                    (fwd_t if kind == "fwd" else bwd_t)[s][j] = sp.elapsed_s
            del views
            with tr.span("dist_update") as sp_s:
                synced = []
                for s in range(p):
                    with tr.span("pipe_sync", stage=s):
                        synced.append(self._sync(s, st))
                    st["acc"][s] = None  # the accumulators are spent
            with tr.span("param_update") as sp_u:
                grads = self._reassemble(synced)  # empties synced
                _, opt_state, gnorm = opt_lib.apply_updates(
                    self.opt, params, grads, opt_state)
                del grads
                loop_lib.sync_devices(self.devices[:1])
            self._fwd_obs.append(fwd_t)
            self._bwd_obs.append(bwd_t)
            self._publish(fwd_t, bwd_t, sp_s.elapsed_s, sp_u.elapsed_s)
            losses = [float(l) / m for l in st["loss"]]
            metrics = {"loss": float(np.mean(np.asarray(losses, np.float32))),
                       "grad_norm": gnorm, "t_comm": sp_s.elapsed_s,
                       "t_update": sp_u.elapsed_s}
            return params, opt_state, metrics

        return step

    def _run_fwd(self, s: int, j: int, views, micro, st) -> None:
        """fwd(s, j): the stage forward under no_grad on every shard; it
        keeps the stage's input for the bwd op and hands its output on (the
        last stage adds its loss to the shard's sum)."""
        p = self.pipe

        def shard(d):
            dev = self.grid[s][d]
            x = (micro[j]["tokens"][d].to(dev) if s == 0
                 else _to(st["outputs"].pop((s - 1, j, d)), dev))
            st["inputs"][(s, j, d)] = x
            labels = micro[j]["labels"][d].to(dev) if s == p - 1 else None
            with torch.no_grad():
                out = self._stage_forward(s, views[s][d], x, labels)
            if s < p - 1:
                st["outputs"][(s, j, d)] = out
            else:
                st["loss"][d] = (out if st["loss"][d] is None
                                 else st["loss"][d] + out)

        self._each(s, shard)

    def _run_bwd(self, s: int, j: int, views, micro, st) -> None:
        """bwd(s, j): recompute and differentiate the stage on every shard,
        fold the tied head cotangent into stage 0's embed gradient, hand
        the input cotangent to stage s-1 and accumulate (fp32, microbatch
        order)."""
        p, tied = self.pipe, self.cfg.tie_embeddings

        def shard(d):
            dev = self.grid[s][d]
            x = st["inputs"].pop((s, j, d))
            labels = micro[j]["labels"][d].to(dev) if s == p - 1 else None
            gy = None if s == p - 1 else st["cot"].pop((s, j, d)).to(dev)
            gp, gh = self._stage_grads(s, views[s][d], x, labels, gy)
            if p > 1 and tied:
                if s == p - 1:
                    st["emb"][(j, d)] = gp.pop("embed_out")
                elif s == 0:  # the add autograd makes for a shared leaf
                    gp["embed"] = gp["embed"] + st["emb"].pop((j, d)).to(dev)
            if s > 0:
                st["cot"][(s - 1, j, d)] = gh
            items = list(tree_items(gp))
            acc = st["acc"][s]
            if acc[d] is None:  # build_grad_fn's fold: a copy, then add_
                acc[d] = [x.float().clone() for _, x in items]
                st["paths"][s] = [path for path, _ in items]
            else:
                for a, (_, x) in zip(acc[d], items):
                    a.add_(x)

        self._each(s, shard)

    def _sync(self, s: int, st):
        """Stage s's accumulated gradient divided by m, compressed and
        synced over the stage's group (every shard at once); shard 0's
        result.  With one shard a stage the mean is that shard's own
        (fp32) gradient, so no strategy runs: the flat copies of
        reduce-scatter/all-gather would double the stage's gradient
        memory to move nothing."""
        m, paths, acc = self.n_microbatch, st["paths"][s], st["acc"][s]

        def shard(d):
            g = tree_unflatten(zip(paths, [a.div_(m) for a in acc[d]]))
            g, _ = self.compressor.apply(g, None)
            if self.dp == 1:
                return g
            return self.strategy.sync(g, self._groups[s][d], self.dp)

        return self._each(s, shard)[0]

    def _publish(self, fwd_t, bwd_t, comm_s, upd_s):
        m = self.metrics
        busy = sum(sum(row) for row in fwd_t) + sum(sum(r) for r in bwd_t)
        m.inc("train/steps")
        m.observe("train/compute_s", busy)
        m.observe("train/dist_update_s", comm_s)
        m.observe("train/param_update_s", upd_s)
        m.observe("train/step_s", busy + comm_s + upd_s)

    # ------------------------------------------------------------------
    def train(self, *, batch: int, seq: int, steps: int, seed: int = 0,
              log_every: int = 10, params=None, opt_state=None,
              ckpt_dir: Optional[str] = None,
              ckpt_every: int = 0) -> loop_lib.TrainResult:
        """Train ``steps`` steps of a global batch of ``batch`` rows through
        ``train/loop.py`` (checkpoints hold the one master tree, in JAX's
        format, and a run resumes from ``ckpt_dir``).  ``params`` (moved to
        ``devices[0]``) and ``opt_state`` default to a fresh init; the final
        ones are kept in ``self.params`` / ``self.opt_state``."""
        rows = self.dp * self.n_microbatch
        if batch % rows:
            raise ValueError(
                f"batch {batch} not divisible by dp*n_microbatch={rows} "
                "(equal microbatch shards are required for exact means)")
        self._fwd_obs, self._bwd_obs = [], []
        if params is None:
            params, opt_state = self.init(seed)
        params = tree_map(lambda a: a.to(self.devices[0]), params)
        if opt_state is None:
            opt_state = opt_lib.init_state(self.opt, params)
        res = loop_lib.train(
            self.cfg, self.run, self.opt, batch=batch, seq=seq, steps=steps,
            seed=seed, device=self.devices[0], log_every=log_every,
            params=params, opt_state=opt_state, step_fn=self.step_fn(),
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, tracer=self.tracer)
        self.params, self.opt_state = params, opt_state
        self._times = res.step_times
        return res

    # ------------------------------------------------------------------
    def report(self) -> SyncReport:
        """Session-compatible sync view: each stage's shards sync a 1/p
        parameter shard over their own dp-wide group."""
        steady = self._times[2:] or self._times

        def mean(f):
            return float(np.mean([f(t) for t in steady])) if steady else 0.0

        comm = mean(lambda t: t.dist_update)
        compute = mean(lambda t: t.compute)
        upd = mean(lambda t: t.param_update)
        s_p = self._grad_bytes / self.pipe
        wire_payload = self.compressor.wire_bytes(s_p)
        predicted = self.strategy.predicted_comm_time(
            wire_payload, self.dp, self.link_bw)
        return SyncReport(
            strategy=self.strategy.name, compression=self.compressor.name,
            dp=self.dp, n_servers=self.strategy.n_servers,
            grad_bytes=s_p,
            wire_bytes=self.strategy.wire_bytes(wire_payload, self.dp),
            link_bw=self.link_bw,
            measured_comm_s=comm, predicted_comm_s=predicted,
            measured_compute_s=compute, measured_update_s=upd,
            masked_measured=comm <= compute,
            masked_predicted=predicted <= compute,
            r_o_measured=mean(lambda t: t.r_o()),
            tiers=self.strategy.tiers,
            wire_bytes_by_tier=(
                self.strategy.wire_bytes_by_tier(wire_payload, self.dp)
                if self.strategy.hierarchical else None),
            exposed_comm_time=comm)

    def pipeline_report(self) -> PipelineReport:
        """Replay the steady-state measured op durations through the 1F1B
        DAG and set the resulting bubble against the analytic model and
        the serial reference schedule."""
        p, m = self.pipe, self.n_microbatch
        steady_f = self._fwd_obs[2:] or self._fwd_obs
        steady_b = self._bwd_obs[2:] or self._bwd_obs
        if not steady_f:
            raise RuntimeError("pipeline_report needs at least one "
                               "measured step; run train() first")
        # best-of over steady steps, per op: host noise only inflates
        fwd = tuple(tuple(min(step[s][j] for step in steady_f)
                          for j in range(m)) for s in range(p))
        bwd = tuple(tuple(min(step[s][j] for step in steady_b)
                          for j in range(m)) for s in range(p))
        sim = simulate_1f1b(fwd, bwd)
        serial = simulate_serial(fwd, bwd)
        model = pipeline_bubble(p, m)
        self.metrics.set_gauge("train/pipe", p)
        self.metrics.set_gauge("train/n_microbatch", m)
        self.metrics.set_gauge("train/bubble_measured", sim.bubble_fraction)
        self.metrics.set_gauge("train/bubble_model", model)
        return PipelineReport(
            pipe=p, n_microbatch=m, stage_cut=self.stage_cut,
            bubble_measured=sim.bubble_fraction, bubble_model=model,
            bubble_serial=serial.bubble_fraction,
            makespan_s=sim.makespan, stage_busy_s=sim.stage_busy,
            fwd_times_s=fwd, bwd_times_s=bwd)
