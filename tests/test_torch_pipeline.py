"""The port's 1F1B pipeline parallelism against the JAX package's, on the
CPU (no test starts a process).

(a) The schedule model (``core/pipeline.py``) equals JAX's exactly over
    JAX's own grids: the same lists and tuples, the same floats.
(b) ``PipelineTrainer`` against the port's own single-stage
    ``DataParallelTrainer`` (``run.microbatch`` = rows per microbatch and
    shard) on 8 threaded gloo ranks over JAX's grid (pipe 1 with
    ``all_reduce``, pipe 2 and 4 with each of the four strategies), a
    ``bf16`` compressor case and a block-remat case, after 2 steps:
    bitwise (``torch.equal``) where a stage's group has 2 or 8 ranks.  At pipe 2 a stage's group has 4 ranks, and gloo sums 4
    ranks' values in an order that depends on where an element falls in
    the tensor it is given (a stage's slice is not the full leaf: see
    ``test_gloo_sum_order_depends_on_the_slice``), so those cases are held
    at fp32 2e-4.  Every case starts from attention-smoothed weights
    (``tests/test_torch_train.py::_smooth``): at JAX's init the attention
    is one-hot and the backward pass amplifies 1-ulp differences.
(c) The pipe-2 trainer from JAX's params against JAX's single-device
    ``build_train_step`` on the same full batch: loss and params at fp32
    2e-4 after one step.  (JAX's own pipeline oracle,
    ``tests/test_pipeline.py``'s bit-identity cells, fails with the
    installed jax, so it is not the reference.)
(d) ``pipeline_report()`` on injected op times equals JAX's.
(e) Every refusal, with JAX's exception type.
Then ``Session.train()`` with ``pipe > 1`` (both validators, JAX's
deepened reduced config), a pipe-2 checkpoint resumed by a dp trainer,
the launcher, and the refusal under ``torchrun``.
"""
import dataclasses
import json
import threading
from datetime import timedelta
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.api import JobSpec as JJobSpec
from repro.api import Session as JSession
from repro.api import validate_report as jax_validate_report
from repro.configs.base import get_config as jget_config
from repro.core import pipeline as jpipe
from repro.distributed import pipeline as jpipeline
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import common as jcommon
from repro.models import model as JM
from repro.models.blocks import RunConfig as JRun
from repro.obs import MetricsRegistry as JMetrics
from repro.optim import adamw as jopt
from repro.train import loop as jloop
from repro_torch.api import JobSpec, Session, validate_report
from repro_torch.configs.base import get_config
from repro_torch.core import pipeline as tpipe
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.distributed import trainer as ttrainer
from repro_torch.distributed.pipeline import (PipelineReport,
                                              PipelineTrainer, _stage_params,
                                              pipeline_devices)
from repro_torch.distributed.trainer import DataParallelTrainer, _new_group
from repro_torch.models import model as TM
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import (param_count, path_str, tree_items,
                                       tree_map)
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import MetricsRegistry
from repro_torch.optim.adamw import OptConfig, init_state

TOL = 2e-4
TIMEOUT = timedelta(seconds=60)
STRATEGIES = ("all_reduce", "reduce_scatter_all_gather", "parameter_server",
              "hier_all_reduce")

@pytest.fixture(autouse=True, scope="module")
def _one_op_thread():
    """The ranks are threads: one intra-op thread each keeps up to 8 ranks
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the schedule model, exactly JAX's
# ---------------------------------------------------------------------------

PM_GRID = sorted({(p, m if m >= p else p + m)
                  for p in (1, 2, 3, 4, 8) for m in (1, 2, 3, 8)}
                 | {(1, 1), (2, 2), (3, 7), (4, 4), (4, 9), (4, 6), (2, 8),
                    (3, 5), (4, 12), (4, 16)})


def _sims_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "PipelineSim"
    assert got.makespan == want.makespan
    assert got.stage_busy == want.stage_busy
    assert got.op_start == want.op_start and got.op_finish == want.op_finish
    assert got.bubble_fraction == want.bubble_fraction


@pytest.mark.parametrize("p,m", PM_GRID)
def test_schedule_equals_jax(p, m):
    for s in range(p):
        assert tpipe.stage_sequence_1f1b(p, m, s) == \
            jpipe.stage_sequence_1f1b(p, m, s)
    assert tpipe.schedule_1f1b(p, m) == jpipe.schedule_1f1b(p, m)
    assert tpipe.pipeline_bubble(p, m) == jpipe.pipeline_bubble(p, m)
    f, b = [[2.0] * m for _ in range(p)], [[3.0] * m for _ in range(p)]
    _sims_equal(tpipe.simulate_1f1b(f, b), jpipe.simulate_1f1b(f, b))
    _sims_equal(tpipe.simulate_serial(f, b), jpipe.simulate_serial(f, b))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("p,m", [(2, 2), (2, 8), (3, 5), (4, 4), (4, 12)])
def test_simulators_equal_jax_on_inflated_times(p, m, seed):
    """tests/test_pipeline.py's inflated op times (and its naive-bound
    counterexample) through both packages' simulators."""
    rng = np.random.default_rng(seed)
    fwd = (1.0 * (1.0 + rng.random((p, m)))).tolist()
    bwd = (1.5 * (1.0 + rng.random((p, m)))).tolist()
    _sims_equal(tpipe.simulate_1f1b(fwd, bwd), jpipe.simulate_1f1b(fwd, bwd))
    _sims_equal(tpipe.simulate_serial(fwd, bwd),
                jpipe.simulate_serial(fwd, bwd))
    counter = ([[3.393, 3.393], [1.0, 1.0]], [[2.372, 2.372], [2.0, 2.0]])
    _sims_equal(tpipe.simulate_1f1b(*counter), jpipe.simulate_1f1b(*counter))


def test_simulators_refuse_what_jax_refuses():
    for f, b in (([], []), ([[1.0]], [[1.0], [1.0]]),
                 ([[1.0, 2.0], [1.0]], [[1.0, 2.0], [1.0, 2.0]]),
                 ([[-1.0]], [[1.0]])):
        with pytest.raises(ValueError):
            jpipe.simulate_1f1b(f, b)
        with pytest.raises(ValueError):
            tpipe.simulate_1f1b(f, b)


STEP_TIMES = [
    dict(data_load=0.05, data_prep=0.03, h2d=0.02, compute=0.5),
    dict(data_load=0.02, h2d=0.01, compute=0.3, param_update=0.02),
    dict(data_load=0.4, compute=0.1, param_update=0.1, dist_update=0.05,
         param_refresh=0.01),
    dict(data_load=0.01, compute=1.0, param_update=0.0025),
]


@pytest.mark.parametrize("k", range(len(STEP_TIMES)))
def test_epoch_model_equals_jax(k):
    """simulate_epoch and multi_device_speedup (the Fig. 4 model,
    tests/test_core.py:161-182) over G, bus sharing, pipelining and
    jitter."""
    tt, jt = (tpipe.StepTimes(**STEP_TIMES[k]),
              jpipe.StepTimes(**STEP_TIMES[k]))
    for pipelined in (True, False):
        for jitter, seed in ((0.0, 0), (0.3, 7)):
            assert tpipe.simulate_epoch(tt, 16, pipelined=pipelined,
                                        jitter=jitter, seed=seed) == \
                jpipe.simulate_epoch(jt, 16, pipelined=pipelined,
                                     jitter=jitter, seed=seed)
        for g in (1, 2, 4, 8):
            for bus in (True, False):
                assert tpipe.multi_device_speedup(
                    tt, g, bus_shared=bus, pipelined=pipelined) == \
                    jpipe.multi_device_speedup(
                        jt, g, bus_shared=bus, pipelined=pipelined)
    assert tt.r_o() == jt.r_o() and tt.as_dict() == jt.as_dict()


# ---------------------------------------------------------------------------
# (b) against the port's own single-stage trainer
# ---------------------------------------------------------------------------

BATCH, SEQ, STEPS, MICRO, WORLD = 32, 32, 2, 4, 8


def _tiny_cfg(cycles=8):
    """tests/test_pipeline.py's tiny config: fp32, at least 2 cycles a
    stage at pipe 4."""
    cfg = get_config("granite-3-2b").reduced().replace(
        vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1,
        head_dim=32, d_ff=128, dtype="float32")
    return cfg.replace(num_layers=cfg.first_k_dense
                       + cycles * len(cfg.pattern))


def _smooth(params, cfg):
    """The attention projections rescaled to std 1/sqrt(fan-in of the
    whole product) (tests/test_torch_train.py::_smooth)."""
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    mix = params["slots"]["slot0"]["mixer"]
    for name, f in (("wq", (H / D) ** 0.5), ("wk", (KV / D) ** 0.5),
                    ("wv", (KV / D) ** 0.5), ("wo", H ** -0.5)):
        mix[name] = mix[name] * f
    return params


def _batches(cfg):
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32))
        yield {"tokens": toks, "labels": toks.clone()}


def _opt():
    return OptConfig(lr=1e-3, warmup_steps=0, total_steps=8)


def _run_single_stage(cfg, p0, pipe, strategy, compression, remat):
    dp = WORLD // pipe
    tr = DataParallelTrainer(
        cfg, RunConfig(attn_impl="dense", remat=remat,
                       microbatch=BATCH // dp // MICRO), _opt(),
        strategy=strategy, compression=compression, devices=["cpu"] * dp,
        group_timeout=TIMEOUT)
    try:
        params, states = tr.replicate(tree_map(torch.clone, p0))
        step = tr.step_fn()
        for b in _batches(cfg):
            shards = {k: list(torch.chunk(v, dp)) for k, v in b.items()}
            params, states, _ = step(params, states, shards)
    finally:
        tr.close()
    return params[0]


def _run_pipeline(cfg, p0, pipe, strategy, compression, remat):
    tr = PipelineTrainer(cfg, RunConfig(attn_impl="dense", remat=remat),
                         _opt(), pipe=pipe, n_microbatch=MICRO,
                         strategy=strategy, compression=compression,
                         devices=["cpu"] * WORLD, group_timeout=TIMEOUT)
    try:
        params = tree_map(torch.clone, p0)
        state = init_state(_opt(), params)
        step = tr.step_fn()
        for b in _batches(cfg):
            params, state, _ = step(params, state, b)
    finally:
        tr.close()
    return params


# JAX's grid (tests/test_pipeline.py): at pipe 1 the trainer is one stage
# whose sync is the single-stage trainer's over the same 8 ranks, so one
# strategy there; the strategies are told apart at pipe 2 and 4
BIT_MATCH_GRID = [(1, "all_reduce", "none", "none")] + [
    (pipe, strat, "none", "none") for pipe in (2, 4)
    for strat in STRATEGIES] + [
    (4, "all_reduce", "bf16", "none"), (4, "all_reduce", "none", "block")]


@pytest.mark.parametrize("pipe,strategy,compression,remat", BIT_MATCH_GRID)
def test_pipeline_matches_single_stage_trainer(pipe, strategy, compression,
                                               remat):
    cfg = _tiny_cfg(cycles=2 * pipe)  # two cycles a stage
    p0 = _smooth(TM.init_params(cfg, 0, "cpu"), cfg)
    want = _run_single_stage(cfg, p0, pipe, strategy, compression, remat)
    got = _run_pipeline(cfg, p0, pipe, strategy, compression, remat)
    want, got = dict(tree_items(want)), dict(tree_items(got))
    assert list(got) == list(want)
    bitwise = WORLD // pipe != 4  # a 4-rank gloo sum: see the docstring
    for path, w in want.items():
        g = got[path]
        if bitwise:
            assert torch.equal(g, w), path_str(path)
        else:
            err = (g - w).abs().max().item()
            assert err <= TOL + TOL * w.abs().max().item(), (path, err)


def _moe_cfg():
    """deepseek-v2's reduced config (MLA + MoE with a shared expert, one
    dense prelude layer) deepened to two cycles a stage at pipe 2, fp32,
    as Session deepens it."""
    cfg = get_config("deepseek-v2-236b").reduced().replace(
        vocab_size=256, dtype="float32")
    return cfg.replace(num_layers=cfg.first_k_dense + 4 * len(cfg.pattern))


def test_moe_prelude_pipeline_carries_aux_bitwise():
    """pipe 2 on an MoE + prelude model (2 shards a stage, so bitwise):
    stage 0 runs the prelude, the carry is (h, aux), and the params after
    2 steps and every step's loss are the single-stage trainer's exactly.
    The aux is carried: it is non-zero in the loss, and the last stage's
    loss is ce + 0.01 x the sum over all four MoE layers."""
    cfg, pipe, dp = _moe_cfg(), 2, 2
    assert cfg.first_k_dense and TM.main_cycles(cfg) == 4
    p0 = TM.init_params(cfg, 0, "cpu")
    single = DataParallelTrainer(
        cfg, RunConfig(attn_impl="dense", remat="block",
                       microbatch=BATCH // dp // MICRO), _opt(),
        devices=["cpu"] * dp, group_timeout=TIMEOUT)
    tr = PipelineTrainer(cfg, RunConfig(attn_impl="dense", remat="block"),
                         _opt(), pipe=pipe, n_microbatch=MICRO,
                         devices=["cpu"] * (pipe * dp), group_timeout=TIMEOUT)
    try:
        assert set(_stage_params(p0, cfg, tr.stage_cut, 0)) == {
            "slots", "embed", "prelude"}
        params, states = single.replicate(tree_map(torch.clone, p0))
        got, state = tree_map(torch.clone, p0), None
        state = init_state(_opt(), got)
        s_step, p_step = single.step_fn(), tr.step_fn()
        for b in _batches(cfg):
            shards = {k: list(torch.chunk(v, dp)) for k, v in b.items()}
            params, states, ms = s_step(params, states, shards)
            got, state, mp = p_step(got, state, b)
            assert mp["loss"] == pytest.approx(float(ms["loss"]), abs=0,
                                               rel=1e-6)
        # the first microbatch of shard 0 through both stages by hand:
        # the carried aux is the whole stack's
        mb = {k: v[:BATCH // dp // MICRO] for k, v in
              next(_batches(cfg)).items()}
        loss, m = TM.loss_fn(p0, mb, cfg, RunConfig(attn_impl="dense"))
        with torch.no_grad():
            sp = [_stage_params(p0, cfg, tr.stage_cut, s) for s in (0, 1)]
            h, aux = tr._stage_forward(0, sp[0], mb["tokens"])
            assert torch.is_tensor(aux) and float(aux) > 0
            ploss = tr._stage_forward(1, sp[1], (h, aux), mb["labels"])
        assert float(m["aux"]) > 0 and torch.equal(ploss, loss)
    finally:
        single.close()
        tr.close()
    want, got = dict(tree_items(params[0])), dict(tree_items(got))
    assert list(got) == list(want)
    for path, w in want.items():
        assert torch.equal(got[path], w), path_str(path)


def test_gloo_sum_order_depends_on_the_slice():
    """Why pipe 2 (4 ranks a stage) is held at 2e-4: over 4 gloo ranks the
    sum of a slice is not bitwise the slice of the sum."""
    dp, store, out = 4, dist.HashStore(), [None] * 4
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
          for _ in range(dp)]

    def rank(r):
        g = _new_group(dist.PrefixStore("w", store), r, dp,
                       torch.device("cpu"), TIMEOUT)
        full = g.all_reduce(xs[r].clone())
        out[r] = (full[3000:], g.all_reduce(xs[r][3000:].clone()))
        g.pg.shutdown()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(dp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    sliced, whole = out[0]
    assert not torch.equal(sliced, whole)
    assert torch.allclose(sliced, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_shard_a_stage_syncs_in_place(strategy):
    """At dp 1 a stage's mean is its own accumulated gradient: _sync
    returns the accumulators divided by m in place, the same tensors, with
    no strategy's flat copies (at full width those would double a stage's
    gradient memory on the card)."""
    cfg = _tiny_cfg(cycles=4)
    tr = PipelineTrainer(cfg, RunConfig(attn_impl="dense"), _opt(), pipe=2,
                         n_microbatch=2, strategy=strategy,
                         devices=["cpu"] * 2, group_timeout=TIMEOUT)
    try:
        items = list(tree_items(_stage_params(
            TM.init_params(cfg, 0, "cpu"), cfg, tr.stage_cut, 1)))
        acc = [x.float().clone() for _, x in items]
        want = [a / 2 for a in acc]
        st = {"paths": [None, [p for p, _ in items]], "acc": [None, [acc]]}
        got = list(tree_items(tr._sync(1, st)))
    finally:
        tr.close()
    assert [p for p, _ in got] == [p for p, _ in items]
    for (_, g), a, w in zip(got, acc, want):
        assert g is a and torch.equal(g, w)


def test_stage_params_are_views_and_cover_the_model():
    cfg = _tiny_cfg()
    params = TM.init_params(cfg, 0, "cpu")
    cut = tpipe.balanced_stage_cut(TM.main_cycles(cfg), 4)
    stages = [_stage_params(params, cfg, cut, s) for s in range(4)]
    assert set(stages[0]) == {"slots", "embed"}
    assert set(stages[-1]) == {"slots", "final_norm", "embed_out"}
    assert stages[-1]["embed_out"] is params["embed"]
    for path, leaf in tree_items(params["slots"]):
        parts = [dict(tree_items(s["slots"]))[path] for s in stages]
        assert all(p._base is leaf for p in parts)  # views, not copies
        assert torch.equal(torch.cat(parts), leaf)
    assert set(_stage_params(params, cfg, (0, 8), 0)) == {
        "slots", "embed", "final_norm"}


# ---------------------------------------------------------------------------
# (c) against JAX's single-device step
# ---------------------------------------------------------------------------


def test_pipe2_step_matches_jax_single_device_step():
    kw = dict(vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1,
              head_dim=32, d_ff=128, dtype="float32", num_layers=4)
    jcfg = jget_config("granite-3-2b").reduced().replace(**kw)
    tcfg = get_config("granite-3-2b").reduced().replace(**kw)
    jp = jcommon.materialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(jnp.asarray,
                                _smooth(jax.tree_util.tree_map(np.asarray,
                                                               jp), jcfg))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    jo = jopt.OptConfig(lr=1e-3, warmup_steps=0)
    loader = PrefetchLoader(tcfg, 8, 16, device="cpu", seed=0)
    b, _ = next(loader)
    loader.close()
    step = jax.jit(jax_build_train_step(
        jcfg, JRun(attn_impl="dense", remat="none"), jo))
    jp, _, jm = step(jp, jopt.init_state(jo, jp),
                     {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    tr = PipelineTrainer(tcfg, RunConfig(attn_impl="dense", remat="none"),
                         OptConfig(lr=1e-3, warmup_steps=0), pipe=2,
                         n_microbatch=2, devices=["cpu"] * 2,
                         group_timeout=TIMEOUT)
    try:
        res = tr.train(batch=8, seq=16, steps=1, seed=0, log_every=0,
                       params=tp)
    finally:
        tr.close()
    assert abs(res.losses[0] - float(jm["loss"])) <= TOL + TOL * abs(
        float(jm["loss"]))
    want = {path_str(p): np.asarray(v) for p, v in tree_items(jp)}
    got = {path_str(p): v.numpy() for p, v in tree_items(tr.params)}
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= TOL + TOL * np.abs(w).max(), (k, err)


# ---------------------------------------------------------------------------
# (d) pipeline_report on injected op times
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipe,m,steps", [(2, 4, 3), (4, 4, 5), (1, 2, 1),
                                          (2, 3, 2)])
def test_pipeline_report_equals_jax_on_injected_times(pipe, m, steps):
    rng = np.random.default_rng(pipe * 10 + m)
    fwd = [rng.uniform(0.01, 0.05, (pipe, m)).tolist() for _ in range(steps)]
    bwd = [rng.uniform(0.02, 0.09, (pipe, m)).tolist() for _ in range(steps)]
    cfg = _tiny_cfg()
    tr = PipelineTrainer(cfg, RunConfig(attn_impl="dense", remat="none"),
                         _opt(), pipe=pipe, n_microbatch=m,
                         devices=["cpu"] * pipe, group_timeout=TIMEOUT)
    try:
        with pytest.raises(RuntimeError, match="train"):
            tr.pipeline_report()
        tr._fwd_obs, tr._bwd_obs = fwd, bwd
        got = tr.pipeline_report()
    finally:
        tr.close()
    stub = SimpleNamespace(pipe=pipe, n_microbatch=m, _fwd_obs=fwd,
                           _bwd_obs=bwd, metrics=JMetrics(),
                           stage_cut=tr.stage_cut)
    want = jpipeline.PipelineTrainer.pipeline_report(stub)
    assert isinstance(got, PipelineReport)
    assert got.as_dict() == want.as_dict()
    assert set(got.as_dict()) == set(jpipeline.PipelineReport.
                                     __dataclass_fields__)
    gauges = tr.metrics.section()["gauges"]
    assert gauges == stub.metrics.section()["gauges"]
    assert gauges["train/bubble_model"] == tpipe.pipeline_bubble(pipe, m)


# ---------------------------------------------------------------------------
# (e) refusals, with JAX's exception types
# ---------------------------------------------------------------------------

REFUSALS = {
    "multi_codebook": (NotImplementedError, dict(arch="musicgen-large")),
    "image_prefix": (NotImplementedError, dict(arch="llava-next-34b")),
    "run_microbatch": (ValueError, dict(microbatch=2)),
    "stateful_compressor": (NotImplementedError, dict(compression="int8")),
    "too_few_microbatches": (ValueError, dict(pipe=4, n_microbatch=3)),
    "devices_not_divisible": (ValueError, dict(pipe=3)),
    "batch_not_divisible": (ValueError, dict(batch=6)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case, multi_device):
    exc, kw = REFUSALS[case]
    arch = kw.get("arch", "granite-3-2b")
    tiny = dict(vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1,
                head_dim=32, d_ff=128, num_layers=4)
    if arch != "granite-3-2b":
        tiny = {}
    cfgs = (jget_config(arch).reduced().replace(**tiny),
            get_config(arch).reduced().replace(**tiny))
    args = dict(pipe=kw.get("pipe", 2), n_microbatch=kw.get("n_microbatch",
                                                            0),
                compression=kw.get("compression", "none"))
    train_kw = dict(batch=kw.get("batch", 8), seq=8, steps=1, log_every=0)
    for pkg, cfg in zip(("jax", "torch"), cfgs):
        with pytest.raises(exc):
            if pkg == "jax":
                tr = jpipeline.PipelineTrainer(
                    cfg, JRun(microbatch=kw.get("microbatch", 0)),
                    jopt.OptConfig(), devices=multi_device[:4], **args)
            else:
                tr = PipelineTrainer(
                    cfg, RunConfig(microbatch=kw.get("microbatch", 0)),
                    OptConfig(), devices=["cpu"] * 4, **args)
            try:
                tr.train(**train_kw)
            finally:
                if pkg == "torch":
                    tr.close()


def test_cards_of_a_stage_must_differ_and_devices_wrap(monkeypatch):
    """On one card every stage shares cuda:0, but the shards of one stage
    need a card each (checked before any group or tensor is made)."""
    assert pipeline_devices("cpu", 3) == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pipeline_devices("cuda", 4) == [
        torch.device("cuda", i) for i in (0, 1, 0, 1)]
    with pytest.raises(ValueError, match="card each"):
        PipelineTrainer(_tiny_cfg(), RunConfig(), _opt(), pipe=1,
                        devices=[torch.device("cuda", 0)] * 2)


# ---------------------------------------------------------------------------
# Session, resume, launcher, torchrun
# ---------------------------------------------------------------------------


def test_session_pipe2_dp4_passes_both_validators():
    spec = JobSpec(arch="granite-3-2b", pipe=2, dp=4, reduced=True,
                   steps=3, batch=8, seq=16, log_every=0,
                   sync="reduce_scatter_all_gather")
    sess = Session(spec, device="cpu")
    rep = sess.train()
    d = json.loads(rep.to_json())
    assert validate_report(d) == d
    jax_validate_report(d)
    keys = set(jloop.TrainResult([1.0], [jpipe.StepTimes()], 1.0).summary())
    assert set(d["measured"]) == keys | {"metrics", "sync", "pipeline"}
    pr = d["measured"]["pipeline"]
    assert set(pr) == set(jpipeline.PipelineReport.__dataclass_fields__)
    assert (pr["pipe"], pr["n_microbatch"]) == (2, 2)
    assert pr["bubble_model"] == 1 / 3
    assert 0.0 <= pr["bubble_measured"] < 1.0
    assert d["measured"]["sync"]["dp"] == 2
    assert d["measured"]["sync"]["grad_bytes"] == 4.0 * param_count(
        TM.model_specs(sess.cfg)) / 2
    gauges = d["measured"]["metrics"]["gauges"]
    assert gauges["train/pipe"] == 2 and gauges["train/n_microbatch"] == 2
    assert np.isfinite(d["measured"]["losses"]).all()
    assert sess.last_tracer.events("pipe_fwd")


@pytest.mark.parametrize("pipe", [2, 4])
def test_deepened_reduced_config_equals_jax(pipe):
    spec = dict(arch="granite-3-2b", pipe=pipe, steps=1, batch=8, seq=16)
    got = Session(JobSpec(**spec), device="cpu").cfg
    want = JSession(JJobSpec(**spec)).cfg
    # the port's one field that JAX's lacks holds every expert here
    got_d = dataclasses.asdict(got)
    assert got_d.pop("experts_held") == 0
    assert got_d == dataclasses.asdict(want)
    assert TM.main_cycles(got) == 2 * pipe


def test_pipe2_checkpoint_resumes_onto_dp_trainer(tmp_path):
    """The port's form of tests/test_checkpoint.py::
    test_kill_and_resume_pipe2_to_dp: a pipe-2 run (2 shards a stage)
    checkpoints, a dp-2 trainer resumes it, and the stitched losses are
    the uninterrupted dp-2 run's."""
    cfg = _tiny_cfg(cycles=2)
    run, opt = RunConfig(attn_impl="dense", remat="none"), _opt()
    kw = dict(batch=4, seq=16, seed=0, log_every=0)
    ck = str(tmp_path / "ck")

    def dp2():  # one row a microbatch, as the pipeline's 2 x 2 shards
        return DataParallelTrainer(cfg, dataclasses.replace(run, microbatch=1),
                                   opt, strategy="all_reduce",
                                   devices=["cpu"] * 2,
                                   group_timeout=TIMEOUT)

    ref = dp2()
    try:
        losses_ref = ref.train(steps=4, **kw).losses
    finally:
        ref.close()
    pipe = PipelineTrainer(cfg, run, opt, pipe=2, n_microbatch=2,
                           strategy="all_reduce", devices=["cpu"] * 4,
                           group_timeout=TIMEOUT)
    try:
        rp = pipe.train(steps=2, ckpt_dir=ck, ckpt_every=2, **kw)
    finally:
        pipe.close()
    np.testing.assert_allclose(rp.losses, losses_ref[:2], atol=1e-6)
    resumed = dp2()
    try:
        r2 = resumed.train(steps=4, ckpt_dir=ck, ckpt_every=2, **kw)
    finally:
        resumed.close()
    assert r2.start_step == 2
    np.testing.assert_allclose(r2.losses, losses_ref[2:], atol=1e-6)


def test_launcher_pipe_runs_in_process(capsys):
    from repro_torch.launch import train as launcher

    launcher.main(["--arch", "granite-3-2b", "--steps", "2", "--batch", "4",
                   "--seq", "16", "--device", "cpu", "--pipe", "2",
                   "--microbatch", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    line = next(x for x in out if x.startswith("pipeline: "))
    assert line.startswith("pipeline: 2 stages x 2 microbatches, bubble "
                           "measured ")
    assert "vs model 0.333 (serial " in line
    assert json.loads(out[-1])["kind"] == "train"


def test_pipe_under_torchrun_names_its_roadmap_item(monkeypatch):
    env = ttrainer.TorchrunEnv(0, 2, 0, "localhost", 29500)
    monkeypatch.setattr(ttrainer, "torchrun_env", lambda: env)
    spec = JobSpec(arch="granite-3-2b", pipe=2, dp=2, steps=1, batch=4,
                   seq=8)
    with pytest.raises(NotImplementedError, match="ROADMAP Next 19"):
        Session(spec, device="cpu").train()


def test_from_plan_takes_the_plan_s_pipe_and_schedule():
    spec = JobSpec(arch="granite-3-2b", pipe=2, n_microbatch=4)
    plan = Session(spec, device="cpu").resolved_plan
    assert plan.pipe == 2
    tr = PipelineTrainer.from_plan(plan, _tiny_cfg(), RunConfig(), _opt(),
                                   devices=["cpu"] * 2,
                                   metrics=MetricsRegistry())
    try:
        assert (tr.pipe, tr.n_microbatch) == (2, plan.n_microbatch)
        assert tr.strategy.name == plan.sync_schedule
    finally:
        tr.close()
