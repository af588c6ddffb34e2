"""The port's data-parallel runtime against the JAX package's: the four
sync strategies, the four compressors, the trainer and its SyncReport.

Ranks run in-process, one thread each, over gloo groups built on a
``HashStore`` (as ``DataParallelTrainer`` builds them), so no subprocess
is needed.  Inputs come from ``np.random.default_rng``; fp32 tolerance
2e-4 (tests/test_kernels.py), relative to each tensor's scale.
"""
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as jax_get_config
from repro.core import pipeline as jpipe
from repro.core.hardware import get_cluster as jax_get_cluster
from repro.distributed import compression as jcomp
from repro.distributed import trainer as jtrainer
from repro.distributed.collectives import get_strategy as jax_get_strategy
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import common as jcommon
from repro.models import model as JM
from repro.models.blocks import RunConfig as JRun
from repro.optim import adamw as jopt
from repro.train import loop as jloop
from repro_torch.api import JobSpec, Session
from repro_torch.configs.base import get_config
from repro_torch.core.hardware import ClusterSpec, Tier, get_cluster
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed.trainer import (DataParallelTrainer, SyncReport,
                                             _new_group)
from repro_torch.models import common as tcommon
from repro_torch.models.blocks import RunConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw as topt

TOL = 2e-4
INT8_TOL = 5e-2
TIMEOUT = timedelta(seconds=60)  # a hung rank fails its test


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    bound = tol + tol * np.abs(want).max()
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def _leaves(tree):
    return {tcommon.path_str(p): v for p, v in tcommon.tree_items(tree)}


def _run_ranks(dp, fn, inner=None):
    """fn(rank, axis) on dp threads over in-process gloo groups: one world
    group, or (across nodes, in node) with ``inner`` ranks per node."""
    store = dist.HashStore()
    out, errors = [None] * dp, []

    def rank(r):
        try:
            cpu = torch.device("cpu")
            if inner is None:
                axis = _new_group(dist.PrefixStore("w", store), r, dp, cpu,
                                  TIMEOUT)
            else:
                node, local = divmod(r, inner)
                in_node = _new_group(dist.PrefixStore(f"n{node}", store),
                                     local, inner, cpu, TIMEOUT)
                across = _new_group(dist.PrefixStore(f"a{local}", store),
                                    node, dp // inner, cpu, TIMEOUT)
                axis = (across, in_node)
            out[r] = fn(r, axis)
        except BaseException as e:  # surfaced below, in the test's thread
            errors.append(e)
            raise

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(dp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return out


def _grad_trees(dp, seed=0):
    """Per-rank gradient trees with awkward (non-divisible) leaf sizes."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((5, 7)).astype(np.float32),
             "b": rng.standard_normal((3,)).astype(np.float32),
             "n": {"u": rng.standard_normal((2, 2, 3)).astype(np.float32)}}
            for _ in range(dp)]


@pytest.mark.parametrize("name,dp,kw,inner", [
    ("all_reduce", 2, {}, None), ("all_reduce", 4, {}, None),
    ("reduce_scatter_all_gather", 2, {}, None),
    ("reduce_scatter_all_gather", 4, {}, None),
    ("parameter_server", 2, {}, None), ("parameter_server", 4, {}, None),
    ("parameter_server", 4, {"n_servers": 3}, None),  # 56 over 3 servers
    ("hier_all_reduce", 2, {}, None), ("hier_all_reduce", 4, {}, None),
    ("hier_all_reduce", 4, {"tiers": (2, 2)}, 2),     # 2 nodes x 2 ranks
])
def test_strategy_returns_the_global_mean(name, dp, kw, inner):
    trees = _grad_trees(dp)
    want = {k: np.mean([_leaves(t)[k] for t in trees], axis=0)
            for k in _leaves(trees[0])}
    strat = tcoll.get_strategy(name, **kw)
    # all_reduce sums in place into the (fp32) leaves it is given
    out = _run_ranks(dp, lambda r, axis: strat.sync(
        tcommon.tree_map(torch.from_numpy, trees[r]), axis, dp), inner)
    for r in range(dp):
        got = _leaves(out[r])
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], 1e-6, f"{name} rank {r} {k}")
            assert torch.equal(got[k], _leaves(out[0])[k])  # replicated


@pytest.mark.parametrize("name", ["none", "bf16", "int8", "topk"])
def test_compressor_matches_jax(name):
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((30, 11)).astype(np.float32),
         "b": {"c": (rng.standard_normal((17,)) * 1e-3).astype(np.float32)}}
    e = {"a": (rng.standard_normal((30, 11)) * 0.1).astype(np.float32),
         "b": {"c": (rng.standard_normal((17,)) * 1e-4).astype(np.float32)}}
    jc, tc = jcomp.get_compressor(name), tcomp.get_compressor(name)
    assert (tc.wire_ratio, tc.stateful) == (jc.wire_ratio, jc.stateful)
    for ef in ((None, None) if not jc.stateful else (e, None)):
        jg, je = jc.apply(jax.tree_util.tree_map(jnp.asarray, g),
                          None if ef is None else
                          jax.tree_util.tree_map(jnp.asarray, ef))
        tg, te = tc.apply(tcommon.tree_map(torch.from_numpy, g),
                          None if ef is None else
                          tcommon.tree_map(torch.from_numpy, ef))
        for k, want in _leaves(jg).items():
            np.testing.assert_allclose(_leaves(tg)[k].numpy(),
                                       np.asarray(want), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} {k}")
        assert (je is None) == (te is None)
        if je is not None:
            for k, want in _leaves(je).items():
                np.testing.assert_allclose(_leaves(te)[k].numpy(),
                                           np.asarray(want), rtol=1e-5,
                                           atol=1e-7, err_msg=f"ef {k}")


# ---------------------------------------------------------------------------
# The trainer against JAX's single-device step on the full batch
# ---------------------------------------------------------------------------


def _small_cfgs():
    """tests/test_sync_strategies.py's trainer config, in fp32."""
    kw = dict(vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1,
              head_dim=32, d_ff=128, dtype="float32")
    return (jax_get_config("granite-3-2b").reduced().replace(**kw),
            get_config("granite-3-2b").reduced().replace(**kw))


@pytest.fixture(scope="module")
def baseline():
    """JAX's single-device train step, three steps on the full batches of
    the loader stream (seed 0): the oracle of
    tests/test_sync_strategies.py:303."""
    jcfg, tcfg = _small_cfgs()
    jp = jcommon.materialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))
    tp_np = jax.tree_util.tree_map(np.asarray, jp)
    jo = jopt.OptConfig(lr=1e-3, warmup_steps=0)
    step = jax.jit(jax_build_train_step(
        jcfg, JRun(attn_impl="dense", remat="none"), jo))
    loader = PrefetchLoader(tcfg, 8, 16, device="cpu", seed=0)
    state, losses = jopt.init_state(jo, jp), []
    for _ in range(3):
        b, _ = next(loader)
        jp, state, m = step(jp, state, {k: jnp.asarray(v.numpy())
                                        for k, v in b.items()})
        losses.append(float(m["loss"]))
    loader.close()
    return tcfg, tp_np, jp, losses


@pytest.mark.parametrize("name,dp,topology", [
    ("all_reduce", 2, None), ("reduce_scatter_all_gather", 2, None),
    ("parameter_server", 2, None), ("hier_all_reduce", 2, None),
    ("hier_all_reduce", 4, ClusterSpec("2x2", tiers=(Tier("node", 2, 1e9),
                                                      Tier("cluster", 2, 1e8)))),
])
def test_trainer_matches_the_single_device_step(baseline, name, dp, topology):
    tcfg, tp_np, jp, jlosses = baseline
    tr = DataParallelTrainer(tcfg, RunConfig(attn_impl="dense", remat="none"),
                             topt.OptConfig(lr=1e-3, warmup_steps=0),
                             strategy=name, devices=["cpu"] * dp,
                             topology=topology, group_timeout=TIMEOUT)
    try:
        res = tr.train(batch=8, seq=16, steps=3, seed=0, log_every=0,
                       params=params_from_numpy(tp_np, tcfg, "cpu"))
    finally:
        tr.close()
    if topology is not None:
        assert tr.strategy.tiers == (2, 2)
        assert isinstance(tr._axes[0], tuple)  # two sub-groups
    _close(np.asarray(res.losses), np.asarray(jlosses), what="losses")
    want = _leaves(jp)
    for r in range(dp):
        got = _leaves(tr.params[r])
        assert set(got) == set(want)
        for k in want:
            _close(got[k], np.asarray(want[k]), what=f"{name} rank {r} {k}")
    assert len(res.step_times) == 3


def test_trainer_with_error_feedback_matches_jax_trainer(baseline,
                                                         multi_device):
    """int8 + error feedback at dp 2: the port's trainer against JAX's
    DataParallelTrainer on two host devices, three steps from the same
    params and batches.  Where a value sits on a rounding edge, a 1-ulp
    difference in the gradient moves its int8 level by one, so params and
    residuals are held at the JAX package's int8 tolerance (5e-2,
    tests/test_sync_strategies.py's compression test) and the losses at
    2e-4."""
    tcfg, tp_np, _, _ = baseline
    jcfg, _ = _small_cfgs()
    run_kw = dict(attn_impl="dense", remat="none")
    jo = jopt.OptConfig(lr=1e-3, warmup_steps=0)
    jt = jtrainer.DataParallelTrainer(jcfg, JRun(**run_kw), jo,
                                      strategy="all_reduce",
                                      compression="int8",
                                      devices=multi_device[:2])
    jp, js = jt.init(0)
    jp = jax.tree_util.tree_map(jnp.asarray, tp_np)
    js = dict(jopt.init_state(jo, jp), ef=js["ef"])
    tr = DataParallelTrainer(tcfg, RunConfig(**run_kw),
                             topt.OptConfig(lr=1e-3, warmup_steps=0),
                             strategy="all_reduce", compression="int8",
                             devices=["cpu", "cpu"], group_timeout=TIMEOUT)
    try:
        res = tr.train(batch=8, seq=16, steps=3, seed=0, log_every=0,
                       params=params_from_numpy(tp_np, tcfg, "cpu"))
    finally:
        tr.close()
    from jax.sharding import NamedSharding, PartitionSpec as P

    loader = PrefetchLoader(tcfg, 8, 16, device="cpu", seed=0)
    step, jlosses = jt.step_fn(), []
    for _ in range(3):
        b, _ = next(loader)
        b = {k: jax.device_put(v.numpy(), NamedSharding(jt.mesh, P("data")))
             for k, v in b.items()}
        jp, js, m = step(jp, js, b)
        jlosses.append(float(m["loss"]))
    loader.close()
    _close(np.asarray(res.losses), np.asarray(jlosses), what="losses")
    for k, want in _leaves(jp).items():
        _close(_leaves(tr.params[0])[k], np.asarray(want), INT8_TOL, k)
    for r in range(2):
        for k, want in _leaves(js["ef"]).items():
            _close(_leaves(tr.opt_states[r]["ef"])[k], np.asarray(want)[r],
                   INT8_TOL, f"ef rank {r} {k}")


@pytest.mark.parametrize("name,dp,compression,topology", [
    ("all_reduce", 2, "none", ""), ("parameter_server", 4, "bf16", ""),
    ("reduce_scatter_all_gather", 2, "topk", ""),
    ("hier_all_reduce", 4, "int8", "2x4"),
    ("hier_all_reduce", 8, "none", "2x4"),
])
def test_sync_report_matches_jax(multi_device, name, dp, compression,
                                 topology):
    """SyncReport has JAX's fields, and its prediction is JAX's for the
    same payload, dp, tiers and link bandwidth."""
    tcfg = get_config("granite-3-2b").reduced().replace(
        vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128)
    jcfg = jax_get_config("granite-3-2b").reduced().replace(
        vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128)
    kw = dict(strategy=name, compression=compression, link_bw=2.5e9)
    jt = jtrainer.DataParallelTrainer(
        jcfg, JRun(), jopt.OptConfig(), devices=multi_device[:dp],
        topology=jax_get_cluster(topology) if topology else None, **kw)
    tr = DataParallelTrainer(
        tcfg, RunConfig(attn_impl="dense", remat="none"), topt.OptConfig(),
        devices=["cpu"] * dp, group_timeout=TIMEOUT,
        topology=get_cluster(topology) if topology else None, **kw)
    try:
        tr.train(batch=dp, seq=8, steps=3, log_every=0)
    finally:
        tr.close()
    rep = tr.report()
    assert tr.strategy.tiers == jt.strategy.tiers
    s_p = 4.0 * sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        JM.model_specs(jcfg), is_leaf=lambda x: hasattr(x, "shape")))
    assert rep.grad_bytes == s_p
    payload = jt.compressor.wire_bytes(s_p)
    assert rep.predicted_comm_s == jt.strategy.predicted_comm_time(
        payload, dp, 2.5e9, tier_bws=jt._tier_bws)
    assert rep.wire_bytes == jt.strategy.wire_bytes(payload, dp)
    if jt.strategy.hierarchical:
        assert rep.wire_bytes_by_tier == jt.strategy.wire_bytes_by_tier(
            payload, dp)
    d = rep.as_dict()
    want = set(jtrainer.SyncReport.__dataclass_fields__) | {
        "effective_link_bw"}
    assert set(d) == want
    assert rep.measured_comm_s > 0 and rep.r_o_measured > 0
    assert isinstance(rep, SyncReport)


def test_session_train_data_parallel_returns_jax_keys():
    spec = JobSpec(arch="granite-3-2b", steps=3, batch=4, seq=16, dp=2,
                   sync="reduce_scatter_all_gather", compress="bf16",
                   log_every=0)
    rep = Session(spec, device="cpu").train()
    keys = set(jloop.TrainResult([1.0], [jpipe.StepTimes()], 1.0).summary())
    assert set(rep.measured) == keys | {"metrics", "sync"}
    sync = rep.measured["sync"]
    assert set(sync) == set(jtrainer.SyncReport.__dataclass_fields__) | {
        "effective_link_bw"}
    assert sync["dp"] == 2 and sync["compression"] == "bf16"
    hists = rep.measured["metrics"]["histograms"]
    assert hists["train/dist_update_s"]["count"] == 3


def test_jax_tiers_resolution_is_mirrored(multi_device):
    """The hierarchical strategy's tier sizing (strategy, topology, or the
    adapted split) and the nested groups, against JAX's trainer."""
    tcfg = get_config("granite-3-2b").reduced()
    jcfg = jax_get_config("granite-3-2b").reduced()
    cases = [(4, "2x4", None), (8, "2x4", None), (4, "", (2, 2)),
             (4, "", None), (2, "4x4-ib", None)]
    for dp, topology, tiers in cases:
        jstrat = jax_get_strategy("hier_all_reduce", tiers=tiers)
        tstrat = tcoll.get_strategy("hier_all_reduce", tiers=tiers)
        jt = jtrainer.DataParallelTrainer(
            jcfg, JRun(), jopt.OptConfig(), strategy=jstrat,
            devices=multi_device[:dp],
            topology=jax_get_cluster(topology) if topology else None)
        tr = DataParallelTrainer(
            tcfg, RunConfig(), topt.OptConfig(), strategy=tstrat,
            devices=["cpu"] * dp, group_timeout=TIMEOUT,
            topology=get_cluster(topology) if topology else None)
        try:
            assert tr.strategy.tiers == jt.strategy.tiers, (dp, topology)
            assert tr._tier_bws == jt._tier_bws
            assert isinstance(tr._axes[0], tuple) == \
                (jt._axes == ("nodes", "data"))
        finally:
            tr.close()
