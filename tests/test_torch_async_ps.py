"""The port's bounded-staleness parameter server
(``repro_torch.distributed.async_ps``) against the JAX package's
(``repro.distributed.async_ps``): the T_step(s, k) cost model, the
trainer at s = 0 (bitwise the synchronous ``parameter_server`` trainer),
at s = 2 with one backup worker against JAX's trainer on the same params
and token stream, in one-rank mode (threads on a shared ``HashStore``;
no test here starts a process) against the threaded mode, its refusals,
and ``Session.train()`` / the launcher.

Sizes are tests/test_checkpoint.py's ``tiny_cfg()``; fp32 tolerance 2e-4
(tests/test_kernels.py), relative to each tensor's scale.
"""
import json
import threading
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.api.report import _validate_async
from repro.configs.base import get_config as jax_get_config
from repro.core import ps as jps
from repro.distributed import AsyncPSTrainer as JAsyncPSTrainer
from repro.distributed import async_ps as jasync
from repro.models.blocks import RunConfig as JRun
from repro.optim import adamw as jopt
from repro_torch.api import JobSpec, Session
from repro_torch.configs.base import get_config
from repro_torch.core import ps as tps
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.distributed import AsyncPSReport, AsyncPSTrainer
from repro_torch.distributed.trainer import DataParallelTrainer
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import path_str, tree_items
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import OptConfig

TOL = 2e-4
TIMEOUT = timedelta(seconds=60)
JOIN_S = 120
KW = dict(batch=8, seq=16, seed=0, log_every=0)


def tiny_cfgs():
    """tests/test_checkpoint.py's tiny_cfg(), in both packages."""
    kw = dict(vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1,
              head_dim=32, d_ff=128, dtype="float32")
    return (jax_get_config("granite-3-2b").reduced().replace(**kw),
            get_config("granite-3-2b").reduced().replace(**kw))


def _args():
    return (tiny_cfgs()[1], RunConfig(attn_impl="dense", remat="none"),
            OptConfig(lr=1e-3, warmup_steps=0))


def _run(cls, dp, steps, ckpt_dir=None, ckpt_every=0, **kw):
    """(trainer, TrainResult) of a threaded all-ranks run on dp CPU ranks."""
    tr = cls(*_args(), devices=["cpu"] * dp, group_timeout=TIMEOUT, **kw)
    try:
        return tr, tr.train(steps=steps, ckpt_dir=ckpt_dir,
                            ckpt_every=ckpt_every, **KW)
    finally:
        tr.close()


def _assert_equal(got, want, what):
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        assert torch.equal(g, w), f"{what}: {path_str(path)}"


# ---------------------------------------------------------------------------
# The T_step(s, k) model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_cost_model_equals_jax(dp):
    assert tps.DEFAULT_STALENESS_GAMMA == jps.DEFAULT_STALENESS_GAMMA
    for n in range(10):
        assert tps._harmonic(n) == jps._harmonic(n)
    for s in range(5):
        assert tps.staleness_efficiency(s) == jps.staleness_efficiency(s)
        assert (tps.staleness_efficiency(s, gamma=0.2)
                == jps.staleness_efficiency(s, gamma=0.2))
    for k in range(dp):
        for delay in (0.0, 0.01, 0.5):
            assert (tps.straggler_wait(dp, k, delay)
                    == jps.straggler_wait(dp, k, delay))
        for s in (0, 1, 3):
            for t_c in (0.0, 0.02, 1.0):
                args = (1.38e9, dp, max(dp // 2, 1), 450e9, t_c)
                kw = dict(staleness=s, backup_workers=k, mean_delay=0.01)
                assert (tps.async_step_time(*args, **kw)
                        == jps.async_step_time(*args, **kw))
    with pytest.raises(ValueError):
        tps.straggler_wait(dp, dp, 0.01)
    with pytest.raises(ValueError):
        tps.staleness_efficiency(-1)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp", [2, 4])
def test_staleness_zero_is_bitwise_the_synchronous_trainer(dp):
    """s = 0, k = 0: every worker pulls every step (a byte copy) and every
    gradient is weighted by exactly 1.0, so each loss and each param leaf
    of every rank equal the parameter_server trainer's."""
    sync, r_sync = _run(DataParallelTrainer, dp, 3,
                        strategy="parameter_server")
    anc, r_async = _run(AsyncPSTrainer, dp, 3, staleness=0,
                        backup_workers=0)
    assert r_async.losses == r_sync.losses
    for r in range(dp):
        _assert_equal(anc.params[r], sync.params[r], f"rank {r}")
    rep = anc.async_report()
    assert isinstance(rep, AsyncPSReport)
    assert rep.max_age == 0 and rep.mean_age == 0.0 and rep.drops == 0
    assert rep.refreshes == 3 * dp and rep.steps == 3


def _np_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= TOL + TOL * np.abs(want).max(), f"{what}: {err}"


def test_staleness_and_backup_workers_match_jax(multi_device):
    """s = 2, k = 1, dp = 4, 5 steps, from JAX's init and on the loader's
    token stream: losses and params at 2e-4; the refresh, age and drop
    counters exactly; the model's push, pull, straggler wait and
    efficiency at the same link bandwidth exactly."""
    jcfg, tcfg = tiny_cfgs()
    dp, steps = 4, 5
    jt = JAsyncPSTrainer(jcfg, JRun(attn_impl="dense", remat="none"),
                         jopt.OptConfig(lr=1e-3, warmup_steps=0),
                         staleness=2, backup_workers=1,
                         devices=multi_device[:dp])
    jp, js = jt.init(0)
    p_np = jax.tree_util.tree_map(np.asarray, jp)
    step, jlosses = jt.step_fn(), []
    loader = PrefetchLoader(tcfg, KW["batch"], KW["seq"], device="cpu",
                            seed=0)
    try:
        for _ in range(steps):
            b, _ = next(loader)
            b = {k: jax.device_put(v.numpy(), NamedSharding(jt.mesh,
                                                            P("data")))
                 for k, v in b.items()}
            jp, js, m = step(jp, js, b)
            jlosses.append(float(m["loss"]))
    finally:
        loader.close()
    jrep = jt.async_report()

    tr = AsyncPSTrainer(*_args(), staleness=2, backup_workers=1,
                        devices=["cpu"] * dp, group_timeout=TIMEOUT)
    try:
        res = tr.train(steps=steps, params=params_from_numpy(p_np, tcfg,
                                                             "cpu"), **KW)
    finally:
        tr.close()
    rep = tr.async_report()
    _np_close(res.losses, jlosses, "losses")
    want = {path_str(p): v for p, v in tree_items(
        jax.tree_util.tree_map(np.asarray, jp))}
    for r in range(dp):
        got = {path_str(p): v for p, v in tree_items(tr.params[r])}
        assert set(got) == set(want)
        for k in want:
            _np_close(got[k].numpy(), want[k], f"rank {r} {k}")
    for k in ("staleness", "backup_workers", "dp", "steps", "refreshes",
              "mean_age", "max_age", "drops", "drop_counts",
              "pull_amortization"):
        assert getattr(rep, k) == getattr(jrep, k), k
    assert rep.max_age == 2 and rep.drops == steps
    assert tr.link_bw == jt.link_bw
    for k in ("push", "pull", "straggler_wait", "efficiency"):
        assert rep.t_step_model[k] == jrep.t_step_model[k], k
    assert set(rep.as_dict()) == set(jasync.AsyncPSReport.__dataclass_fields__)


def test_one_rank_async_trainers_equal_the_threaded_one():
    """Two one-rank async trainers in threads on a shared HashStore (what
    each torchrun process builds): every rank draws the same delays, so
    they drop the same worker; params bitwise and reports equal to the
    threaded trainer's."""
    kw = dict(staleness=1, backup_workers=1)
    want, res_all = _run(AsyncPSTrainer, 2, 3, **kw)
    store = dist.HashStore()
    out, errors = [None] * 2, []

    def rank(r):
        try:
            tr = AsyncPSTrainer(*_args(), devices=["cpu"], rank=r, world=2,
                                store=store, group_timeout=TIMEOUT, **kw)
            try:
                res = tr.train(steps=3, **KW)
                out[r] = (res, tr.params[0], tr.async_report())
            finally:
                tr.close()
        except BaseException as e:  # surfaced in the test's thread
            errors.append(e)
            raise

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    wrep = want.async_report().as_dict()
    for r, (res, params, rep) in enumerate(out):
        _assert_equal(params, want.params[r], f"rank {r}")
        np.testing.assert_allclose(res.losses, res_all.losses, rtol=1e-6)
        got = rep.as_dict()
        for k in wrep:
            if k != "t_step_model":  # priced at each run's measured compute
                assert got[k] == wrep[k], k
        assert got["drops"] == 3 and got["max_age"] == 1


@pytest.mark.parametrize("kw,match", [
    (dict(strategy="hier_all_reduce"), "flat strategy"),
    (dict(compression="int8"), "error-feedback"),
    (dict(sync_overlap=True), "sync_overlap"),
    (dict(staleness=-1), "staleness must be >= 0"),
    (dict(backup_workers=2), "backup_workers < dp=2"),
    (dict(backup_workers=-1), "backup_workers < dp=2"),
])
def test_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        AsyncPSTrainer(*_args(), devices=["cpu"] * 2, group_timeout=TIMEOUT,
                       **kw)


def test_resume_rebuilds_workers_from_the_restored_server(tmp_path):
    """The worker copies are not in the checkpoint: a resumed run rebuilds
    them from the restored server params with every age at 0, so its first
    step (s = 2, k = 0) is bitwise the synchronous parameter_server
    trainer's first step from the same checkpoint."""
    ck = str(tmp_path / "ck")
    _, first = _run(AsyncPSTrainer, 2, 2, staleness=2, ckpt_dir=ck,
                    ckpt_every=2)
    anc, res = _run(AsyncPSTrainer, 2, 3, staleness=2, ckpt_dir=ck,
                    ckpt_every=2)
    sync, want = _run(DataParallelTrainer, 2, 3,
                      strategy="parameter_server", ckpt_dir=ck, ckpt_every=2)
    assert first.start_step == 0 and res.start_step == want.start_step == 2
    assert res.losses == want.losses and len(res.losses) == 1
    for r in range(2):
        _assert_equal(anc.params[r], sync.params[r], f"rank {r}")
    rep = anc.async_report()
    assert rep.steps == 1 and rep.max_age == 0 and rep.refreshes == 1


# ---------------------------------------------------------------------------
# Session and launcher
# ---------------------------------------------------------------------------


def test_session_auto_with_staleness_runs_the_parameter_server():
    """sync="auto" with staleness resolves to the parameter server (as in
    JAX) and the report carries an async_ps section that passes the JAX
    package's own validator."""
    spec = JobSpec(arch="granite-3-2b", steps=3, batch=4, seq=16, dp=2,
                   sync="auto", staleness=1, log_every=0)
    rep = Session(spec, device="cpu").train()
    m = rep.measured
    assert m["sync"]["strategy"] == "parameter_server"
    a = m["async_ps"]
    _validate_async(a)
    assert a["staleness"] == 1 and a["dp"] == 2 and a["steps"] == 3
    assert set(a) == set(jasync.AsyncPSReport.__dataclass_fields__)
    assert m["metrics"]["histograms"]["train/refreshes"]["count"] == 3


def test_train_launcher_async_ps_and_checkpoint(capsys, monkeypatch,
                                                tmp_path):
    from repro_torch.launch import train as launcher

    ck = tmp_path / "ck"
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "granite-3-2b", "--steps", "2", "--batch", "4",
        "--seq", "16", "--device", "cpu", "--dp", "2", "--staleness", "1",
        "--backup-workers", "1", "--ckpt-dir", str(ck), "--ckpt-every", "2"])
    launcher.main()
    out = capsys.readouterr().out
    assert "async PS: staleness=1" in out and "2 grads dropped" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["staleness"] == 1 and last["backup_workers"] == 1
    assert (ck / "step_00000002.npz").exists()
    args = launcher.build_parser().parse_args(
        ["--arch", "granite-3-2b", "--ckpt-dir", str(ck)])
    assert launcher.build_spec(args).ckpt_every == 50
