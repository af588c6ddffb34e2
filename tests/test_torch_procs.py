"""One process per rank, without a process: the one-rank
``DataParallelTrainer`` (``rank=r, world=N, store=...``), the very object
and code path that each process of a ``torchrun`` job builds, run here
in N threads on one shared ``HashStore``, against the all-ranks threaded
trainer (bitwise), plus the rank's data shard, the cross-rank report and
the ``torchrun`` environment handling.

No test in this file starts a process.  Every group is built with a
60 s timeout and every thread is joined with a timeout, so a hang fails
its test.  The one real ``torchrun`` launch (two gloo processes) is the
``slow`` test at the end, outside tier 1.
"""
import json
import os
import socket
import subprocess
import sys
import threading
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.api import JobSpec, Session
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.distributed import trainer as ttrainer
from repro_torch.distributed.collectives import get_strategy
from repro_torch.distributed.trainer import DataParallelTrainer
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import tree_items
from repro_torch.optim.adamw import OptConfig

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = timedelta(seconds=60)
JOIN_S = 120
STEPS = 3


def _cfg():
    """tests/test_torch_distributed.py's small trainer config, in fp32."""
    return get_config("granite-3-2b").reduced().replace(
        vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, dtype="float32")


def _kw(strategy, **kw):
    return dict(strategy=strategy, group_timeout=TIMEOUT, **kw)


def _args():
    return (_cfg(), RunConfig(attn_impl="dense", remat="none"),
            OptConfig(lr=1e-3, warmup_steps=0, total_steps=8))


def _all_ranks(dp, strategy, steps=STEPS, **kw):
    tr = DataParallelTrainer(*_args(), devices=["cpu"] * dp,
                             **_kw(strategy, **kw))
    try:
        res = tr.train(batch=8, seq=16, steps=steps, log_every=0)
        return tr.params, res, tr.report()
    finally:
        tr.close()


def _in_threads(dp, fn):
    """fn(rank, store) on dp threads sharing one HashStore; each thread
    joined with a timeout, a rank's exception raised here."""
    store = dist.HashStore()
    out, errors = [None] * dp, []

    def rank(r):
        try:
            out[r] = fn(r, store)
        except BaseException as e:  # surfaced below, in the test's thread
            errors.append(e)
            raise

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(dp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return out


def _one_rank(dp, strategy, steps=STEPS, **kw):
    """Each rank's (params, TrainResult, SyncReport, trainer) from its own
    one-rank trainer."""

    def run(r, store):
        tr = DataParallelTrainer(*_args(), devices=["cpu"], rank=r, world=dp,
                                 store=store, **_kw(strategy, **kw))
        try:
            res = tr.train(batch=8, seq=16, steps=steps, log_every=0)
            return tr.params[0], res, tr.report(), tr
        finally:
            tr.close()

    return _in_threads(dp, run)


def _assert_equal(got, want, what):
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        assert torch.equal(g, w), f"{what}: {path}"


@pytest.mark.parametrize("strategy,dp", [
    ("all_reduce", 2), ("all_reduce", 4),
    ("reduce_scatter_all_gather", 2), ("reduce_scatter_all_gather", 4),
    ("parameter_server", 2), ("parameter_server", 4),
    ("hier_all_reduce", 2), ("hier_all_reduce", 4),
])
def test_one_rank_trainers_equal_the_threaded_trainer(strategy, dp):
    """The four strategies at dp 2 and 4: after 3 steps every rank's params
    are bitwise the all-ranks trainer's, and the losses (the mean over
    every rank, carried by the compute barrier) agree."""
    want, res_all, _ = _all_ranks(dp, strategy)
    out = _one_rank(dp, strategy)
    for r, (params, res, rep, _) in enumerate(out):
        _assert_equal(params, want[r], f"{strategy} dp {dp} rank {r}")
        np.testing.assert_allclose(res.losses, res_all.losses, rtol=1e-6)
        assert rep.dp == dp and rep.strategy == strategy


@pytest.mark.parametrize("make,check", [
    (lambda: get_strategy("hier_all_reduce", tiers=(2, 2)),
     lambda tr: isinstance(tr._axes[0], tuple) and tr.strategy.tiers == (2, 2)),
    (lambda: get_strategy("parameter_server", n_servers=3),
     lambda tr: tr.strategy.n_servers == 3),
], ids=["hier_all_reduce-tiers-2x2", "parameter_server-3-servers"])
def test_one_rank_trainers_nested_groups_and_servers(make, check):
    """hier_all_reduce over (2, 2) tiers (each process builds its in-node
    and across-node sub-groups) and a 3-server PS on a gradient length 3
    does not divide, at dp 4: bitwise the all-ranks trainer's params."""
    want, _, _ = _all_ranks(4, make())
    out = _one_rank(4, make())
    for r, (params, _, _, tr) in enumerate(out):
        assert check(tr)
        _assert_equal(params, want[r], f"rank {r}")


def test_overlapped_one_rank_trainers_equal_the_serial_trainer():
    """The overlapped schedule in one-rank mode (2 calibration, 2 fused
    steps) against the serial all-ranks trainer, bitwise."""
    want, _, _ = _all_ranks(2, "all_reduce", steps=4)
    out = _one_rank(2, "all_reduce", steps=4, sync_overlap=True,
                    bucket_mb=0.05)
    for r, (params, _, rep, _) in enumerate(out):
        _assert_equal(params, want[r], f"rank {r}")
        assert rep.sync_overlap and rep.n_buckets > 1


def test_loader_shard_is_the_threaded_loaders_shard():
    """shard=(r, world) yields exactly shard r of the all-ranks loader,
    batch after batch, so the global token stream is JAX's."""
    cfg = _cfg()
    full = PrefetchLoader(cfg, 8, 16, device=["cpu"] * 4, seed=3)
    parts = [PrefetchLoader(cfg, 8, 16, device=["cpu"], seed=3,
                            shard=(r, 4)) for r in range(4)]
    try:
        for _ in range(3):
            want, _ = next(full)
            for r, loader in enumerate(parts):
                got, _ = next(loader)
                for k in want:
                    assert len(got[k]) == 1
                    assert torch.equal(got[k][0], want[k][r])
    finally:
        for loader in [full] + parts:
            loader.close()
    with pytest.raises(ValueError, match="shard"):
        PrefetchLoader(cfg, 8, 16, device=["cpu", "cpu"], shard=(0, 2))
    with pytest.raises(ValueError, match="split"):
        PrefetchLoader(cfg, 6, 16, device=["cpu"], shard=(0, 4))


def test_report_gathers_the_slowest_rank():
    """report() all-gathers every rank's steady-state means once, at the
    end of train(), and every rank reports the slowest rank's (the largest
    mean step): the same SyncReport on every rank."""

    def run(r, store):
        tr = DataParallelTrainer(*_args(), devices=["cpu"], rank=r, world=3,
                                 store=store, **_kw("all_reduce"))
        try:
            tr.train(batch=6, seq=16, steps=STEPS, log_every=0)
            trained = (tr.summary, tr.report().as_dict())
            local = tr._local_summary()
            # a made-up summary per rank: rank 1 is the slowest
            local.update(step=[1.0, 5.0, 2.0][r], compute=10.0 + r)
            return trained, tr._gather_summary(local)
        finally:
            tr.close()

    out = _in_threads(3, run)
    summaries = [o[0][0] for o in out]
    reports = [o[0][1] for o in out]
    assert all(rep == reports[0] for rep in reports)
    assert all(s == summaries[0] for s in summaries)
    slow = summaries[0]["slowest_rank"]
    assert 0 <= slow < 3
    assert reports[0]["measured_compute_s"] == summaries[0]["compute"]
    for _, made_up in out:
        assert made_up["slowest_rank"] == 1 and made_up["compute"] == 11.0
        assert made_up["step"] == 5.0


def test_one_rank_group_times_out_without_its_peer():
    """A rank whose peer never comes fails after the group timeout instead
    of hanging."""
    with pytest.raises(dist.DistStoreError):
        DataParallelTrainer(*_args(), devices=["cpu"], rank=0, world=2,
                            store=dist.HashStore(),
                            group_timeout=timedelta(seconds=2))


def test_one_rank_mode_needs_rank_world_store_and_one_device():
    args = _args()
    with pytest.raises(ValueError, match="rank"):
        DataParallelTrainer(*args, devices=["cpu"], world=2,
                            store=dist.HashStore())
    with pytest.raises(ValueError, match="rank < world"):
        DataParallelTrainer(*args, devices=["cpu"], rank=2, world=2,
                            store=dist.HashStore())
    with pytest.raises(ValueError, match="one device"):
        DataParallelTrainer(*args, devices=["cpu", "cpu"], rank=0, world=2,
                            store=dist.HashStore())


# ---------------------------------------------------------------------------
# The torchrun entry, through a monkeypatched environment
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(monkeypatch, *, rank=0, world=1, port=None, **drop):
    env = {"TORCHELASTIC_RUN_ID": "test", "RANK": str(rank),
           "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port or 29400)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k in drop:
        monkeypatch.delenv(k)
    monkeypatch.delenv("TORCHELASTIC_USE_AGENT_STORE", raising=False)


def test_torchrun_env_outside_and_inside(monkeypatch):
    monkeypatch.delenv("TORCHELASTIC_RUN_ID", raising=False)
    assert ttrainer.torchrun_env() is None
    _torchrun(monkeypatch, rank=1, world=2, port=1234)
    assert ttrainer.torchrun_env() == ttrainer.TorchrunEnv(
        1, 2, 1, "127.0.0.1", 1234)


def test_torchrun_without_master_addr_raises(monkeypatch):
    _torchrun(monkeypatch, MASTER_ADDR=None)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        ttrainer.torchrun_env()
    spec = JobSpec(arch="granite-3-2b", steps=1, batch=2, seq=8, dp=1,
                   sync="all_reduce", log_every=0)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        Session(spec, device="cpu").train()


def test_torchrun_dp_must_equal_world_size(monkeypatch):
    _torchrun(monkeypatch, world=2)
    spec = JobSpec(arch="granite-3-2b", steps=1, batch=4, seq=8, dp=4,
                   sync="all_reduce", log_every=0)
    with pytest.raises(ValueError, match="WORLD_SIZE=2"):
        Session(spec, device="cpu").train()


def test_session_under_torchrun_runs_the_one_rank_trainer(monkeypatch,
                                                          capsys):
    """A world of one, as torchrun --nproc-per-node 1 would start it: the
    session builds the job's TCPStore (this process serves it, on
    localhost) and runs the one-rank trainer; the launcher reports on rank
    0.  The losses equal the all-ranks trainer's at dp 1."""
    from repro_torch.launch import train as launcher

    _torchrun(monkeypatch, port=_free_port())
    spec = JobSpec(arch="granite-3-2b", steps=2, batch=4, seq=16, dp=1,
                   sync="all_reduce", log_every=0)
    rep = Session(spec, device="cpu").train()
    assert rep.meta["process"] == {"rank": 0, "world": 1}
    assert rep.measured["sync"]["dp"] == 1
    monkeypatch.delenv("TORCHELASTIC_RUN_ID")
    want = Session(spec, device="cpu").train()
    np.testing.assert_array_equal(rep.measured["losses"],
                                  want.measured["losses"])
    _torchrun(monkeypatch, port=_free_port())
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "granite-3-2b", "--steps", "2", "--batch", "4",
        "--seq", "16", "--dp", "1", "--sync", "all_reduce", "--device",
        "cpu"])
    launcher.main()
    out = capsys.readouterr().out
    assert "ranks=1 (one process each)" in out
    assert json.loads(out.strip().splitlines()[-1])["kind"] == "train"


@pytest.mark.slow
def test_torchrun_two_gloo_processes(tmp_path):
    """The one real torchrun launch: two gloo processes on the CPU, the
    overlapped all_reduce trainer, a report written by rank 0 alone.  Slow
    (two interpreters import torch and run 6 steps; about 10 s here), so it is
    outside tier 1; run it with -m slow."""
    out = tmp_path / "report.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite-3-2b", "--dp", "2", "--sync", "all_reduce",
         "--overlap", "--bucket-mb", "1", "--steps", "6", "--batch", "8",
         "--seq", "64", "--device", "cpu", "--report-out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rep = json.loads(out.read_text())
    sync = rep["measured"]["sync"]
    assert rep["meta"]["process"] == {"rank": 0, "world": 2}
    assert sync["dp"] == 2 and sync["sync_overlap"] and sync["n_buckets"] > 1
    assert 0.0 <= sync["overlap_fraction"] <= 1.0
    assert proc.stdout.count("sync report:") == 1  # rank 0 alone prints
