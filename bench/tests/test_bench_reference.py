"""The reference against the program at CPU sizes (one run's three
compared steps: losses, the first gradient, the change after the steps),
the traffic the reference cuts against the program's loader, and each
fault a training cell can have driving a run to ``correct`` false."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_run

from bench import check, harness, traffic as traffic_lib
from bench.drivers import train, train_dp
from bench import run as run_mod

CELLS = ["granite-train-s4k-fp32", "mamba2-train-s2k-fp32"]


def line_of(r, out):
    return run_mod.result(r, out, int(r.cell["chips"]) or 1, "cpu")


@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_global_batch_is_what_the_loader_feeds(shard):
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PrefetchLoader

    t = dict(harness.traffic("train-b2-s4096"), shard_tokens=1000)
    cfg = get_config("granite-3-2b")
    corpus = traffic_lib.Corpus(t, cfg.vocab_size, 2 ** 35 + 1)
    loader = PrefetchLoader(cfg, 4, 300, device="cpu", corpus=corpus,
                            shard=shard)
    try:
        for i in range(4):  # batches straddle the shards
            got, _ = next(loader)
            tok, lab = traffic_lib.global_batch(corpus, 4, 300, i)
            rows = slice(None) if shard is None else slice(2, 4)
            assert np.array_equal(got["tokens"].numpy(), tok[rows])
            assert np.array_equal(got["labels"].numpy(), lab[rows])
    finally:
        loader.close()


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell):
    r = tiny_run(cell)
    out = train.run(r)
    line = line_of(r, out)
    prog, ref = out["readings"]["program"], out["readings"]["reference"]
    assert len(ref["losses"]) == len(prog["losses"]) == int(
        r.cell["compared_steps"])
    # both in fp32: they differ by the order of their sums alone (the
    # cells' limits are set at the cells' own sizes, on the card)
    assert max(check.readings(prog, ref).values()) < 1e-4
    assert set(line["metrics"]) == {"train_tokens_per_s",
                                    "train_peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half_batch", "leaf_altered"])
def test_a_fault_makes_the_run_incorrect(cell, fault):
    r = tiny_run(cell, faults=[fault], batch=4)
    line = line_of(r, train.run(r))
    assert not line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("faults", [(), ("no_exchange",)])
def test_data_parallel_ranks_and_the_exchange_left_out(faults):
    r = tiny_run("granite-train-s512-dp4-fp32", batch=4, seq=32, chips=2,
                 faults=faults)
    out = train_dp.run(r)
    line = line_of(r, out)
    values = [c["value"] for c in line["checks"].values()]
    if faults:
        assert not line["correct"], line["checks"]
    else:  # the global batch's gradient, to the order of the sums
        assert max(values) < 1e-4, line["checks"]
    assert out["record"]["counters"]["train/exposed_comm_s"]["count"] >= 1
    assert out["forbidden"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    """The control (the reference one precision below the configuration's)
    in the program's place reads several times what the program reads, at
    a CPU size."""
    from bench.drivers import shared
    from bench.reference.model import CONTROL

    r = tiny_run(cell)
    out = train.run(r)
    ref = out["readings"]["reference"]
    prog = check.readings(out["readings"]["program"], ref)
    ctl = check.readings(shared.reference(
        r, "cpu", batch=2, numerics=CONTROL[r.config["model"]["dtype"]]), ref)
    assert ctl["loss_gap"] > 3 * prog["loss_gap"]
    assert ctl["grad_gap"] > 3 * prog["grad_gap"]


@pytest.mark.gpu
def test_control_fails_the_cells_limits_on_the_card(cuda):
    """The control at the cells' own size on three seeds (on the card)."""
    import time

    from bench.drivers import shared
    from bench.reference.model import CONTROL

    for cell in CELLS:
        for seed in (2 ** 33 + 11, 2 ** 33 + 12, 2 ** 33 + 13):
            r = harness.Run.of(cell, seed, 0.0, False, time.time())
            b = int(r.traffic["batch"])
            ref = shared.reference(r, cuda, batch=b)
            ctl = shared.reference(r, cuda, batch=b,
                                   numerics=CONTROL[r.config["model"]["dtype"]])
            ok, _ = check.judge(check.readings(
                ctl, ref, int(r.cell["loss_steps"])), r.cell["limits"])
            assert not ok
            shared.free_device()
