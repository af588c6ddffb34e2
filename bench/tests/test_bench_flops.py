"""The yardstick's counts against hand counts at both configurations'
widths, and the weights' layout against the program's parameter tree."""
from __future__ import annotations

import pytest

from bench import flops, harness, weights


def test_granite_counts_by_hand():
    c = harness.config("granite-3-2b-fp32")
    layer = (2048 * 32 * 64 * 2 + 2048 * 8 * 64 * 2  # wq, wo; wk, wv
             + 3 * 2048 * 8192)  # gate, up, down
    n = 40 * layer + 49155 * 2048  # the tied head, at the true vocab
    assert flops.matrix_params(c) == n == 2_533_365_760
    attn = 40 * 4 * 8192 * (4096 / 2) * 32 * 64
    assert flops.train_flops(c, 2, 4096) == 6 * n * 8192 + 3 * attn
    assert flops.train_flops(c, 2, 4096) == pytest.approx(1.410127e14,
                                                          rel=1e-5)
    every = 49408 * 2048 + 2048 + 40 * (layer + 2 * 2048)
    assert weights.count(c) == every
    assert flops.adamw_bytes(c) == 32 * every


def test_mamba2_counts_by_hand():
    c = harness.config("mamba2-780m-fp32")
    layer = 1536 * 3072 + 1536 * (3072 + 256) + 1536 * 48 + 3072 * 1536
    n = 48 * layer + 50280 * 1536
    assert flops.matrix_params(c) == n == 779_120_640
    T = 16 * 2048
    ssd = 48 * (2 * T * 256 * 128 + 2 * T * 256 * 48 * 64
                + 4 * T * 128 * 48 * 64)
    assert flops.train_flops(c, 16, 2048) == 6 * n * T + 3 * ssd
    small = 1536 + 3328 * 4 + 3328 + 48 * 3 + 3072  # norm, conv, heads, gate
    every = 50432 * 1536 + 1536 + 48 * (layer + small)
    assert weights.count(c) == every


def test_peaks_are_the_data_sheets():
    assert flops.peak("NVIDIA H100 80GB HBM3", "bfloat16_flops") == 989e12
    assert flops.flops_peak("NVIDIA H100 80GB HBM3", harness.config(
        "granite-3-2b-fp32")) == 67e12
    assert flops.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert flops.peak("some other card", "bfloat16_flops") is None


@pytest.mark.parametrize("conf", ["granite-3-2b-fp32", "mamba2-780m-fp32"])
def test_layout_is_the_programs(conf):
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_items

    from bench.drivers import shared

    c = harness.config(conf)
    cfg = shared.program_config(c)
    weights.check_layout(c, {"/".join(p): s.shape
                             for p, s in tree_items(M.model_specs(cfg))})


def test_a_layout_that_differs_is_refused():
    c = harness.config("granite-3-2b-fp32")
    shapes = {p: s for p, s, _, _ in weights.layout(c)}
    shapes["embed"] = (49155, 2048)
    with pytest.raises(ValueError):
        weights.check_layout(c, shapes)


def test_weights_are_a_function_of_the_seed():
    c = harness.config("mamba2-780m-fp32")
    leaf = next(x for x in weights.layout(c) if x[0].endswith("a_log"))
    a = weights.make_leaf(leaf, 2 ** 40 + 3, "cpu")
    b = weights.make_leaf(leaf, 2 ** 40 + 3, "cpu")
    d = weights.make_leaf(leaf, 2 ** 40 + 4, "cpu")
    assert (a == b).all() and not (a == d).all()
    assert float(a.exp().min()) >= 1.0 and float(a.exp().max()) <= 16.0
