"""The port's kernel-choice stage (``repro_torch.core.autotune``) and its
memory model (``repro_torch.core.memory_model``, Part 1) against the JAX
package's, and the tuning registry (``repro_torch.kernels.ops``) against
``repro.kernels.ops``: the same ops, shapes and variant names
(``pallas*`` is ``kernel*`` in the port).

``bench_kernels`` runs here on the CPU, where every kernel variant runs its
plain version; on the card ``chip_smoke.py`` runs it on the CUDA kernels.
"""
import numpy as np
import pytest
import torch

from repro.core import autotune as jtune
from repro.core import memory_model as jmm
from repro.kernels import ops as jops
from repro_torch.core import autotune as ttune
from repro_torch.core import memory_model as tmm
from repro_torch.kernels import ops as tops

HBM = (16e9, 80e9, 2.5e9, 0.4e9)


@pytest.mark.parametrize("x_mini", [1, 64, 128, 512, 4096])
def test_memory_model_matches_jax(x_mini):
    assert tmm.feature_shapes(tmm.ALEXNET) == jmm.feature_shapes(jmm.ALEXNET)
    assert tmm.m_fm(tmm.ALEXNET, x_mini) == jmm.m_fm(jmm.ALEXNET, x_mini)
    assert tmm.m_mp(tmm.ALEXNET) == jmm.m_mp(jmm.ALEXNET)
    assert tmm.m_c(tmm.ALEXNET) == jmm.m_c(jmm.ALEXNET)
    for hbm in HBM:
        assert tmm.m_bound(tmm.ALEXNET, x_mini, hbm) == \
            jmm.m_bound(jmm.ALEXNET, x_mini, hbm)
        assert ttune.choose_conv_algs(x_mini, hbm) == \
            jtune.choose_conv_algs(x_mini, hbm)


@pytest.mark.parametrize("hbm", HBM + (1e6,))
def test_max_x_mini_matches_jax(hbm):
    got = tmm.max_x_mini(tmm.ALEXNET, hbm)
    assert got == jmm.max_x_mini(jmm.ALEXNET, hbm)
    if got:
        assert tmm.m_bound(tmm.ALEXNET, got, hbm) >= 0
        assert tmm.m_bound(tmm.ALEXNET, got + 1, hbm) < 0


def test_table2_rows_and_conv_memory_match_jax():
    assert tmm.TABLE2_ROWS == jmm.TABLE2_ROWS
    for row, _ in tmm.TABLE2_ROWS:
        assert tmm.conv_alg_memory(*row) == jmm.conv_alg_memory(*row)


@pytest.mark.parametrize("op", tops.TUNABLE_OPS)
def test_tuning_registry_matches_jax(op):
    """Same ops, input shapes and variant names as the JAX registry; the
    port's inputs are bf16 (its kernels' type), positions and tables
    int32, and the paged table is a permutation of the pool's blocks."""
    assert tops.TUNABLE_OPS == jops.TUNABLE_OPS
    want = jops.tune_inputs(op, seq=64)
    got = tops.tune_inputs(op, seq=64, device="cpu")
    assert [tuple(t.shape) for t in got] == [tuple(a.shape) for a in want]
    for t in got:
        assert t.dtype in (torch.bfloat16, torch.float32, torch.int32)
    names = {n.replace("pallas", "kernel")
             for n in jops.tune_candidates(op, ssd_chunks=(16, 32))}
    assert set(tops.tune_candidates(op, ssd_chunks=(16, 32))) == names
    if op == "paged_decode_attention":
        table = got[3]
        assert len(set(table.flatten().tolist())) == table.numel()
    again = tops.tune_inputs(op, seq=64, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_tune_candidates_agree_on_cpu():
    """Every variant of an op computes the same function: on CPU tensors
    the kernel variants run the plain versions."""
    for op in tops.TUNABLE_OPS:
        inputs = tops.tune_inputs(op, seq=64, device="cpu",
                                  dtype=torch.float32)
        outs = {n: fn(*inputs) for n, fn in tops.tune_candidates(op).items()}
        base = next(iter(outs.values()))
        for name, out in outs.items():
            for got, want in zip(out if isinstance(out, tuple) else (out,),
                                 base if isinstance(base, tuple) else (base,)):
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                           msg=f"{op}/{name}")


def test_bench_kernels_on_cpu():
    res = ttune.bench_kernels(device="cpu", seq=32, repeats=1)
    assert tuple(res) == tops.TUNABLE_OPS
    for op, entry in res.items():
        assert set(entry) == {"chosen", "times_s", "errors", "seq"}
        assert entry["errors"] == {}, entry["errors"]
        assert entry["seq"] == 32
        assert entry["chosen"] in entry["times_s"]
        assert all(t > 0 for t in entry["times_s"].values())
    assert set(res["ssd_scan"]["times_s"]) == {
        "kernel_chunk32", "kernel_chunk64", "kernel_chunk128", "ref"}


def test_bench_kernels_records_infeasible_variants():
    """A variant that raises is recorded under ``errors`` and never chosen:
    here a scan chunk that does not divide the sequence."""
    res = ttune.bench_kernels(device="cpu", seq=32, repeats=1,
                              ssd_chunks=(24,))
    ssd = res["ssd_scan"]
    assert "kernel_chunk24" in ssd["errors"] and ssd["chosen"] == "ref"


def test_bench_kernels_lets_faults_propagate(monkeypatch):
    """Only infeasible inputs are pruned: a variant that fails otherwise
    (a kernel that does not build or launch raises RuntimeError) stops
    the stage instead of being recorded and passed over for ``ref``."""
    def broken(*args):
        raise RuntimeError("flash_attention: CUDA kernel launch failed")

    real = tops.tune_candidates
    monkeypatch.setattr(
        tops, "tune_candidates",
        lambda op, **kw: {**real(op, **kw), "kernel": broken})
    with pytest.raises(RuntimeError, match="launch failed"):
        ttune.bench_kernels(device="cpu", seq=32, repeats=1)


def _spy_timeit(monkeypatch):
    """Record every (fn, args, seconds) host_microbench times."""
    calls = []
    real = ttune._timeit

    def spy(fn, *args, **kw):
        t = real(fn, *args, **kw)
        calls.append((fn, args, t))
        return t

    monkeypatch.setattr(ttune, "_timeit", spy)
    return calls


def test_timed_triad_is_one_aten_op(monkeypatch):
    """Each pass of the triad host_microbench times is one fused pass (two
    reads, one write), as JAX's jitted ``u + 2.0 * v``: one aten op, not
    the two (mul, then add) that eager ``u + 2.0 * v`` dispatches; the
    timed call runs ``passes`` of them and nothing else."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    calls = _spy_timeit(monkeypatch)
    ttune.host_microbench(n=16, copy_mb=1, repeats=1, passes=3,
                          device="cpu")
    assert len(calls) == 2  # the matmul, then the triad
    fn, (u, v, w, passes), _ = calls[1]
    assert passes == 3
    with Count() as count:
        out = fn(u, v, w, passes)
    assert count.ops == ["aten.add.out"] * 3
    assert out is w and torch.equal(out, u + 2.0 * v)


def test_triad_counts_twelve_bytes_an_element(monkeypatch):
    """JAX's byte count: 3 x 4 bytes an element a pass, times the passes,
    over the time _timeit reports (and 2 n^3 FLOPs over the matmul's)."""
    calls = _spy_timeit(monkeypatch)
    got = ttune.host_microbench(n=16, copy_mb=1, repeats=1, device="cpu")
    m, passes = 2 ** 20 // 4, calls[1][1][3]
    assert calls[1][1][0].numel() == m and passes == 16
    assert got["triad_bw"] == 12.0 * m * passes / calls[1][2]
    assert got["matmul_flops"] == 2.0 * 16 ** 3 / calls[0][2]


def test_host_microbench_and_cuda_default():
    got = ttune.host_microbench(n=64, copy_mb=1, repeats=1, device="cpu")
    assert got["matmul_flops"] > 0 and got["triad_bw"] > 0
    assert (got["matmul_n"], got["copy_mb"]) == (64.0, 1.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ttune.bench_kernels(seq=32, repeats=1)
