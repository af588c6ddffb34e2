"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

# bf16 inputs and output, fp32 inside both: tests/test_kernels.py's bf16
# tolerance
TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda):
    torch.manual_seed(0)
    # query heads per kv head G = 4, 2, 8, 16 (16: the most the decode
    # kernel takes); D = 64 and 128
    for (B, S, H, KV, D, window, cap) in [(1, 200, 8, 2, 64, 0, 0.0),
                                          (2, 130, 4, 2, 128, 48, 30.0),
                                          (3, 300, 32, 4, 64, 0, 0.0),
                                          (2, 100, 16, 1, 128, 0, 0.0)]:
        q = torch.randn(B, S, H, D, device=cuda, dtype=torch.bfloat16)
        k = torch.randn(B, S, KV, D, device=cuda, dtype=torch.bfloat16)
        v = torch.randn(B, S, KV, D, device=cuda, dtype=torch.bfloat16)
        scale = 1.0 / np.sqrt(D)
        got = ops.flash_attention(q, k, v, scale=scale, window=window, cap=cap)
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), scale=scale,
                                       window=window, cap=cap).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL)
        pos = torch.randint(0, S, (B,), device=cuda, dtype=torch.int32)
        got = ops.decode_attention(q[:, :1], k, v, pos, scale=scale,
                                   window=window, cap=cap)
        want = ref.decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                        v.transpose(1, 2), pos, scale=scale,
                                        window=window, cap=cap)
        torch.testing.assert_close(got[:, 0].float(), want.float(),
                                   **TOL)


# (H, KV) for G = H / KV = 1, 4, 8, 16
_GROUPS = {1: (4, 4), 4: (8, 2), 8: (16, 2), 16: (16, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq", [1, 8, 47, 64, 65, 200, 2048])
def test_flash_kernel_edges(cuda, Sq, D):
    """The wgmma flash kernel at every q length the path can give it (the
    serving buckets, lengths that are not a multiple of the 64-row
    warpgroup or the 128-row block, one long prompt), every G, D 64 and
    128; plain, and with a window that crosses tile edges plus the cap."""
    from repro_torch.kernels import flash_attention as fa_k
    gen = torch.Generator(device=cuda).manual_seed(Sq + D)
    for G, (H, KV) in _GROUPS.items():
        for window, cap in [(0, 0.0), (70, 30.0)]:
            B = 2 if Sq <= 200 else 1
            q = torch.randn(B, Sq, H, D, device=cuda, generator=gen).to(torch.bfloat16)
            k = torch.randn(B, Sq, KV, D, device=cuda, generator=gen).to(torch.bfloat16)
            v = torch.randn(B, Sq, KV, D, device=cuda, generator=gen).to(torch.bfloat16)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            scale = 1.0 / np.sqrt(D)
            got = fa_k.flash_attention(qt, kt, vt, scale=scale, window=window,
                                       cap=cap)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(qt, kt, vt, scale=scale,
                                           window=window, cap=cap)
            torch.testing.assert_close(got.float(), want.float(), **TOL,
                                       msg=lambda m: f"G={G} window={window}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (500, 0.0), (500, 30.0)])
def test_decode_kernel_split_edges(cuda, D, window, cap):
    """Split-K decode with pos at the split and tile edges (0, 63, 64,
    T * 64 - 1, T * 64, S - 1) on a cache whose length is not a multiple of
    64, and a window whose start falls inside a split; every split count
    decode_splits gives here is > 1."""
    from repro_torch.kernels import decode_attention as dec_k
    B, S, H, KV = 6, 4000, 32, 8
    splits, per = dec_k.decode_splits(B, KV, S)
    assert splits > 1 and per > 1
    gen = torch.Generator(device=cuda).manual_seed(D + window)
    q = torch.randn(B, H, D, device=cuda, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, KV, D, device=cuda, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, device=cuda, generator=gen).to(torch.bfloat16)
    pos = torch.tensor([0, 63, 64, per * 64 - 1, per * 64, S - 1],
                       device=cuda, dtype=torch.int32)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    scale = 1.0 / np.sqrt(D)
    got = dec_k.decode_attention(q, kt, vt, pos, scale=scale, window=window,
                                 cap=cap)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, kt, vt, pos, scale=scale,
                                    window=window, cap=cap)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    split = ref.decode_attention_split_ref(q, kt, vt, pos, scale=scale,
                                           splits=splits, tiles=per,
                                           window=window, cap=cap)
    torch.testing.assert_close(got.float(), split.float(), **TOL)


def _paged_from_linear(k, v, bs, gen):
    """Scatter linear (B,KV,S,D) caches into a shuffled pool (N,bs,KV,D)
    in the serving pools' layout, with other values in the unused blocks;
    returns the pools in kernel layout (strided views) and the table."""
    B, KV, S, D = k.shape
    nb = S // bs
    n_pool = B * nb + 5
    table = torch.randperm(n_pool, generator=gen, device=k.device)[:B * nb]
    table = table.reshape(B, nb).to(torch.int32)
    k_pool = torch.randn(n_pool, bs, KV, D, device=k.device,
                         generator=gen).to(k.dtype)
    v_pool = k_pool.flip(0).contiguous()
    k_pool[table.long()] = k.transpose(1, 2).reshape(B, nb, bs, KV, D)
    v_pool[table.long()] = v.transpose(1, 2).reshape(B, nb, bs, KV, D)
    return k_pool.transpose(1, 2), v_pool.transpose(1, 2), table


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_paged_kernel_bitwise_equals_linear_kernel(cuda, bs):
    """The paged kernel builds each 64-key tile from the pool and runs the
    linear kernel's tile step, so it is bit-identical to the linear kernel
    on the gathered cache, for every block size; and within the bf16
    tolerance of the plain version."""
    from repro_torch.kernels import decode_attention as dec_k
    gen = torch.Generator(device=cuda).manual_seed(bs)
    # G = H / KV = 1, 4, 8; D = 64 and 128; windows and caps; a long cache
    # split into several kv ranges (split-K) with a combine
    for (B, S, H, KV, D, window, cap) in [(3, 256, 4, 4, 64, 0, 0.0),
                                          (4, 320, 32, 8, 64, 0, 0.0),
                                          (2, 192, 16, 2, 128, 70, 30.0),
                                          (4, 4096, 32, 8, 64, 0, 0.0)]:
        q = torch.randn(B, H, D, device=cuda, generator=gen).to(torch.bfloat16)
        k = torch.randn(B, KV, S, D, device=cuda, generator=gen).to(torch.bfloat16)
        v = torch.randn(B, KV, S, D, device=cuda, generator=gen).to(torch.bfloat16)
        kp, vp, table = _paged_from_linear(k, v, bs, gen)
        pos = torch.tensor([S - 1, 0, bs, bs - 1][:B], device=cuda,
                           dtype=torch.int32)
        # entries past each row's length are never read: poison them
        nb = S // bs
        poisoned = table.clone()
        for row, p in enumerate(pos.tolist()):
            poisoned[row, p // bs + 1:] = -1
        scale = 1.0 / np.sqrt(D)
        got = dec_k.paged_decode_attention(q, kp, vp, poisoned, pos,
                                           scale=scale, window=window, cap=cap)
        kl = ops.gather_kv_blocks(kp.transpose(1, 2), table).transpose(1, 2)
        vl = ops.gather_kv_blocks(vp.transpose(1, 2), table).transpose(1, 2)
        lin = dec_k.decode_attention(q, kl, vl, pos, scale=scale,
                                     window=window, cap=cap)
        torch.cuda.synchronize()
        assert kl.shape[2] == nb * bs
        assert torch.equal(got, lin), (B, S, H, KV, D, bs)
        want = ref.paged_decode_attention_ref(q, kp, vp, table, pos,
                                              scale=scale, window=window,
                                              cap=cap)
        torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.gpu
def test_ssd_kernel_matches_plain_version(cuda):
    """Every (P, N) instantiation at the chunks the path uses (the tuning
    chunks 32/64/128 at L = 128, the reduced config's chunk 32, mamba2-780m's
    width at chunk 256), and the edge shapes: Q = L < chunk (one chunk, no
    recurrence), Q = 12 and 20 (ragged 16-row tiles), H = 5 in head groups
    of 3 and 2, a chunk of 512 (run as 256).  Inputs are the views
    ssm_forward passes: x and dt transposed from model layout, x, b and c
    slices of one (B, L, H P + 2 N) tensor.  y within the bf16 tolerance
    and the fp32 state within 1e-3 of ref.ssd_scan_ref; each pass's fp32
    intermediates (the chunk states, the starting states) within 1e-3 of
    ref.ssd_scan_passes_ref; two calls bitwise equal (no atomics)."""
    from repro_torch.kernels import ssd_scan as ssd_k
    gen = torch.Generator(device=cuda).manual_seed(0)
    cases = [(1, 2, 128, 32, 16, c) for c in (32, 64, 128)]
    cases += [(2, 3, 128, P, N, 32) for P in (32, 64) for N in (16, 32, 64, 128)]
    cases += [(1, 4, 512, 64, 128, 256), (2, 5, 256, 32, 64, 16),
              (1, 2, 48, 32, 16, 256), (1, 3, 96, 64, 32, 12),
              (2, 2, 120, 32, 128, 20), (2, 5, 2048, 64, 64, 64),
              (1, 2, 1024, 32, 16, 512), (1, 48, 2048, 64, 128, 256)]
    assert ssd_k.launch_shape(2, 5, 2048, 64)[0] == 3  # a group of 2 too
    for (B, H, L, P, N, chunk) in cases:
        xbc = torch.randn(B, L, H * P + 2 * N, device=cuda,
                          generator=gen).to(torch.bfloat16)
        x = xbc[..., :H * P].reshape(B, L, H, P)
        b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = torch.nn.functional.softplus(
            torch.randn(B, L, H, device=cuda, generator=gen)).to(torch.bfloat16)
        a = -torch.exp(torch.randn(H, device=cuda, generator=gen) * 0.5)
        args = (x.transpose(1, 2), dt.transpose(1, 2), a, b, c)
        y, h = ssd_k.ssd_scan(*args, chunk=chunk)
        y2, h2 = ssd_k.ssd_scan(*args, chunk=chunk)
        got = ssd_k.ssd_scan_passes(*args, chunk=chunk)
        torch.cuda.synchronize()
        case = (B, H, L, P, N, chunk)
        assert torch.equal(y, y2) and torch.equal(h, h2), case
        wy, wh = ref.ssd_scan_ref(*args, chunk=chunk)
        # fp32 inside both, sums in another order; y rounded to bf16
        torch.testing.assert_close(y.float(), wy.float(), **TOL,
                                   msg=lambda m: f"{case}: {m}")
        torch.testing.assert_close(h, wh, rtol=1e-3, atol=1e-3,
                                   msg=lambda m: f"{case}: {m}")
        want = ref.ssd_scan_passes_ref(
            *args, chunk=ssd_k.kernel_chunk(min(chunk, L)))
        for key in ("chunk_states", "starts", "chunk_decay"):
            torch.testing.assert_close(got[key], want[key], rtol=1e-3,
                                       atol=1e-3,
                                       msg=lambda m: f"{case} {key}: {m}")
        assert torch.equal(got["y"], y) and torch.equal(got["h"], h), case


@pytest.mark.gpu
@pytest.mark.parametrize("L", [5, 9, 13])
def test_ssd_kernel_at_lengths_not_divisible_by_4(cuda, L):
    """ops.ssd_scan at a prompt length below the chunk that no kernel
    chunk (a multiple of 4) divides, as the static engine prefills it: one
    launch on the rows padded with dt = 0, y (the padded rows dropped) and
    the final state against ref.ssd_scan_ref on the unpadded inputs; at
    mamba2-780m's width and the reduced config's."""
    from repro_torch.kernels import ssd_scan as ssd_k
    gen = torch.Generator(device=cuda).manual_seed(L)
    for (B, H, P, N, chunk) in ((2, 48, 64, 128, 256), (2, 16, 32, 32, 32)):
        xbc = torch.randn(B, L, H * P + 2 * N, device=cuda,
                          generator=gen).to(torch.bfloat16)
        x = xbc[..., :H * P].reshape(B, L, H, P)
        b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = torch.nn.functional.softplus(
            torch.randn(B, L, H, device=cuda, generator=gen)).to(torch.bfloat16)
        a = -torch.exp(torch.randn(H, device=cuda, generator=gen) * 0.5)
        before = ssd_k.ssd_scan.launches
        y, h = ops.ssd_scan(x, dt, a, b, c, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_k.ssd_scan.launches == before + 1
        assert y.shape == (B, L, H, P)
        wy, wh = ref.ssd_scan_ref(x.transpose(1, 2), dt.transpose(1, 2), a, b,
                                  c, chunk=chunk)
        torch.testing.assert_close(y.float(), wy.transpose(1, 2).float(),
                                   **TOL)
        torch.testing.assert_close(h, wh, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# Training on the card: no kernel under autograd; the step against the CPU's
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_wrappers_refuse_autograd_on_card(cuda):
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ssd_scan as ssd_k

    def bf(*shape):
        return torch.randn(*shape, device=cuda).to(torch.bfloat16)

    pos = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda)
    cases = [
        (fa_k.flash_attention, (bf(2, 4, 9, 64), bf(2, 2, 9, 64),
                                bf(2, 2, 9, 64)), dict(scale=0.125)),
        (dec_k.decode_attention, (bf(2, 4, 64), bf(2, 2, 12, 64),
                                  bf(2, 2, 12, 64), pos), dict(scale=0.125)),
        (dec_k.paged_decode_attention, (bf(2, 4, 64), bf(4, 2, 16, 64),
                                        bf(4, 2, 16, 64), table, pos),
         dict(scale=0.125)),
        (ssd_k.ssd_scan, (bf(1, 2, 64, 32), bf(1, 2, 64).abs(),
                          -torch.rand(2, device=cuda), bf(1, 64, 16),
                          bf(1, 64, 16)), dict(chunk=32)),
    ]
    for fn, args, kw in cases:
        grad_args = [a.clone().requires_grad_() if a.is_floating_point()
                     else a for a in args]
        before = fn.launches
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*grad_args, **kw)
        assert fn.launches == before
        with torch.no_grad():
            fn(*grad_args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1


def _smooth_params(cfg, device):
    """Random fp32 params (seed 0) with the attention projections rescaled
    to std 1/sqrt(fan-in of the whole product): JAX's init makes the
    softmax nearly one-hot, which amplifies rounding differences through
    the stack (chip_smoke.py's reference check does the same)."""
    from repro_torch.models import model as M
    from repro_torch.models.common import materialize

    p = materialize(M.model_specs(cfg), 0, device)
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    mix = p["slots"]["slot0"]["mixer"]
    for name, f in (("wq", (H / D) ** 0.5), ("wk", (KV / D) ** 0.5),
                    ("wv", (KV / D) ** 0.5), ("wo", H ** -0.5)):
        mix[name].mul_(f)
    return p


def _assert_trees_close(got, want, tol):
    from repro_torch.models.common import path_str, tree_items

    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        err = (g.float().cpu() - w.float().cpu()).abs().max().item()
        bound = tol + tol * w.float().abs().max().item()
        assert err <= bound, f"{path_str(path)}: {err} > {bound}"


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """One train step (auto attention, block remat, AdamW) of a 2-layer
    fp32 granite on the card against the same step on the CPU, TF32 off:
    loss, grad_norm and every gradient within fp32 2e-4; the updated
    params too, except where the clipped gradient is below 100 * eps,
    where AdamW's first direction g / (|g| + eps) turns on ~1e-8 of
    rounding and the step can move an element by up to 2 * lr (held to
    that plus 2e-4 for the update's own rounding)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import build_grad_fn
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_state

    cfg = get_config("granite-3-2b").reduced().replace(num_layers=2,
                                                       dtype="float32")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p_cpu = _smooth_params(cfg, "cpu")
        p_gpu = tree_map(lambda a: a.to(cuda), p_cpu)
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 64)).astype(np.int32)
        opt = OptConfig(lr=1e-3, warmup_steps=0)
        grads_of = build_grad_fn(cfg, RunConfig(attn_impl="auto",
                                                remat="block"))
        out = {}
        for name, p, dev in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, cuda)):
            t = torch.from_numpy(toks).to(dev)
            loss, _, g = grads_of(p, {"tokens": t, "labels": t})
            _, _, gnorm = apply_updates(opt, p, g, init_state(opt, p))
            out[name] = (loss.item(), gnorm.item(), g)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for k in (0, 1):
        want = out["cpu"][k]
        assert abs(out["gpu"][k] - want) <= 2e-4 + 2e-4 * abs(want)
    _assert_trees_close(out["gpu"][2], out["cpu"][2], 2e-4)
    scale = min(1.0, opt.grad_clip / out["cpu"][1])
    for (path, g), (_, w), (_, gr) in zip(tree_items(p_gpu),
                                          tree_items(p_cpu),
                                          tree_items(out["cpu"][2])):
        d = (g.cpu() - w).abs()
        tiny = (gr * scale).abs() < 100 * 1e-8
        assert bool((d[~tiny] <= 2e-4 + 2e-4 * w.abs().max()).all()), path
        assert bool((d[tiny] <= 2 * opt.lr + 2e-4).all()), path


@pytest.mark.gpu
def test_data_parallel_trainer_over_nccl_matches_the_loop(cuda):
    """The trainer at dp = 1 (all_reduce over NCCL) against the
    single-device loop from the same params and loader seed."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import tree_map
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import train

    cfg = get_config("granite-3-2b").reduced().replace(num_layers=2)
    run = RunConfig(attn_impl="auto", remat="block")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    p0 = _smooth_params(cfg, cuda)
    p_loop = tree_map(torch.clone, p0)
    res = train(cfg, run, opt, batch=4, seq=64, steps=3, device=cuda,
                params=p_loop, log_every=0)
    tr = DataParallelTrainer(cfg, run, opt, strategy="all_reduce",
                             devices=[cuda])
    try:
        res_dp = tr.train(batch=4, seq=64, steps=3, params=p0, log_every=0)
    finally:
        tr.close()
    np.testing.assert_allclose(res_dp.losses, res.losses, rtol=2e-4,
                               atol=2e-4)
    _assert_trees_close(tr.params[0], p_loop, 2e-4)
    rep = tr.report()
    assert rep.dp == 1 and rep.predicted_comm_s == 0.0


@pytest.mark.gpu
def test_session_tune_on_card(cuda, tmp_path):
    """Session.tune() on the card at a reduced size: only the bench stage
    launches the kernels (one warm-up and two timed calls a variant, the
    scan at three chunks), no kernel variant fails, the calibrated
    estimate is the closer one, and the cache holds the torch-cuda key."""
    from repro_torch.api import JobSpec, Session, validate_report
    from repro_torch.core.autotune import Calibration, cached_calibration
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ssd_scan as ssd_k

    wrappers = {"flash_attention": fa_k.flash_attention,
                "decode_attention": dec_k.decode_attention,
                "paged_decode_attention": dec_k.paged_decode_attention,
                "ssd_scan": ssd_k.ssd_scan}
    for w in wrappers.values():
        w.launches = 0
    cache = tmp_path / "cal.json"
    spec = JobSpec(arch="granite-3-2b", batch=2, seq=64, steps=2,
                   log_every=0, tune=True, tune_steps=2,
                   tune_cache=str(cache))
    sess = Session(spec, device="cuda")
    rep = sess.tune()
    validate_report(rep.to_dict())
    assert {n: w.launches for n, w in wrappers.items()} == {
        "flash_attention": 3, "decode_attention": 3,
        "paged_decode_attention": 3, "ssd_scan": 9}
    t = rep.measured["tuning"]
    for entry in t["kernels"].values():
        assert not {n for n in entry["errors"] if n.startswith("kernel")}
    assert t["replan"]["calibrated_closer"]
    # C7: on a card the calibration times the triad at 256 MiB an array
    assert t["calibration"]["measured"]["copy_mb"] == 256.0
    key = Calibration.from_dict(t["calibration"]).key
    assert key.startswith("torch-cuda/h100-8/")
    assert cached_calibration(cache, key) is not None
    for w in wrappers.values():
        w.launches = 0
    assert "tuning" in sess.train().measured
    assert not any(w.launches for w in wrappers.values())


@pytest.mark.gpu
def test_session_sweep_on_card(cuda, monkeypatch):
    """Session.sweep on the card: plan cells priced on the H100 clusters,
    reduced train cells that launch no kernel and leave the allocator as
    they found it, serve cells on B1 and B2, and a kernel fault raised
    from a cell rather than recorded as skipped."""
    import gc

    from repro_torch.api import JobSpec, Session
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels._build import KernelError

    base = JobSpec(arch="granite-3-2b", steps=2, batch=4, seq=32,
                   log_every=0)
    plan = Session.sweep(base, {"topology": ["h100-8", "h100-2x8"]},
                         kind="plan")
    assert len(plan) == 2 and not plan.skipped and plan.summary()["pareto"]
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    fa_k.flash_attention.launches = dec_k.decode_attention.launches = 0
    train = Session.sweep(base, {"batch": [2, 4], "dp": [0, 2]},
                          kind="train")
    ran = {(c["batch"], c["dp"]) for c in train.cells}
    assert ran == ({(2, 0), (4, 0), (2, 2), (4, 2)}
                   if torch.cuda.device_count() >= 2 else {(2, 0), (4, 0)})
    if torch.cuda.device_count() < 2:
        assert [s["error"].split(":")[0] for s in train.skipped] == \
            ["DeviceCountError", "DeviceCountError"]
    assert fa_k.flash_attention.launches == 0
    assert abs(torch.cuda.memory_allocated() - before) < 2**30
    serve = Session.sweep(JobSpec(arch="granite-3-2b", requests=3, n_new=4,
                                  s_max=64), {"max_batch": [1, 2]},
                          kind="serve")
    assert len(serve) == 2 and fa_k.flash_attention.launches > 0
    assert dec_k.decode_attention.launches > 0

    def broken(*a, **k):
        raise KernelError("flash_attention: CUDA kernel launch failed with "
                          "error 700")

    monkeypatch.setattr(fa_k, "flash_attention", broken)
    with pytest.raises(KernelError):
        Session.sweep(JobSpec(arch="granite-3-2b", requests=2, n_new=2,
                              s_max=64), {"max_batch": [1]}, kind="serve")


@pytest.mark.gpu
def test_triad_reads_the_card_bandwidth(cuda):
    """host_microbench's triad is fused passes (two reads, one write an
    element), several to a timed call, so on an H100 (3.35 TB/s on the
    data sheet) it reads above 2e12 B/s both at JAX's 32 MiB an array and
    at 256 MiB (the calibration's on a card): the eager two-kernel form (five array passes
    counted as three) read 1.30-1.40e12, and one fused pass a call
    1.70-2.16e12 at 32 MiB, where the fixed cost of a call (launch and
    synchronize) is about one pass's time."""
    from repro_torch.core.autotune import host_microbench

    for mb in (32, 256):
        got = host_microbench(copy_mb=mb)
        assert got["triad_bw"] > 2e12, (mb, got)


@pytest.mark.gpu
def test_pipeline_trainer_on_one_card(cuda):
    """pipe 2 with both stages on cuda:0 against the single-stage trainer
    (dp 1, run.microbatch = rows a microbatch), 2 steps at fp32 from the
    same params and tokens: every leaf within 2e-4 + 2e-4 * max |want|,
    or 2 * lr + 2e-4 where AdamW's normalized step turns on rounding
    (sqrt of the second moment below 100 * eps; C5's bound)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.pipeline import PipelineTrainer
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.optim.adamw import OptConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-3-2b").reduced().replace(num_layers=4,
                                                       dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    run = RunConfig(attn_impl="auto", remat="block")
    p0 = M.init_params(cfg, 0, cuda)
    pt = PipelineTrainer(cfg, run, opt, pipe=2, n_microbatch=4,
                         devices=["cuda:0", "cuda:0"])
    try:
        pt.train(batch=8, seq=64, steps=2, log_every=0,
                 params=tree_map(torch.clone, p0))
        rep = pt.pipeline_report()
    finally:
        pt.close()
    dp = DataParallelTrainer(cfg, RunConfig(attn_impl="auto", remat="block",
                                            microbatch=2), opt,
                             devices=["cuda:0"])
    try:
        dp.train(batch=8, seq=64, steps=2, log_every=0,
                 params=tree_map(torch.clone, p0))
    finally:
        dp.close()
    assert rep.bubble_model == 0.2
    v = dict(tree_items(dp.opt_states[0]["v"]))
    bc2 = 1 - opt.b2 ** 2
    for path, want in tree_items(dp.params[0]):
        got = dict(tree_items(pt.params))[path]
        d = (got - want).abs()
        tiny = (v[path] / bc2).sqrt() < 100 * opt.eps
        lim = 2e-4 + 2e-4 * want.abs().max().item()
        assert d[~tiny].max().item() <= lim, path
        if bool(tiny.any()):
            assert d[tiny].max().item() <= 2 * opt.lr + 2e-4, path


def _grid_moe(cuda, experts=32, tokens=(4, 256)):
    """deepseek-v2's MoE at full width with ``experts`` experts, and its
    router inputs on a grid (x in halves, the router in 2^-10 steps) where
    every dot product is exact in fp32 on any device and in any order."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import materialize, tree_map

    cfg = get_config("deepseek-v2-236b").replace(num_experts=experts)
    p = tree_map(lambda a: a[0], materialize(moe.moe_specs(cfg, 1), 0, cuda))
    g = torch.Generator(device=cuda).manual_seed(15)
    p["router"] = torch.randint(-8, 9, p["router"].shape, generator=g,
                                device=cuda).float() * 2.0 ** -10
    x = torch.randint(-2, 3, tokens + (cfg.d_model,), generator=g,
                      device=cuda).float() / 2
    return cfg, p, x


@pytest.mark.gpu
def test_moe_mlp_on_card(cuda):
    """chip_smoke.py phase 14.2: moe_mlp at deepseek-v2's width against
    the all-experts reference where nothing drops (fp32, 2e-4); at
    capacity 1.25 the top-k indices and keep mask of the CPU run; output,
    aux and the gradients of x and the router bitwise equal across two
    runs (no atomics in the dispatch or the combine)."""
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x = _grid_moe(cuda)
    T = x.shape[0] * x.shape[1]
    with torch.no_grad():
        big = cfg.num_experts / cfg.top_k  # C > T: room for every assignment
        assert bool(moe.route(p, x.reshape(T, -1), cfg, big)["keep"].all())
        got, _ = moe.moe_mlp(p, x, cfg, capacity_factor=big)
        want = moe.moe_mlp_ref(p, x, cfg)
        lim = 2e-4 + 2e-4 * want.abs().max().item()
        assert (got - want).abs().max().item() <= lim
        card = moe.route(p, x.reshape(T, -1), cfg, 1.25)
        cpu = moe.route({"router": p["router"].cpu()}, x.reshape(T, -1).cpu(),
                        cfg, 1.25)
    assert torch.equal(card["idx"].cpu(), cpu["idx"])
    assert torch.equal(card["order"].cpu(), cpu["order"])
    assert torch.equal(card["keep"].cpu(), cpu["keep"])
    runs = []
    for _ in range(2):
        xr = x.clone().requires_grad_()
        router = p["router"].clone().requires_grad_()
        out, aux = moe.moe_mlp({**p, "router": router}, xr, cfg)
        (out.square().mean() + aux).backward()
        runs.append((out.detach(), aux.detach(), xr.grad, router.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_moe_prelude_pipeline_on_one_card_bitwise(cuda):
    """chip_smoke.py phase 14.5: 1F1B at pipe 2 (both stages on cuda:0) on
    deepseek-v2's reduced config with 4 MLA/MoE cycles after the dense
    prelude, fp32, 2 steps: every param bitwise the single-stage
    trainer's (dp 1, run.microbatch = rows a microbatch)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.pipeline import PipelineTrainer
    from repro_torch.distributed.trainer import DataParallelTrainer
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.optim.adamw import OptConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-v2-236b").reduced().replace(
        num_layers=1 + 4, dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    run = RunConfig(attn_impl="auto", remat="block")
    p0 = M.init_params(cfg, 0, cuda)
    pt = PipelineTrainer(cfg, run, opt, pipe=2, n_microbatch=4,
                         devices=["cuda:0", "cuda:0"])
    try:
        pt.train(batch=8, seq=64, steps=2, log_every=0,
                 params=tree_map(torch.clone, p0))
    finally:
        pt.close()
    dp = DataParallelTrainer(cfg, RunConfig(attn_impl="auto", remat="block",
                                            microbatch=2), opt,
                             devices=["cuda:0"])
    try:
        dp.train(batch=8, seq=64, steps=2, log_every=0,
                 params=tree_map(torch.clone, p0))
    finally:
        dp.close()
    want = dict(tree_items(dp.params[0]))
    for path, got in tree_items(pt.params):
        assert torch.equal(got, want[path]), path


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV,D,window,cap,start", [
    (32, 16, 128, 64, 50.0, 0),   # gemma2's swa slot (window reduced)
    (8, 8, 64, 0, 0.0, 0),        # musicgen: MHA, G = 1
    (56, 8, 128, 0, 0.0, 40)])    # llava: G = 7, decode after a prefix
def test_last_three_archs_kernel_shapes(cuda, H, KV, D, window, cap, start):
    """B1 and B2 at the head shapes gemma2, musicgen and llava give them
    (chip_smoke.py phase 17 runs them at full size) against their plain
    versions, decode rows at positions past ``start``."""
    g = torch.Generator(device=cuda).manual_seed(H + D)
    B, S = 2, 150
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=cuda).to(
        torch.bfloat16) for n in (H, KV, KV))
    scale = 1.0 / np.sqrt(D)
    got = ops.flash_attention(q, k, v, scale=scale, window=window, cap=cap)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), scale=scale,
                                   window=window, cap=cap).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    pos = torch.tensor([start + 7, S - 1], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q[:, :1], k, v, pos, scale=scale,
                               window=window, cap=cap)
    want = ref.decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                    v.transpose(1, 2), pos, scale=scale,
                                    window=window, cap=cap)
    torch.testing.assert_close(got[:, 0].float(), want.float(), **TOL)


@pytest.mark.gpu
def test_gemma2_serving_options_on_card(cuda):
    """Reduced gemma2 (window 64) on the card: a 70-token prompt at s_max
    96 through the static engine runs B1 on every layer and B2 on the
    global slot only (the swa ring wraps: "dense"), and at s_max 64 ==
    window B2 on both (the cache is linear); a sampled generate
    repeats under one seed; an int8 decode step matches the CPU's."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.models import model as M
    from repro_torch.models.blocks import RunConfig
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma2-27b").reduced()
    eng = Engine(cfg, RunConfig(attn_impl="kernel"), s_max=96, device=cuda)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 70))
    fa_k.flash_attention.launches = dec_k.decode_attention.launches = 0
    res = eng.generate(prompt, 5)
    torch.cuda.synchronize()
    assert fa_k.flash_attention.launches == 2
    assert dec_k.decode_attention.launches == 4  # global slot x 4 steps
    assert res.tokens.shape == (1, 5)
    # at s_max == window the swa cache is linear: B2 on both slots
    lin = Engine(cfg, RunConfig(attn_impl="kernel"), s_max=64,
                 params=eng.params, device=cuda)
    dec_k.decode_attention.launches = 0
    lin.generate(prompt[:, :40], 5)
    torch.cuda.synchronize()
    assert dec_k.decode_attention.launches == 2 * 4
    a = eng.generate(prompt, 5, greedy=False, seed=3).tokens
    np.testing.assert_array_equal(a, eng.generate(prompt, 5, greedy=False,
                                                  seed=3).tokens)
    c32 = cfg.replace(dtype="float32")
    p_cpu = M.init_params(c32, 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 1))
    out = []
    for dev, p in ((cuda, tree_map(lambda t: t.to(cuda), p_cpu)),
                   (torch.device("cpu"), p_cpu)):
        caches = tree_map(lambda sp: torch.zeros(sp.shape, dtype={
            "int8": torch.int8, "float32": torch.float32}[sp.dtype],
            device=dev), M.cache_specs(c32, 2, 48, kv_quant=True))
        lg, _ = M.decode_step(p, toks.to(dev), torch.zeros(
            2, dtype=torch.int32, device=dev), caches, c32,
            RunConfig(attn_impl="kernel"))
        out.append(lg.float().cpu())
    torch.testing.assert_close(out[0], out[1], **TOL)


@pytest.mark.gpu
def test_serve_continuous_cell_on_card(cuda, tmp_path):
    """benchmarks/torch_serve_continuous.py's measure() at the reduced
    config on the card: check 2 holds, and each runtime launches B1 once a
    prefill and B2 once a decode step for every layer, no other kernel."""
    import contextlib
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k

    path = (Path(__file__).resolve().parent.parent / "benchmarks"
            / "torch_serve_continuous.py")
    spec = importlib.util.spec_from_file_location("torch_serve_continuous",
                                                  path)
    sc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sc)
    args = sc.parse_args(["--reduced", "--quick", "--no-bench-append",
                          "--outdir", str(tmp_path)])
    launches = {}

    @contextlib.contextmanager
    def counted(mode):
        torch.cuda.synchronize()
        fa_k.flash_attention.launches = dec_k.decode_attention.launches = 0
        yield
        torch.cuda.synchronize()
        launches[mode] = (fa_k.flash_attention.launches,
                          dec_k.decode_attention.launches)

    out = sc.measure(args, watch=counted)
    ok, msg = sc.check_decode_work(out)
    assert ok, msg
    layers = out["continuous"].meta["executed_config"]["num_layers"]
    for mode in sc.MODES:
        m = out[mode].measured
        if mode == "continuous":
            prefills = m["metrics"]["histograms"]["serve/prefill_s"]["count"]
            steps = m["serving"]["throughput"]["engine_steps"]
        else:
            prefills = len(m["batches"])
            steps = sum(b["n_new"] - 1 for b in m["batches"])
        assert launches[mode] == (prefills * layers, steps * layers), mode
        assert m["metrics"]["counters"]["serve/nonfinite_logit_rows"] == 0


@pytest.mark.gpu
def test_kernel_contracts_hold_on_card(cuda):
    """The compiled kernels against the contracts' mirror: no fault, and
    every instantiation's dynamic shared memory the mirror's formula."""
    from repro_torch.analysis import kernel_contracts as kc

    rows = kc.card_check(cuda)
    assert len(rows) == len(kc.card_cases())
    for r, case in zip(rows, kc.card_cases()):
        assert r["kernel"] == case.launch.kernel
        assert r["dyn_smem"] == r["mirror_dyn_smem"] == case.launch.dyn_smem
        assert r["blocks_resident"] >= 1
        assert r["max_threads"] >= r["threads"] == case.launch.threads


def _flash_train_case(cuda, B, S, H, KV, D, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, D, device=cuda, generator=gen)
               for n in (H, KV, KV))
    dout = torch.randn(B, S, H, D, device=cuda, generator=gen)
    pos = torch.arange(S, device=cuda)[None].expand(B, S)
    return q, k, v, dout, pos


def _flash_train_run(fn, q, k, v, dout):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (2, 4096, 32, 8, 64, 0),    # granite-train-s4k-fp32
    (4, 512, 32, 8, 64, 0),     # granite-train-s512-dp4-fp32, a rank
    (2, 1000, 8, 2, 128, 0),    # D 128, S not a multiple of 64
    (1, 700, 16, 4, 128, 300),  # D 128 with a window across tiles
    (3, 200, 4, 4, 64, 48),     # G 1, ragged, a window
])
def test_flash_train_kernel_matches_dense(cuda, B, S, H, KV, D, window):
    """The fp32 training kernels (forward, dQ, dK/dV) against fp32
    dense_attention under autograd on the card, TF32 off: O and the three
    gradients within 1e-4 of the largest |reference| (fp32 sums taken in
    another order over up to S keys); then the same bits on a second
    call (no atomics), and one launch of each entry a call."""
    from repro_torch.kernels import flash_attention_train as fat
    from repro_torch.models.attention import attention, dense_attention

    assert not torch.backends.cuda.matmul.allow_tf32
    q, k, v, dout, pos = _flash_train_case(cuda, B, S, H, KV, D, S + D)
    scale = 1.0 / np.sqrt(D)
    assert fat.takes(q, k, v)
    before = {n: fn.launches for n, fn in fat.ENTRIES.items()}
    got = _flash_train_run(lambda *a: attention(
        *a, pos, pos, scale=scale, window=window, impl="auto"), q, k, v, dout)
    torch.cuda.synchronize()
    assert {n: fn.launches - before[n] for n, fn in fat.ENTRIES.items()} \
        == {n: 1 for n in fat.ENTRIES}
    want = _flash_train_run(lambda *a: dense_attention(
        *a, pos, pos, scale=scale, window=window), q, k, v, dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (name, err)
    again = _flash_train_run(lambda *a: fat.flash_attention_train(
        *a, pos, pos, scale=scale, window=window), q, k, v, dout)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
