"""The fp32 training attention with a backward
(``kernels/flash_attention_train.py``, ``csrc/flash_attention_train.cu``)
on the CPU: its plain version against ``dense_attention`` under autograd,
the route ``attention(impl="auto")`` takes, the wrapper's checks, and the
kernels' contracts.  The kernels themselves run in
``tests/test_torch_cuda.py`` (``-m gpu``)."""
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.analysis import kernel_contracts as kc
from repro_torch.configs.base import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention_train as fat
from repro_torch.models import attention as attn


def _inputs(B, S, H, KV, D, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.standard_normal((B, S, n, D)), dtype=dtype)
               for n in (H, KV, KV))
    pos = torch.arange(S)[None].expand(B, S)
    return q, k, v, pos


def _grads(fn, q, k, v, dout):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    return (out,) + torch.autograd.grad(out, (q, k, v), dout)


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
def test_plain_version_matches_dense_under_autograd(G, D, window):
    """Output and dq, dk, dv of the plain forward and backward (the
    kernels' formulas: P from the LSE, Delta = rowsum(dO * O), dS = P (dP
    - Delta), the G heads summed into dK and dV) against dense_attention's
    autograd, fp64 inputs, S = 70 (not a multiple of the 64-row tiles).
    dense_attention takes its logits in fp32: 1e-5."""
    B, S, KV = 2, 70, 2
    q, k, v, pos = _inputs(B, S, KV * G, KV, D, seed=G * D + window)
    dout = torch.randn(B, S, KV * G, D, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(window))
    scale = 1.0 / np.sqrt(D)
    got = _grads(lambda *a: fat.flash_attention_train(
        *a, pos, pos, scale=scale, window=window), q, k, v, dout)
    want = _grads(lambda *a: attn.dense_attention(
        *a, pos, pos, scale=scale, window=window), q, k, v, dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float64, name
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


def test_plain_forward_lse_and_delta():
    """The LSE the forward saves is each row's logsumexp of the masked,
    scaled scores; Delta is rowsum(dO * O), (B, H, S)."""
    B, S, H, KV, D = 1, 20, 4, 2, 64
    q, k, v, pos = _inputs(B, S, H, KV, D, seed=3)
    o, lse = fat.forward_ref(q, k, v, pos, pos, scale=0.125, window=5)
    s = torch.einsum("bqhd,bshd->bhqs", q,
                     k.repeat_interleave(H // KV, dim=2)) * 0.125
    vis = attn._mask(pos, pos, 5)[:, None]
    want = torch.logsumexp(s.masked_fill(~vis, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want)
    dout = torch.ones_like(o)
    _, delta = fat.dq_ref(q, k, v, o, lse, dout, pos, pos, scale=0.125,
                          window=5)
    torch.testing.assert_close(delta, o.sum(-1).transpose(1, 2))


def _fake(shape, dtype=torch.float32, device="cuda"):
    return SimpleNamespace(shape=shape, dtype=dtype,
                           device=torch.device(device))


@pytest.mark.parametrize("q,k,v,cap,want", [
    # granite's two training cells and a D 128 GQA layer: taken
    ((2, 4096, 32, 64), (2, 4096, 8, 64), (2, 4096, 8, 64), 0.0, True),
    ((4, 512, 32, 64), (4, 512, 8, 64), (4, 512, 8, 64), 0.0, True),
    ((1, 700, 56, 128), (1, 700, 8, 128), (1, 700, 8, 128), 0.0, True),
    ((1, 70, 32, 64), (1, 70, 32, 64), (1, 70, 32, 64), 0.0, True),  # G 1
    # gemma2's tanh cap
    ((1, 512, 32, 128), (1, 512, 16, 128), (1, 512, 16, 128), 50.0, False),
    # MLA: q/k head dim 192, v's 128
    ((1, 512, 128, 192), (1, 512, 128, 192), (1, 512, 128, 128), 0.0, False),
    # a head dim with no instantiation
    ((1, 512, 40, 96), (1, 512, 40, 96), (1, 512, 40, 96), 0.0, False),
    # fewer queries than keys
    ((1, 64, 32, 64), (1, 512, 8, 64), (1, 512, 8, 64), 0.0, False),
    # H not a multiple of KV
    ((1, 64, 6, 64), (1, 64, 4, 64), (1, 64, 4, 64), 0.0, False),
])
def test_route_predicate(q, k, v, cap, want):
    assert fat.takes(_fake(q), _fake(k), _fake(v), cap) is want


def test_route_predicate_refuses_bf16_and_cpu_tensors():
    q, k = (2, 512, 32, 64), (2, 512, 8, 64)
    assert fat.takes(_fake(q), _fake(k), _fake(k))
    assert not fat.takes(*(_fake(s, torch.bfloat16) for s in (q, k, k)))
    assert not fat.takes(_fake(q), _fake(k, torch.bfloat16), _fake(k))
    assert not fat.takes(*(_fake(s, device="cpu") for s in (q, k, k)))


@pytest.mark.parametrize("S,plain", [(70, "dense"), (2100, "chunked")])
def test_auto_on_cpu_keeps_the_plain_paths(S, plain):
    """On CPU tensors "auto" runs what it ran before (dense up to 2048
    keys, chunked above), bit for bit, and launches nothing."""
    q, k, v, pos = _inputs(1, S, 2, 1, 64, seed=S, dtype=torch.float32)
    before = {n: fn.launches for n, fn in fat.ENTRIES.items()}
    got = attn.attention(q, k, v, pos, pos, scale=0.125, impl="auto")
    want = attn.attention(q, k, v, pos, pos, scale=0.125, impl=plain)
    assert torch.equal(got, want)
    assert {n: fn.launches for n, fn in fat.ENTRIES.items()} == before


def test_auto_sends_taken_inputs_to_the_training_attention(monkeypatch):
    calls = []

    def fake(q, k, v, q_pos, k_pos, *, scale, window):
        calls.append((q.shape, scale, window))
        return torch.zeros_like(q)

    monkeypatch.setattr(fat, "takes", lambda q, k, v, cap: cap == 0.0)
    monkeypatch.setattr(fat, "flash_attention_train", fake)
    q, k, v, pos = _inputs(1, 16, 4, 2, 64, seed=0, dtype=torch.float32)
    attn.attention(q, k, v, pos, pos, scale=0.5, window=3, impl="auto")
    assert calls == [(q.shape, 0.5, 3)]
    attn.attention(q, k, v, pos, pos, scale=0.5, cap=30.0, impl="auto")
    attn.attention(q, k, v, pos, pos, scale=0.5, impl="dense")
    attn.attention(q, k, v, pos, pos, scale=0.5, impl="chunked")
    assert len(calls) == 1


def test_kernel_impl_still_refuses_autograd():
    q, k, v, pos = _inputs(1, 16, 4, 2, 64, seed=0, dtype=torch.bfloat16)
    q.requires_grad_()
    with pytest.raises(_build.KernelError, match="no backward"):
        attn.attention(q, k, v, pos, pos, scale=0.125, impl="kernel")


def test_wrapper_checks_raise():
    q, k, v, pos = _inputs(1, 16, 6, 4, 64, seed=0, dtype=torch.float32)
    with pytest.raises(ValueError, match="H % KV"):
        fat.flash_forward(q, k, v, pos, pos, scale=0.125)
    q, k, v, pos = _inputs(1, 16, 4, 2, 64, seed=0, dtype=torch.float32)
    with pytest.raises(ValueError, match="H % KV"):
        fat.flash_forward(q, k[:, :8], v[:, :8], pos, pos, scale=0.125)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="unsupported device"):
        fat.flash_forward(*meta, pos.to("meta"), pos.to("meta"), scale=0.125)


# ---------------------------------------------------------------------------
# Contracts (KC201-KC204, KC206, KC208)
# ---------------------------------------------------------------------------


def test_contract_at_the_training_cells_is_clean():
    for B, S in ((2, 4096), (4, 512)):
        c, found = kc.flash_train_contract(B=B, H=32, KV=8, S=S, D=64)
        assert found == [] and kc.check_contract(c) == []
        assert [ln.kernel for ln in c.launches] == [
            "fwd_kernel<64>", "dq_kernel<64>", "dkdv_kernel<64>"]
        assert [ln.grid for ln in c.launches] == [
            (32, S // 64, B), (32, S // 64, B), (8, S // 64, B)]
        assert [ln.dyn_smem for ln in c.launches] == [104_960, 87_552,
                                                     105_216]
        assert c.scratch_bytes == 2 * B * 32 * S * 4
    c, _ = kc.flash_train_contract(B=1, H=56, KV=8, S=4096, D=128)
    assert [ln.threads for ln in c.launches] == [256] * 3
    assert kc.check_contract(c) == []
    assert max(ln.dyn_smem for ln in c.launches) <= kc.SMEM_OPTIN


@pytest.mark.parametrize("build,code", [
    (lambda: kc.flash_train_contract(B=1, H=8, KV=8, S=64, D=96)[1], "KC201"),
    (lambda: kc.flash_train_contract(B=1, H=6, KV=4, S=64, D=64)[1], "KC205"),
    (lambda: kc.check_contract(kc.flash_train_contract(
        B=70_000, H=8, KV=2, S=128, D=64)[0]), "KC204"),
    (lambda: kc.check_contract(kc.HopperContract(
        "flash_attention_train", "fixture", (("D", 128),),
        (kc.Launch("fwd_kernel<128>", (1, 1, 1), 256,
                   kc.flash_train_smem("fwd", 128), min_blocks=2,
                   claimed_blocks=2),))), "KC202"),
    (lambda: kc.check_contract(kc.HopperContract(
        "flash_attention_train", "fixture", (("D", 64),),
        (kc.Launch("dq_kernel<64>", (1, 1, 1), 128, 1024, min_blocks=2,
                   claimed_blocks=3),))), "KC203"),
])
def test_contract_rules_fire(build, code):
    found = build()
    assert found and {f.code for f in found} == {code}
    assert {f.path for f in found} == {
        "src/repro_torch/csrc/flash_attention_train.cu"}


def test_mirror_reads_the_source_and_names_drift(tmp_path):
    text = kc.read_sources()
    assert {k: v for k, v in text.items() if k.startswith("flash_train.")} \
        == {"flash_train.BM": 64, "flash_train.BN": 64, "flash_train.TY": 16,
            "flash_train.TP": 68, "flash_train.D": (64, 128),
            "flash_train.min_blocks": {64: 2, 128: 1}}
    assert kc.mirror_drift() == []
    csrc = tmp_path / "csrc"
    shutil.copytree(kc.CSRC, csrc)
    ft = csrc / "flash_attention_train.cu"
    ft.write_text(ft.read_text()
                  .replace("constexpr int TP = 68;", "constexpr int TP = 64;")
                  .replace("__launch_bounds__(2 * D, D == 64 ? 2 : 1)",
                           "__launch_bounds__(2 * D, D == 64 ? 3 : 1)"))
    got = {f.context for f in kc.mirror_drift(csrc)}
    assert got == {"mirror:flash_train.TP", "mirror:flash_train.min_blocks"}


def test_card_cases_and_registry_routes():
    cases = [c for c in kc.card_cases() if c.op == "flash_attention_train"]
    assert [(c.args, c.launch.kernel) for c in cases] == [
        ((i, D), f"{kind}_kernel<{D}>") for D in (64, 128)
        for i, kind in enumerate(("fwd", "dq", "dkdv"))]
    found, audit, routes = kc.check_registry()
    assert found == []
    impl = {r.context: r.impl for r in routes if r.op == "flash_attention_train"}
    ctx = "flash_attention_train:{}:train_4k:{}:{}"
    assert impl[ctx.format("granite-3-2b", "fp32", "attn")] == "kernel"
    assert impl[ctx.format("granite-3-2b", "bf16", "attn")] == "chunked"
    assert impl[ctx.format("gemma2-27b", "fp32", "swa")] == "chunked"  # cap
    assert impl[ctx.format("deepseek-v2-236b", "fp32", "mla")] == "chunked"
    assert set(audit["flash_attention_train"]) == {
        c for c, i in impl.items() if i == "kernel"}
    assert kc.train_attn_impl(get_config("granite-3-2b").replace(
        dtype="float32"), "attn", 4, 512) == "kernel"
    assert kc.train_attn_impl(get_config("granite-3-2b"), "attn", 4,
                              512) == "dense"
