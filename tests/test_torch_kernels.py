"""The port's kernel plain versions against the JAX package's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) and its
``repro.kernels.ref`` oracles, on the same numpy-made inputs.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them to the same plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops, ref

# tests/test_kernels.py's tolerances: fp32 sums in another order; bf16
# inputs and output rounded at other places
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(seed, shapes, dtype):
    """numpy float32 normals, rounded once to ``dtype`` in both frameworks."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(x, getattr(jnp, dtype)) for x in xs]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,KV,D,window,cap",
    [
        (2, 128, 4, 4, 64, 0, 0.0),     # MHA
        (1, 96, 8, 2, 64, 0, 0.0),      # GQA, length not a multiple of 64
        (1, 160, 4, 2, 64, 48, 0.0),    # sliding window
        (1, 72, 4, 2, 128, 24, 30.0),   # window + cap + D=128, ragged
    ],
)
def test_flash_plain_matches_pallas_and_ref(B, S, H, KV, D, window, cap, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(B, H, S, D), (B, KV, S, D), (B, KV, S, D)], dtype)
    scale = 1.0 / np.sqrt(D)
    before = fa_k.flash_attention.launches
    got = fa_k.flash_attention(tq, tk, tv, scale=scale, window=window, cap=cap)
    assert fa_k.flash_attention.launches == before  # CPU: plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jax_flash(jq, jk, jv, scale=scale, window=window, cap=cap,
                       q_block=64, kv_block=64, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, scale=scale, window=window,
                                      cap=cap)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,KV,D,window,cap",
    [
        (3, 256, 4, 4, 64, 0, 0.0),     # MHA
        (4, 300, 8, 2, 64, 0, 0.0),     # GQA, S not a multiple of 64
        (3, 256, 4, 2, 128, 96, 0.0),   # sliding window, D=128
        (3, 200, 8, 2, 64, 0, 30.0),    # tanh cap
    ],
)
def test_decode_plain_matches_pallas_and_ref(B, S, H, KV, D, window, cap,
                                             dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        1, [(B, H, D), (B, KV, S, D), (B, KV, S, D)], dtype)
    # ragged positions: the first and last slot, a tile edge, the rest random
    rng = np.random.default_rng(7)
    pos = np.concatenate([[0, S - 1, 63],
                          rng.integers(1, S, max(B - 3, 0))])[:B].astype(np.int32)
    scale = 1.0 / np.sqrt(D)
    before = dec_k.decode_attention.launches
    got = dec_k.decode_attention(tq, tk, tv, torch.from_numpy(pos),
                                 scale=scale, window=window, cap=cap)
    assert dec_k.decode_attention.launches == before
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jax_decode(jq, jk, jv, jnp.asarray(pos), scale=scale,
                        window=window, cap=cap, kv_block=64, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(pos),
                                       scale=scale, window=window, cap=cap)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


def test_ops_wrappers_model_layout():
    """The model-layout wrappers transpose views only: same numbers as the
    kernel-layout plain versions, no kernel launch on CPU tensors."""
    B, S, H, KV, D = 2, 40, 4, 2, 64
    _, (q, k, v) = _inputs(3, [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)],
                           "float32")
    scale = 1.0 / np.sqrt(D)
    launches = (fa_k.flash_attention.launches, dec_k.decode_attention.launches)
    out = ops.flash_attention(q, k, v, scale=scale)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), scale=scale)
    torch.testing.assert_close(out, want.transpose(1, 2))
    pos = torch.tensor([5, S - 1], dtype=torch.int32)
    dec = ops.decode_attention(q[:, :1], k, v, pos, scale=scale)
    want = ref.decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                    v.transpose(1, 2), pos, scale=scale)
    torch.testing.assert_close(dec[:, 0], want)
    assert (fa_k.flash_attention.launches,
            dec_k.decode_attention.launches) == launches


def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 4, 8, 64), device="meta")
    with pytest.raises(ValueError):
        fa_k.flash_attention(q, q[:, :2], q[:, :2], scale=0.125)
    with pytest.raises(ValueError):
        dec_k.decode_attention(q[:, :, 0], q[:, :2], q[:, :2],
                               torch.zeros((1,), dtype=torch.int32,
                                           device="meta"), scale=0.125)
