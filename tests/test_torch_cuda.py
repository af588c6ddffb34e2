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
    # query heads per kv head G = 4, 2, 8, 16: every rows-per-warp
    # instantiation of the decode kernel; D = 64 and 128
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
    # G = H / KV = 1, 4, 8; D = 64 and 128; windows and caps
    for (B, S, H, KV, D, window, cap) in [(3, 256, 4, 4, 64, 0, 0.0),
                                          (4, 320, 32, 8, 64, 0, 0.0),
                                          (2, 192, 16, 2, 128, 70, 30.0)]:
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
    """Every (P, N) instantiation at the chunks the path uses: the tuning
    chunks 32/64/128 at L = 128, the reduced config (N 32, P 32, chunk 32)
    and mamba2-780m's width (P 64, N 128, chunk 256)."""
    from repro_torch.kernels import ssd_scan as ssd_k
    gen = torch.Generator(device=cuda).manual_seed(0)
    cases = [(1, 2, 128, 32, 16, c) for c in (32, 64, 128)]
    cases += [(2, 3, 128, P, N, 32) for P in (32, 64) for N in (16, 32, 64, 128)]
    cases += [(1, 4, 512, 64, 128, 256), (2, 5, 256, 32, 64, 16)]
    for (B, H, L, P, N, chunk) in cases:
        # model layout (B,L,H,P) and (B,L,H), handed over as views
        x = torch.randn(B, L, H, P, device=cuda, generator=gen).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(
            torch.randn(B, L, H, device=cuda, generator=gen)).to(torch.bfloat16)
        a = -torch.exp(torch.randn(H, device=cuda, generator=gen) * 0.5)
        b = torch.randn(B, L, N, device=cuda, generator=gen).to(torch.bfloat16)
        c = torch.randn(B, L, N, device=cuda, generator=gen).to(torch.bfloat16)
        args = (x.transpose(1, 2), dt.transpose(1, 2), a, b, c)
        y, h = ssd_k.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        wy, wh = ref.ssd_scan_ref(*args, chunk=chunk)
        # fp32 inside both, sums in another order; y rounded to bf16
        torch.testing.assert_close(y.float(), wy.float(), **TOL)
        torch.testing.assert_close(h, wh, rtol=1e-3, atol=1e-3)
