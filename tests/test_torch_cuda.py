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
