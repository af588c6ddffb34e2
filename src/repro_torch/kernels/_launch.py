"""Checks shared by the kernel wrappers before they hand pointers to CUDA."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels._build import KernelError

HEAD_DIMS = (64, 128)


def check_inputs(op: str, tensors: Sequence[torch.Tensor],
                 head_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise unless the kernel can read every tensor as it is: ``dtype``
    (bf16 but for the fp32 training attention) on one CUDA device, last
    dim contiguous, every row 16-byte aligned (the kernels load 16 bytes
    at a time), and, for the attention kernels, head dim 64 or 128."""
    dev = tensors[0].device
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{op}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: the CUDA kernel takes {dtype}, got "
                            f"{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{op}: last dim must be contiguous, strides {t.stride()}")
        if t.data_ptr() % 16 or any(
                s % per16 for n, s in zip(t.shape[:-1], t.stride()[:-1])
                if n > 1):
            raise ValueError(f"{op}: rows must be 16-byte aligned, strides "
                             f"{t.stride()}")
    if head_dim is not None and head_dim not in HEAD_DIMS:
        raise ValueError(f"{op}: head dim {head_dim} not in {HEAD_DIMS}")


def refuse_autograd(op: str, tensors: Sequence[torch.Tensor], use: str) -> None:
    """Raise when autograd would record this call: the kernels have no
    backward, and their output, filled by a C call, would carry no
    ``grad_fn`` on the card, silently dropping every gradient above it.
    Checked on every device, so the CPU (plain-version) path refuses what
    the card would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise KernelError(
            f"{op}: the kernel has no backward (the JAX package's Pallas "
            f"kernels have none either); {use}, or call it under "
            "torch.no_grad() / torch.inference_mode()")


ATTENTION_USE = "training runs attention with attn_impl 'dense', " \
    "'chunked' or 'auto'"


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(op: str, err: int) -> None:
    if err != 0:
        raise KernelError(f"{op}: CUDA kernel launch failed with error {err}")
