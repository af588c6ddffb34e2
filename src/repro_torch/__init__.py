"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

The JAX package (``src/repro``) is the reference; each module here keeps
the name and layout of its JAX counterpart so the two are easy to pair.
The port imports ``torch`` and ``numpy`` only, never ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a machine without a card raises.  The hand-written
CUDA kernels live in ``csrc/`` and are built at first use (see
``repro_torch.kernels._build``).
"""
