"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

- ``flash_attention`` (csrc/flash_attention.cu) replaces
  ``repro.kernels.flash_attention.flash_attention``;
- ``decode_attention`` (csrc/decode_attention.cu) replaces
  ``repro.kernels.decode_attention.decode_attention`` and, through the
  same kernel with a block-table tile load, ``paged_decode_attention``;
- ``ssd_scan`` (csrc/ssd_scan.cu) replaces
  ``repro.kernels.ssd_scan.ssd_scan``;
- ``flash_attention_train`` (csrc/flash_attention_train.cu) replaces no
  TPU kernel: the fp32 training attention with its backward, which
  ``models.attention.attention(impl="auto")`` takes on the card, with its
  plain versions beside it;
- ``ref`` holds their plain PyTorch versions; ``ops`` the model-layout
  wrappers and the tuning registry; ``_build`` compiles the sources with
  nvcc at first use.
"""
