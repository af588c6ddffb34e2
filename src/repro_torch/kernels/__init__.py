"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

- ``flash_attention`` (csrc/flash_attention.cu) replaces
  ``repro.kernels.flash_attention.flash_attention``;
- ``decode_attention`` (csrc/decode_attention.cu) replaces
  ``repro.kernels.decode_attention.decode_attention``;
- ``ref`` holds their plain PyTorch versions; ``ops`` the model-layout
  wrappers; ``_build`` compiles the sources with nvcc at first use.
"""
