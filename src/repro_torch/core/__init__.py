"""The paper's procedure: the memory model (Eqs. 1-5) and the kernel-choice
stage of the autotuner."""
