"""Kernel launches a step: the kernels of the profiled steps launched
while a ``train/step`` or ``fused_step`` span was open, on any thread,
over the number of steps; on several cards the largest rank's."""
from bench import progtrace

NAME = "launches.train"
UNIT = "count"
BETTER = "lower"
LAYER = "whole step"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "launches")
