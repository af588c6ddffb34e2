"""Device time of the backward pass, block remat's recompute included:
the operations launched under the program's ``train/backward`` span, on
the step's thread or the autograd engine's (``bench/progtrace.py``), per
profiled step; on several cards the largest rank's."""
from bench import progtrace

NAME = "backward_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "model step (launch/steps.py, models/)"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "backward_ms")
