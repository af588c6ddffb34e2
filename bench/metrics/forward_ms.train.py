"""Device time of the forward pass: the union of the intervals of the
operations launched under the program's ``train/forward`` span
(``bench/progtrace.py``), per profiled step; on several cards the
largest rank's."""
from bench import progtrace

NAME = "forward_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "model step (launch/steps.py, models/)"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "forward_ms")
