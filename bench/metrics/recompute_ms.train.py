"""Device time of block remat's recompute: the operations launched under
the model's ``@recompute`` spans (``models/spans.py``), per profiled
step; on several cards the largest rank's."""
from bench import progtrace

NAME = "recompute_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "model step (launch/steps.py, models/)"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "recompute_ms")
