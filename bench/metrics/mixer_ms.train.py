"""Device time of the mixer (attention, MLA or the SSD) in every phase:
the operations launched under ``model/mixer@fwd``, ``@recompute`` and
``@bwd``, per profiled step; on several cards the largest rank's."""
from bench import progtrace

NAME = "mixer_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "model step (launch/steps.py, models/)"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "mixer_ms")
