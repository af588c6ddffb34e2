"""Device time of the MLP (dense or MoE) in every phase: the operations
launched under ``model/mlp@fwd``, ``@recompute`` and ``@bwd``, per
profiled step; on several cards the largest rank's."""
from bench import progtrace

NAME = "mlp_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "model step (launch/steps.py, models/)"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "mlp_ms")
