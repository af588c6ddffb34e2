"""Device time of the final norm, the LM head and the loss in both
phases: the operations launched under ``model/head_loss@fwd`` and
``@bwd``, per profiled step; on several cards the largest rank's."""
from bench import progtrace

NAME = "head_loss_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "model step (launch/steps.py, models/)"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "head_loss_ms")
