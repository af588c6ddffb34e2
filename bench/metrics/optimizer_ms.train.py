"""Device time of the optimizer update: the operations launched under the
program's ``train/optimizer`` span (around ``adamw.apply_updates``), per
profiled step; on several cards the largest rank's."""
from bench import progtrace

NAME = "optimizer_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "optimizer (optim/adamw.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "optimizer_ms")
