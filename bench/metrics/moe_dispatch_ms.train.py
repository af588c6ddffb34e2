"""Device time of the MoE layer's routing and data movement in every
phase: the operations launched under ``moe/route``, ``moe/dispatch`` and
``moe/combine`` (``models/moe.py``), ``@fwd``, ``@recompute`` and
``@bwd``, per profiled step."""
from bench import pieces

NAME = "moe_dispatch_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "MoE MLP (models/moe.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    return pieces.span_ms(rec, ["moe/route", "moe/dispatch", "moe/combine"])
