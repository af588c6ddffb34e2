"""Device time of the attention core in every phase: the operations
launched under ``attn/core@fwd``, ``@recompute`` and ``@bwd``
(``models/attention.py::attention``; the backward's span holds the
gradients of q, k and v), per profiled step; on several cards the
largest rank's."""
from bench import pieces

NAME = "attn_core_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "attention core (models/attention.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    return pieces.span_ms(rec, ["attn/core"])
