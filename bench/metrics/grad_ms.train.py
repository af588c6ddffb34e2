"""The gradients' time a step: the traced run calls the program's
``grads_of`` and ``adamw.apply_updates`` apart (the work
``build_train_step`` composes), each ended by a device synchronize; mean
per step of the first."""
NAME = "grad_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "model step (launch/steps.py, models/)"
MOVES = "train_tokens_per_s"


def read(rec):
    spans = rec.get("spans", {}).get("grad")
    return 1e3 * sum(spans) / len(spans) if spans else None
