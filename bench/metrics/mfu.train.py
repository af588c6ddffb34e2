"""The whole step's share of the card's peak in the configuration's
compute dtype (bf16 on the tensor cores, or fp32 outside them): model
FLOPs a step (``bench/flops.py``: 6 N T over the matrix parameters plus
the mixers' sequence work, times 3, no recompute), per card, over the
window's time per step."""
from bench import flops

NAME = "mfu.train"
UNIT = "%"
BETTER = "higher"
LAYER = "whole step"
MOVES = "train_tokens_per_s"


def read(rec):
    pk = flops.flops_peak(rec.get("device_kind", ""), rec["config"])
    if not pk or not rec.get("steps"):
        return None
    step_s = rec["window_s"] / rec["steps"]
    per_card = flops.train_flops(rec["config"], rec["batch"], rec["seq"]) \
        / rec["chips"]
    return 100.0 * per_card / (step_s * pk)
