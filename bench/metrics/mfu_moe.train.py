"""The whole step's share of the card's peak in the configuration's
compute dtype, for the MLA + MoE family: model FLOPs a step per card
(``bench/flops_mla_moe.py``: 6 N T over the matrix parameters a token
meets, the routed experts at the assignments capacity kept as the
program counts them, ``moe.kept`` a profiled step, or at their expected
share where it counts none, plus 3 times the attention core's forward;
no recompute) over the window's time per step."""
from bench import flops, flops_mla_moe, pieces

NAME = "mfu_moe.train"
UNIT = "%"
BETTER = "higher"
LAYER = "whole step"
MOVES = "train_tokens_per_s"


def read(rec):
    pk = flops.flops_peak(rec.get("device_kind", ""), rec["config"])
    if not pk or not rec.get("steps") or rec["config"].get("mixer") \
            != "mla_moe":
        return None
    step_s = rec["window_s"] / rec["steps"]
    per_card = flops_mla_moe.train_flops(
        rec["config"], rec["batch"], rec["seq"],
        pieces.counter_a_step(rec, "moe.kept")) / rec["chips"]
    return 100.0 * per_card / (step_s * pk)
