"""The held experts' share of the card's peak in the configuration's
compute dtype: their GEMM FLOPs a step at the assignments that capacity
kept, as the program counts them (``moe.kept`` a profiled step;
``bench/flops_mla_moe.py``: 2 * 3 * D * F an assignment forward, times 4
for forward, recompute and backward) over the device time under
``moe/experts`` in every phase.  A program that counts no kept
assignments reads nothing."""
from bench import flops_mla_moe, pieces

NAME = "expert_roofline.train"
UNIT = "%"
BETTER = "higher"
LAYER = "MoE MLP (models/moe.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    kept = pieces.counter_a_step(rec, "moe.kept")
    if rec["config"].get("mixer") != "mla_moe" or kept is None:
        return None
    fwd = flops_mla_moe.expert_flops_fwd(rec["config"], kept)
    return pieces.share(rec, ["moe/experts"],
                        flops_mla_moe.PASSES * fwd / rec["chips"])
