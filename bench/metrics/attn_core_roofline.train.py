"""The attention core's share of the card's peak in the configuration's
compute dtype: its causal FLOPs a step per card
(``bench/flops_mla_moe.py``: 2 T (S/2) H (d_qk + d_v) a layer forward,
times 4 for forward, recompute and a backward of twice the forward)
over ``attn_core_ms.train``'s device time."""
from bench import flops_mla_moe, pieces

NAME = "attn_core_roofline.train"
UNIT = "%"
BETTER = "higher"
LAYER = "attention core (models/attention.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    fwd = flops_mla_moe.attn_core_flops_fwd(rec["config"], rec["batch"],
                                            rec["seq"])
    if fwd is None:
        return None
    return pieces.share(rec, ["attn/core"],
                        flops_mla_moe.PASSES * fwd / rec["chips"])
