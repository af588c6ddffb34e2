"""AdamW's share of its roofline: the least bytes a step (32 per
parameter, ``bench/flops.py``) at the card's HBM rate, over the update's
mean time per step (host clock, ended by a device synchronize)."""
from bench import flops

NAME = "adamw_roofline.train"
UNIT = "%"
BETTER = "higher"
LAYER = "optimizer (optim/adamw.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    spans = rec.get("spans", {}).get("adamw")
    bw = flops.peak(rec.get("device_kind", ""), "hbm_bytes_per_s")
    if not spans or not bw:
        return None
    least = flops.adamw_bytes(rec["config"]) / bw
    return 100.0 * least / (sum(spans) / len(spans))
