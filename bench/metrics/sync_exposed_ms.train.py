"""Gradient sync the step does not hide: the mean of the trainer's
``train/exposed_comm_s`` observations over the window's fused steps
(their sum over their count, rank 0)."""
NAME = "sync_exposed_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "gradient sync (distributed/trainer.py, overlap.py, collectives.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    h = rec.get("counters", {}).get("train/exposed_comm_s")
    if not h or not h.get("count"):
        return None
    return 1e3 * h["sum"] / h["count"]
