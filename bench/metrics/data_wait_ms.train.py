"""Time a training step waits for its batch: the benchmark's host-clock
span around ``next(loader)`` (the device idle before it), mean per step."""
NAME = "data_wait_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "data pipeline (data/pipeline.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    spans = rec.get("spans", {}).get("data_wait")
    return 1e3 * sum(spans) / len(spans) if spans else None
