"""Gradient sync the card does not hide, as measured: the device time of
the operations under ``bucket_sync`` (the overlapped trainer's
communication thread) during which no other operation runs on that
card, per profiled step; the largest rank's."""
from bench import progtrace

NAME = "sync_exposed_device_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "gradient sync (distributed/trainer.py, overlap.py, collectives.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "sync_exposed_ms")
