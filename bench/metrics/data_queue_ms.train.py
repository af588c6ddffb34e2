"""Time a step waits for the loader's producer: the host time of the
program's ``data/wait`` spans (``PrefetchLoader``, around the queue's
blocking get) in the profiled steps, mean per step; on several cards
the largest rank's."""
from bench import progtrace

NAME = "data_queue_ms.train"
UNIT = "ms"
BETTER = "lower"
LAYER = "data pipeline (data/pipeline.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    return progtrace.largest(rec, "data_wait_ms")
