"""The device's idle share over a few profiled steady steps:
1 - (the union of device-kernel intervals / the profiled wall), from
``torch.profiler``; on several cards the largest rank's."""
NAME = "device_idle.train"
UNIT = "%"
BETTER = "lower"
LAYER = "device (H100)"
MOVES = "train_tokens_per_s"


def read(rec):
    ranks = [r for r in rec.get("profiles", []) if r]
    if not ranks:
        return None
    return max(100.0 * (1.0 - r["busy_s"] / r["window_s"]) for r in ranks)
