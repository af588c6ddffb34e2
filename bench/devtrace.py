"""Device time from ``torch.profiler``: a Chrome trace of a few steps,
reduced to the device's busy time (the union of kernel, copy and memset
intervals), the profiled wall, the operations that took the most device
time, and the longest idle gaps labelled by what the host was doing.

A profile that holds no device record is taken again, up to three
times; after that nothing is returned, and nothing is reported as 0.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def host_label(host: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost host event running at ``t`` (us), or "host idle"."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "host idle"


def reduce_trace(events: List[Dict], wall_s: float) -> Dict:
    """``events``: the Chrome trace's ``traceEvents``.  Times in the trace
    are microseconds."""
    dev, host = [], []
    per_op: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((a, a + d))
            name = str(e.get("name", "?"))[:160]
            per_op[name] = per_op.get(name, 0.0) + d
        elif cat in HOST_CATS:
            host.append((a, a + d, str(e.get("name", "?"))[:160]))
    if not dev:
        return {}
    busy = union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                   for i in range(len(busy) - 1)), reverse=True)[:TOP]
    return {
        "busy_s": busy_s,
        "window_s": wall_s,
        "device_ops": [[n, t / 1e6] for n, t in sorted(
            per_op.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[host_label(host, t0 + g / 2), g / 1e6]
                      for g, t0 in gaps],
    }


def capture(run: Callable[[], None], path: str, tries: int = 3
            ) -> Optional[Dict]:
    """Profile ``run`` (which ends in a device synchronize), write the
    Chrome trace to ``path`` and reduce it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            rec = reduce_trace(json.load(f).get("traceEvents", []), wall)
        if rec and rec["busy_s"] > 0:
            return rec
    return None
