"""The program's spans joined to the device's work, from the Chrome trace
of the profiled steps that a traced run writes (``bench/devtrace.py``).

The program brackets its phases with ``torch.profiler.record_function``
(``repro_torch.obs.trace``): each is a ``user_annotation`` event on the
thread that opened it, on the profiler's clock. A device operation
(kernel, copy, memset) belongs to the innermost span open on its
launching thread when it was launched, matched by ``args.correlation``
to its CUDA runtime or driver call; the spans that enclose that one on
the same thread, and the ``train/*`` or ``fused_step`` spans then open
on the step's thread, hold it too, so a span's device time is the union
of its operations' intervals, children included; but an operation under
``bucket_sync`` is the sync's alone, though the step counts its launch.
A launch with no span open on its thread belongs to the innermost
``train/*`` span open at that moment. A layer (``model/mixer``,
``model/mlp``, ``model/head_loss``) holds the operations whose innermost
``model/*`` span is its own: block remat recomputes the whole block
inside the backward of the first layer that needs a saved tensor (the
MLP's), so by nesting that layer would also hold the other layers'
recompute. The profiler does not follow threads the program starts
itself; of those only the overlapped trainer's communication thread
launches device work, so in a trace of that trainer (one with
``sync/wait`` spans) a launch from a thread the profiler does not follow
belongs to ``bucket_sync``. Every quantity is per step: per
``train/step`` or ``fused_step`` span in the trace. An idle gap of the
card belongs to the innermost span open at its middle, or, where none
is, to the span that launched the kernel ending it: the work the card
waited for. Annotations that are not the program's
(``torch.distributed``'s ``nccl:all_reduce``) are no span.

A metric reader (``bench/metrics/``) gets only the run's record; the
trace files are found where the drivers write them, by the cells whose
configuration, batch, sequence and cards the record names, and only if
this process's run wrote them.  A run without the program's spans (the
parent of the change that added them) reads nothing.

    python3 bench/progtrace.py TRACE.json [TRACE.json ...]

prints each trace's reduction (``by_span``: device and idle ms a step per
span; the ten longest idle gaps and the span open at each one's middle).
"""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import harness  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
FOLLOWED_CATS = ("cpu_op", "user_annotation")
STEP_SPANS = ("train/step", "fused_step")
# the program's span names: a lower-case word (``data/h2d``), an area
# before a slash, a phase after ``@``
SPAN_NAME = re.compile(r"^[a-z_][a-z0-9_]*(/[a-z0-9_]+)?(@[a-z]+)?$")
TOP = 10

Intervals = List[Tuple[float, float]]


def union(intervals: Intervals) -> Intervals:
    out: Intervals = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def measure(intervals: Intervals) -> float:
    return sum(b - a for a, b in intervals)


def overlap(xs: Intervals, ys: Intervals) -> float:
    """The measure of the intersection of two unions (sorted, disjoint)."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _steplike(name: str) -> bool:
    return name.startswith("train/") or name == "fused_step"


def reduce_events(events: List[Dict]) -> Optional[Dict]:
    """The reduction of one trace's ``traceEvents`` (times in µs), or None
    when it holds no step span of the program or no device operation."""
    spans, launches, ops = [], {}, []
    followed, waits = set(), []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in FOLLOWED_CATS:
            followed.add(e.get("tid"))
        if cat == "user_annotation" and SPAN_NAME.match(str(e.get("name"))):
            name = str(e["name"])
            spans.append((a, b, e.get("tid"), name))
            if name == "data/wait":
                waits.append(b - a)
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (a, e.get("tid"))
        elif cat in DEVICE_CATS:
            ops.append((a, b, (e.get("args") or {}).get("correlation"),
                        cat == "kernel"))
    steps = sum(1 for s in spans if s[3] in STEP_SPANS)
    if not steps or not ops:
        return None
    overlapped = any(s[3] == "sync/wait" for s in spans)

    # one sweep over span starts (0), launches (1) and span ends (2)
    points = []
    for k, (a, b, tid, name) in enumerate(spans):
        points.append((a, 0, k))
        points.append((b, 2, k))
    for corr, (t, tid) in launches.items():
        points.append((t, 1, corr))
    points.sort(key=lambda p: (p[0], p[1]))
    stacks: Dict[object, List[int]] = {}
    open_steplike: List[int] = []
    chain_of: Dict[object, Tuple[Tuple[str, ...], bool, str, str]] = {}
    for t, kind, x in points:
        if kind == 0:
            stacks.setdefault(spans[x][2], []).append(x)
            if _steplike(spans[x][3]):
                open_steplike.append(x)
        elif kind == 2:
            stack = stacks[spans[x][2]]
            stack.remove(x)
            if x in open_steplike:
                open_steplike.remove(x)
        else:
            tid = launches[x][1]
            own = [spans[k][3] for k in stacks.get(tid, [])]
            steplike = [spans[k][3] for k in open_steplike]
            if not own and tid not in followed and overlapped:
                own = ["bucket_sync"]
            inner = (own or steplike or ["no span"])[-1]
            layer = next((n for n in reversed(own)
                          if n.startswith("model/")), "")
            # the communication thread's launches are the sync's alone,
            # whatever the step's thread has open meanwhile
            held = own if "bucket_sync" in own else own + steplike
            chain_of[x] = (tuple(dict.fromkeys(held)),
                           any(n in STEP_SPANS for n in steplike), inner,
                           layer)

    by_name: Dict[str, Intervals] = {}
    by_inner: Dict[str, Intervals] = {}
    by_layer: Dict[str, Intervals] = {}
    every: Intervals = []
    launched_in_steps = 0
    for a, b, corr, kernel in ops:
        every.append((a, b))
        names, in_step, inner, layer = chain_of.get(
            corr, ((), False, "no span", ""))
        for n in names:
            by_name.setdefault(n, []).append((a, b))
        by_inner.setdefault(inner, []).append((a, b))
        by_layer.setdefault(layer.split("@")[0], []).append((a, b))
        if in_step and kernel:
            launched_in_steps += 1

    def group(pred) -> Intervals:
        return union([iv for n, ivs in by_name.items() if pred(n)
                      for iv in ivs])

    busy = union(every)

    def ms(intervals: Intervals) -> float:
        return measure(intervals) / 1e3 / steps

    model = group(lambda n: n.startswith("model/"))
    fwd_bwd = group(lambda n: n in ("train/forward", "train/backward"))
    sync = group(lambda n: n == "bucket_sync")
    rest = union([(a, b) for a, b, corr, _ in ops
                  if "bucket_sync" not in chain_of.get(corr, ((),))[0]])
    gaps = sorted(((busy[i + 1][0] - busy[i][1],
                    (busy[i][1] + busy[i + 1][0]) / 2, busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)
    first_at = {}  # a start time -> the span that launched that kernel
    for a, _, corr, _ in ops:
        first_at.setdefault(a, chain_of.get(corr, (0, 0, "no span"))[2])
    gap_span = [name if name != "no span" else first_at[end]
                for name, (_, _, end) in zip(
                    _spans_at(spans, [m for _, m, _ in gaps]), gaps)]
    idle: Dict[str, float] = {}
    for (g, _, _), name in zip(gaps, gap_span):
        idle[name] = idle.get(name, 0.0) + g
    by_span = {n: {"device_ms": ms(union(by_name.get(n, []))),
                   "self_ms": ms(union(by_inner.get(n, []))),
                   "idle_ms": idle.get(n, 0.0) / 1e3 / steps}
               for n in sorted(set(by_name) | set(by_inner) | set(idle))}
    outside = measure(fwd_bwd) - overlap(fwd_bwd, model)
    return {
        "steps": steps,
        "busy_ms": ms(busy),
        "launches": launched_in_steps / steps,
        "data_wait_ms": sum(waits) / 1e3 / steps,
        "forward_ms": ms(group(lambda n: n == "train/forward")),
        "backward_ms": ms(group(lambda n: n == "train/backward")),
        "optimizer_ms": ms(group(lambda n: n == "train/optimizer")),
        "recompute_ms": ms(group(lambda n: n.endswith("@recompute"))),
        "mixer_ms": ms(union(by_layer.get("model/mixer", []))),
        "mlp_ms": ms(union(by_layer.get("model/mlp", []))),
        "head_loss_ms": ms(union(by_layer.get("model/head_loss", []))),
        "outside_model_ms": outside / 1e3 / steps,
        "sync_ms": ms(sync),
        "sync_exposed_ms": (measure(sync) - overlap(sync, rest)) / 1e3
        / steps,
        "overlapped": overlapped,
        "by_span": by_span,
        "idle_gaps": [[name, g / 1e3] for (g, _, _), name
                      in zip(gaps[:TOP], gap_span[:TOP])],
    }


def _spans_at(spans, times: List[float]) -> List[str]:
    """The innermost span (the latest started of those open, on any
    thread) at each of ``times``, or "no span"."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    starts = sorted(range(len(spans)), key=lambda k: spans[k][0])
    out = ["no span"] * len(times)
    open_: List[int] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(starts) and spans[starts[j]][0] <= t:
            open_.append(starts[j])
            j += 1
        open_ = [k for k in open_ if spans[k][1] >= t]
        if open_:
            out[i] = spans[max(open_, key=lambda k: spans[k][0])][3]
    return out


_CACHE: Dict[str, Tuple[float, Optional[Dict]]] = {}


def reduce_file(path: str) -> Optional[Dict]:
    mtime = os.path.getmtime(path)
    hit = _CACHE.get(path)
    if hit is None or hit[0] != mtime:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        _CACHE[path] = (mtime, reduce_events(events))
    return _CACHE[path][1]


def cells_of(rec: Dict) -> List[str]:
    """The cells whose configuration, traffic shape and cards the record
    names."""
    name = (rec.get("config") or {}).get("name")
    found = []
    for path in sorted((harness.HERE / "workloads").glob("*.json")):
        c = harness.load_json(path)
        t = harness.traffic(c["traffic"])
        if (c["config"], int(t["batch"]), int(t["seq"]), int(c["chips"])) \
                == (name, rec.get("batch"), rec.get("seq"), rec.get("chips")):
            found.append(path.stem)
    return found


def trace_files(rec: Dict) -> List[str]:
    """The Chrome traces this process's run of the record's cell wrote,
    one a card, named as the drivers name them: of the cells of the
    record's shape, the one whose traces this process wrote.  Two such
    cells raise."""
    tmp = tempfile.gettempdir()
    chips = int(rec.get("chips") or 1)
    since = harness.process_start() - 1.0
    written = {}
    for cell in cells_of(rec):
        names = ([f"bench-trace-{cell}.json"] if chips == 1 else
                 [f"bench-trace-{cell}-rank{i}.json" for i in range(chips)])
        paths = [p for p in (os.path.join(tmp, n) for n in names)
                 if os.path.exists(p) and os.path.getmtime(p) >= since]
        if paths:
            written[cell] = paths
    if len(written) > 1:
        raise RuntimeError(f"this process wrote the traces of cells "
                           f"{sorted(written)}, each of the record's shape")
    return next(iter(written.values()), [])


def readings(rec: Dict) -> List[Dict]:
    """Each card's reduction, for the cards whose trace holds the
    program's spans."""
    out = []
    for path in trace_files(rec):
        try:
            red = reduce_file(path)
        except (OSError, ValueError):
            red = None
        if red is not None:
            out.append(red)
    return out


def largest(rec: Dict, key: str) -> Optional[float]:
    """``key`` of the reduction, the largest card's; None without one."""
    vals = [r[key] for r in readings(rec) if r.get(key) is not None]
    return max(vals) if vals else None


def main(argv=None) -> int:
    for path in (argv if argv is not None else sys.argv[1:]):
        red = reduce_file(path)
        print(json.dumps({"trace": path, "reduction": red}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
