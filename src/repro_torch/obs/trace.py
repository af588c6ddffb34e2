"""Tracer — nestable wall-clock spans with Chrome-trace export.

The paper's whole method is *measure, then configure*: Lemma 3.1/3.2 only
pay off when step time, comm time, and overlap are observable quantities.
Until this module every hot path timed itself with scattered
``time.perf_counter()`` pairs and threw the measurement away at process
exit.  ``Tracer`` is the one clock those paths share:

- ``with tracer.span("dist_update") as sp: ...`` times a phase; the span's
  ``elapsed_s`` is exactly the ``perf_counter()`` pair it replaces, so the
  values that feed ``SyncReport`` / ``GenResult.stats()`` are unchanged —
  the span *additionally* lands in the tracer's event log.
- Spans nest (``span("step")`` around ``span("bucket_sync", bucket=i)``);
  the recorded depth/intervals reconstruct the phase tree offline.
- ``chrome_trace()`` / ``save()`` export the Chrome ``traceEvents`` JSON
  (load in ``chrome://tracing`` or https://ui.perfetto.dev).
- A *disabled* tracer is free: ``span()`` returns a shared no-op singleton
  (no event, no allocation that survives the call), so library code can
  trace unconditionally.
- ``nvtx_annotations=True`` additionally brackets every span with a
  ``torch.cuda.nvtx`` range so a device-side profile collected with
  ``torch.profiler`` carries the same phase names.
- A span times host wall clock only.  Callers whose span covers device
  work end it after a host sync (a ``.cpu()`` of the result or
  ``torch.cuda.synchronize()``), so the span length is the measurement.

Import-light by design (stdlib only unless annotations are enabled): the
rest of ``repro_torch.obs`` must be usable without pulling in torch.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

__all__ = ["Span", "SpanEvent", "Tracer", "NULL_TRACER", "monotonic"]


def monotonic() -> float:
    """The package's sanctioned monotonic clock — the same clock ``Tracer``
    spans run on.  Measured paths that need a raw timestamp (rather than
    a span) read time through here, so this module stays the *only* place
    in ``repro_torch`` that touches ``time`` directly."""
    return time.perf_counter()


@dataclass(frozen=True)
class SpanEvent:
    """One finished span: start offset from the tracer epoch + duration."""

    name: str
    t0_s: float          # start, seconds since the tracer's epoch
    dur_s: float         # wall-clock duration [s]
    depth: int           # nesting depth at entry (0 = top level, per thread)
    tid: int             # python thread id the span ran on
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def t1_s(self) -> float:
        return self.t0_s + self.dur_s


class _NullSpan:
    """Shared no-op span — the disabled tracer's zero-cost fast path."""

    __slots__ = ()
    elapsed_s = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Span:
    """A live span; use as a context manager.  ``elapsed_s`` after exit is
    the phase wall clock (mid-flight it reads the running elapsed)."""

    __slots__ = ("tracer", "name", "args", "t0", "t1", "depth", "_ann")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.t1 = 0.0
        self.depth = 0
        self._ann = None

    @property
    def elapsed_s(self) -> float:
        if self.t1:
            return self.t1 - self.t0
        return (self.tracer._clock() - self.t0) if self.t0 else 0.0

    def __enter__(self) -> "Span":
        tr = self.tracer
        stack = tr._thread_stack()
        self.depth = len(stack)
        stack.append(self.name)
        if tr.nvtx_annotations:
            self._ann = tr._annotation(self.name)
            if self._ann is not None:
                self._ann.__enter__()
        self.t0 = tr._clock()  # last: annotation setup stays untimed
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = self.tracer._clock()  # first: recording stays untimed
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        self.tracer._record(self)
        return False


class Tracer:
    """Phase-level wall-clock tracing with near-zero overhead when disabled.

    ``max_events`` bounds memory on long runs: past the cap new spans still
    time correctly (their ``elapsed_s`` keeps feeding the metrics that need
    it) but are not recorded; ``dropped`` counts them.
    """

    def __init__(self, enabled: bool = True, *, max_events: int = 100_000,
                 nvtx_annotations: bool = False, clock=time.perf_counter):
        self._enabled = bool(enabled)
        self.max_events = int(max_events)
        self.nvtx_annotations = bool(nvtx_annotations)
        self._clock = clock
        self._epoch = clock()
        self._events: List[SpanEvent] = []
        self._local = threading.local()
        self.dropped = 0

    # -- span creation -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def span(self, name: str, **args) -> Union[Span, _NullSpan]:
        """Open a (nestable) span.  Disabled tracers return the shared
        no-op singleton — nothing is timed or recorded."""
        if not self._enabled:
            return NULL_SPAN
        return Span(self, name, args or None)

    # -- internals ---------------------------------------------------------
    def _thread_stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @staticmethod
    def _annotation(name: str):
        import torch

        if not torch.cuda.is_available():  # nvtx needs the CUDA runtime
            return None
        return torch.cuda.nvtx.range(name)

    def _record(self, span: Span) -> None:
        stack = self._thread_stack()
        if stack:
            stack.pop()
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(SpanEvent(
            name=span.name, t0_s=span.t0 - self._epoch,
            dur_s=span.t1 - span.t0, depth=span.depth,
            tid=threading.get_ident(),
            args=dict(span.args) if span.args else {}))

    # -- queries -----------------------------------------------------------
    def events(self, name: Optional[str] = None) -> List[SpanEvent]:
        """Finished spans in completion order (children before parents),
        optionally filtered by name."""
        if name is None:
            return list(self._events)
        return [e for e in self._events if e.name == name]

    def total_s(self, name: str) -> float:
        """Summed duration of every span named ``name`` — the reconciliation
        hook: phase span sums must match the legacy perf_counter totals."""
        return sum(e.dur_s for e in self._events if e.name == name)

    def summarize(self) -> Dict[str, Dict[str, float]]:
        """Per-name count/total/mean/min/max over the recorded spans."""
        acc: Dict[str, List[float]] = {}
        for e in self._events:
            acc.setdefault(e.name, []).append(e.dur_s)
        return {
            name: {"count": float(len(ds)), "total_s": sum(ds),
                   "mean_s": sum(ds) / len(ds),
                   "min_s": min(ds), "max_s": max(ds)}
            for name, ds in sorted(acc.items())}

    def clear(self) -> None:
        self._events = []
        self.dropped = 0
        self._epoch = self._clock()

    # -- export ------------------------------------------------------------
    def chrome_trace(self, *, pid: int = 1,
                     process_name: str = "repro_torch") -> Dict[str, Any]:
        """The Chrome ``traceEvents`` dict (``ph: "X"`` complete events, µs
        timestamps) — viewable in chrome://tracing or Perfetto."""
        tids: Dict[int, int] = {}
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name}}]
        for e in self._events:
            tid = tids.setdefault(e.tid, len(tids))
            ev: Dict[str, Any] = {
                "name": e.name, "cat": "repro_torch", "ph": "X", "pid": pid,
                "tid": tid, "ts": e.t0_s * 1e6, "dur": e.dur_s * 1e6}
            if e.args:
                ev["args"] = e.args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: Union[str, Path], **kw) -> Path:
        """Write ``chrome_trace()`` JSON to ``path`` (dirs created)."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.chrome_trace(**kw)))
        return p

    def __len__(self) -> int:
        return len(self._events)


# One shared disabled tracer: hot paths default to it so tracing is always
# written unconditionally (`with tracer.span(...)`) and costs ~a dict lookup
# when nobody is listening.
NULL_TRACER = Tracer(enabled=False)
