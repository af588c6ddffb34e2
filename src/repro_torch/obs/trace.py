"""Tracer — nestable wall-clock spans, bridged into ``torch.profiler``.

The paper's whole method is *measure, then configure*: Lemma 3.1/3.2 only
pay off when step time, comm time, and overlap are observable quantities.
``Tracer`` is the one clock the port's hot paths share:

- ``with tracer.span("dist_update") as sp: ...`` times a phase; the span's
  ``elapsed_s`` is exactly a ``perf_counter()`` pair, so the values that
  feed ``SyncReport`` / ``GenResult.stats()`` are measured the same way
  they always were — the span *additionally* lands in the tracer's event
  log.
- Spans nest (``span("step")`` around ``span("bucket_sync", bucket=i)``);
  the recorded depth/intervals reconstruct the phase tree offline.
- An enabled tracer brackets every span with
  ``torch.profiler.record_function(name)``: while ``torch.profiler`` records
  on the span's thread (the thread that started it, and the autograd
  engine's threads during a backward pass), the span is a
  ``user_annotation`` event of its Chrome trace, on the profiler's clock
  and on the thread that opened it, so the device's kernels can be joined
  to the span their launch fell in.  Threads the program starts itself
  (the loader's producer, the trainer's communication thread) are not
  followed by the profiler: their spans are in the tracer's log alone.
- ``count(name, value)`` adds to a counter while the tracer is enabled
  (a device tensor stays on its device), and ``counts()`` reads and
  clears them once, after the steps it covers.
- ``chrome_trace()`` / ``save()`` export the tracer's own log as Chrome
  ``traceEvents`` JSON (load in ``chrome://tracing`` or Perfetto).
- A *disabled* tracer is free: ``span()`` returns a shared no-op singleton
  (no event, no allocation that survives the call), so library code can
  trace unconditionally.
- :data:`PROFILER_TRACER` records no event of its own: its spans are
  ``record_function`` brackets that open only while ``torch.profiler``
  records on the calling thread, and the shared no-op otherwise.  Steps
  and loaders built without a tracer use it, so a profile of them carries
  the program's phase names with no flag.
- :func:`current` is the process's current tracer (:data:`NULL_TRACER`
  unless a step set one with :func:`use`): the model's code reads it, so
  its functions take no tracer argument.  It is process-wide, not per
  thread, because block remat's recompute and the whole backward pass run
  on the autograd engine's thread.
- A span times host wall clock only.  Callers whose span covers device
  work end it after a host sync (a ``.cpu()`` of the result or
  ``torch.cuda.synchronize()``), so the span length is the measurement.

Import-light by design: stdlib only, and torch only once an enabled span
opens (a disabled tracer never imports it), so the rest of
``repro_torch.obs`` is usable without a backend.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

__all__ = ["Span", "SpanEvent", "Tracer", "NULL_TRACER", "PROFILER_TRACER",
           "current", "use", "monotonic"]


def monotonic() -> float:
    """The package's sanctioned monotonic clock — the same clock ``Tracer``
    spans run on.  Measured paths that need a raw timestamp (rather than
    a span) read time through here, so this module stays the *only* place
    in ``repro_torch`` that touches ``time`` directly."""
    return time.perf_counter()


def _annotation(name: str):
    """An entered ``torch.profiler.record_function(name)``."""
    from torch.profiler import record_function

    ann = record_function(name)
    ann.__enter__()
    return ann


def _profiling() -> bool:
    """Whether ``torch.profiler`` records on the calling thread (never
    without torch loaded)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


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


class _ProfilerSpan:
    """A ``record_function`` bracket and nothing else: a span of
    :data:`PROFILER_TRACER`, opened while the profiler records."""

    __slots__ = ("name", "_ann")
    elapsed_s = 0.0

    def __init__(self, name: str):
        self.name = name
        self._ann = None

    def __enter__(self) -> "_ProfilerSpan":
        self._ann = _annotation(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        self._ann.__exit__(*exc)
        self._ann = None
        return False


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
        self._ann = _annotation(self.name)
        self.t0 = tr._clock()  # last: the annotation stays untimed
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = self.tracer._clock()  # first: recording stays untimed
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
                 clock=time.perf_counter):
        self._enabled = bool(enabled)
        self.max_events = int(max_events)
        self._clock = clock
        self._epoch = clock()
        self._events: List[SpanEvent] = []
        self._local = threading.local()
        self._counts: Dict[str, Any] = {}
        self._counts_lock = threading.Lock()
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

    def count(self, name: str, value) -> None:
        """Add ``value`` (a number, or a tensor left on its device: no
        synchronize) to counter ``name``; a disabled tracer counts
        nothing."""
        if not self.enabled:
            return
        with self._counts_lock:  # ranks in threads share one tracer
            prev = self._counts.get(name)
            self._counts[name] = value if prev is None else prev + value

    def counts(self) -> Dict[str, float]:
        """Every counter as a float (one read of the device each), and
        the counters cleared."""
        with self._counts_lock:
            counts, self._counts = self._counts, {}
        return {k: float(v) for k, v in sorted(counts.items())}

    # -- internals ---------------------------------------------------------
    def _thread_stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

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

    def clear(self) -> None:
        self._events = []
        with self._counts_lock:
            self._counts = {}
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


class _ProfilerTracer(Tracer):
    """:data:`PROFILER_TRACER`'s class: enabled exactly while
    ``torch.profiler`` records on the calling thread; its spans are
    ``record_function`` brackets and land in no log of its own."""

    def __init__(self):
        super().__init__(enabled=False, max_events=0)

    @property
    def enabled(self) -> bool:
        return _profiling()

    def span(self, name: str, **args) -> Union[_ProfilerSpan, _NullSpan]:
        return _ProfilerSpan(name) if _profiling() else NULL_SPAN


# One shared disabled tracer: hot paths default to it so tracing is always
# written unconditionally (`with tracer.span(...)`) and costs ~a dict lookup
# when nobody is listening.
NULL_TRACER = Tracer(enabled=False)
# The tracer of a step or loader built without one: its spans exist only in
# a running torch.profiler's trace.
PROFILER_TRACER = _ProfilerTracer()

_current: Tracer = NULL_TRACER
_users = 0
_lock = threading.Lock()


def current() -> Tracer:
    """The process's current tracer: the one a running step set with
    :func:`use`, else :data:`NULL_TRACER`."""
    return _current


class use:
    """``with use(tracer):`` makes ``tracer`` the process's current tracer
    until the block ends.  Overlapping blocks (the ranks of an all-ranks
    trainer, one thread each) share the first block's tracer until the
    last of them ends."""

    __slots__ = ("tracer",)

    def __init__(self, tracer: Tracer):
        self.tracer = tracer

    def __enter__(self) -> Tracer:
        global _current, _users
        with _lock:
            if not _users:
                _current = self.tracer
            _users += 1
            return _current

    def __exit__(self, *exc) -> bool:
        global _current, _users
        with _lock:
            _users -= 1
            if not _users:
                _current = NULL_TRACER
        return False
