"""MetricsRegistry — counters, gauges, histograms, and the ``metrics/v1``
report section.

Every runtime subsystem publishes into one of these: the
``DataParallelTrainer`` (per-phase step times, per-bucket comm, overlap
fraction), the serving ``Engine``/``BatchScheduler`` (prefill/decode
latency, tokens/s, queue depth), and the ``Session.tune`` calibration loop.
``MetricsRegistry.section()`` renders the registry as the
``repro.api/metrics/v1`` dict that ``Session.train/serve/bench`` attach
under ``measured["metrics"]`` — checked by ``validate_report`` via
:func:`validate_metrics`, so every Report carries its own telemetry.

Conventions: metric names are ``area/quantity_unit`` (``train/compute_s``,
``serve/decode_s``, ``serve/queue_depth``); durations are seconds.
Histograms keep exact ``count/sum/min/max`` and a bounded reservoir sample
for the p50/p95/p99 quantiles (deterministic reservoir replacement, so CI
artifacts are reproducible).

Stdlib-only on purpose: it must stay importable without a backend.  The
section keeps the ``repro.api/metrics/v1`` schema id, so a port run's
metrics validate with the same check as the JAX package's.
"""
from __future__ import annotations

import math
import random
from typing import Any, Dict, List

__all__ = ["METRICS_SCHEMA_ID", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "percentile", "validate_metrics"]

METRICS_SCHEMA_ID = "repro.api/metrics/v1"

# every histogram entry in a metrics/v1 section carries exactly these
HISTOGRAM_KEYS = ("count", "sum", "min", "max", "mean", "p50", "p95", "p99")


def percentile(values: List[float], p: float) -> float:
    """Linear-interpolated percentile (``p`` in [0, 100]) of ``values``
    (need not be sorted).  Matches ``numpy.percentile``'s default."""
    if not values:
        raise ValueError("percentile of empty sequence")
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"p must be in [0, 100], got {p}")
    xs = sorted(values)
    rank = (p / 100.0) * (len(xs) - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return float(xs[int(rank)])
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


class Counter:
    """Monotonic count (events, tokens, steps)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (overlap fraction, tokens/s)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus a bounded
    reservoir for quantiles.  Up to ``max_samples`` observations the
    quantiles are exact; past it, classic reservoir sampling (seeded, so
    summaries are reproducible) keeps a uniform sample."""

    __slots__ = ("count", "sum", "min", "max", "max_samples", "_samples",
                 "_rng")

    def __init__(self, max_samples: int = 4096, seed: int = 0):
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.max_samples = max_samples
        self._samples: List[float] = []
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._samples) < self.max_samples:
            self._samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.max_samples:
                self._samples[j] = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, p: float) -> float:
        if not self._samples:
            raise ValueError("quantile of empty histogram")
        return percentile(self._samples, p)

    def summary(self) -> Dict[str, float]:
        """The metrics/v1 histogram entry (raises on an empty histogram —
        empty histograms are skipped at section time instead)."""
        return {"count": int(self.count), "sum": self.sum,
                "min": self.min, "max": self.max, "mean": self.mean,
                "p50": self.quantile(50), "p95": self.quantile(95),
                "p99": self.quantile(99)}


class MetricsRegistry:
    """Get-or-create named counters/gauges/histograms + the section dump."""

    def __init__(self, *, hist_max_samples: int = 4096):
        self._hist_max_samples = hist_max_samples
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- get-or-create -----------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                max_samples=self._hist_max_samples)
        return h

    # -- one-line publishing (the hot-path spelling) -----------------------
    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # -- export ------------------------------------------------------------
    def section(self) -> Dict[str, Any]:
        """The ``repro.api/metrics/v1`` dict (empty histograms skipped)."""
        return {
            "schema": METRICS_SCHEMA_ID,
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self._histograms.items())
                           if h.count},
        }


# ---------------------------------------------------------------------------
# Schema check (hand-rolled: no jsonschema in image)
# ---------------------------------------------------------------------------


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"invalid metrics/v1 section: {msg}")


def _num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_metrics(m: Any) -> Dict[str, Any]:
    """Raise ValueError unless ``m`` is a valid metrics/v1 dict; returns it.

    Checks the schema id, section shapes, counter monotonicity (>= 0), and
    per-histogram internal consistency (count >= 1, required keys,
    min <= p50 <= p95 <= p99 <= max)."""
    _require(isinstance(m, dict), f"expected dict, got {type(m).__name__}")
    _require(m.get("schema") == METRICS_SCHEMA_ID,
             f"schema {m.get('schema')!r} != {METRICS_SCHEMA_ID!r}")
    for sect in ("counters", "gauges", "histograms"):
        _require(sect in m, f"missing section {sect!r}")
        _require(isinstance(m[sect], dict), f"{sect} must be a dict")
    for name, v in m["counters"].items():
        _require(_num(v) and v >= 0, f"counter {name!r} must be >= 0, "
                 f"got {v!r}")
    for name, v in m["gauges"].items():
        _require(_num(v), f"gauge {name!r} must be numeric, got {v!r}")
    eps = 1e-12
    for name, h in m["histograms"].items():
        _require(isinstance(h, dict), f"histogram {name!r} must be a dict")
        for key in HISTOGRAM_KEYS:
            _require(key in h, f"histogram {name!r} missing {key!r}")
            _require(_num(h[key]), f"histogram {name!r}.{key} must be "
                     f"numeric, got {h[key]!r}")
        _require(h["count"] >= 1, f"histogram {name!r}.count must be >= 1")
        _require(h["min"] <= h["p50"] + eps <= h["p95"] + 2 * eps
                 <= h["p99"] + 3 * eps <= h["max"] + 4 * eps,
                 f"histogram {name!r} quantiles out of order: "
                 f"min={h['min']} p50={h['p50']} p95={h['p95']} "
                 f"p99={h['p99']} max={h['max']}")
    return m
