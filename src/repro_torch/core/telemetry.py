"""Host-side tracing and metrics (the part of ``repro.core.telemetry`` the
serving engine uses).

  1. **Tracer** — a bounded ring buffer of spans, off by default. Every
     recording site guards on one module-global bool, so a disabled tracer
     costs a function call and a branch.
  2. **Metrics registry** — process-wide counters and fixed-bucket
     histograms, always live (host-side increments only; nothing here
     synchronises a device).

Plan observations, the drift report and the Chrome-trace export come with
the telemetry slice (ROADMAP.md, queue 1 item 4). Imports only the
standard library.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

_ENABLED = False
_DEFAULT_CAPACITY = 65536

_LOCK = threading.Lock()


def enabled() -> bool:
    """Whether recording sites record (the hot-path guard)."""
    return _ENABLED


def enable(capacity: Optional[int] = None) -> None:
    """Turn the tracer on. ``capacity`` resizes the span ring buffer
    (existing spans are kept up to the new bound)."""
    global _ENABLED, _SPANS
    with _LOCK:
        if capacity is not None and int(capacity) != _SPANS.maxlen:
            _SPANS = deque(_SPANS, maxlen=max(1, int(capacity)))
        _ENABLED = True


def disable() -> None:
    """Turn recording off (recorded spans and metrics are kept until
    :func:`reset`)."""
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop every recorded span and metric (enablement is unchanged)."""
    with _LOCK:
        _SPANS.clear()
        _REGISTRY.reset()


# ---------------------------------------------------------------------------
# tracer: span ring buffer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed window. ``start`` is ``time.perf_counter`` seconds;
    ``track`` is the logical timeline lane (``"main"`` for compute and
    dispatch, ``"comm:*"`` for in-flight collective windows)."""

    name: str
    cat: str
    start: float
    duration: float
    track: str
    args: Tuple[Tuple[str, Any], ...]

    @property
    def end(self) -> float:
        return self.start + self.duration


_SPANS: "deque[Span]" = deque(maxlen=_DEFAULT_CAPACITY)


def _emit(span: Span) -> None:
    with _LOCK:
        _SPANS.append(span)


def _freeze_args(args: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(args.items()))


class _SpanCtx:
    """Context manager emitting one span on exit (enabled path only)."""

    __slots__ = ("name", "cat", "track", "args", "_t0")

    def __init__(self, name, cat, track, args):
        self.name, self.cat, self.track = name, cat, track
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _emit(Span(self.name, self.cat, self._t0,
                   time.perf_counter() - self._t0, self.track,
                   _freeze_args(self.args)))
        return False


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


def span(name: str, cat: str = "", track: str = "main", **args):
    """``with telemetry.span("serve/prefill", slot=3):`` records a complete
    span on exit. Disabled: returns a shared no-op context."""
    if not _ENABLED:
        return _NULL_CTX
    return _SpanCtx(name, cat, track, args)


def emit(name: str, start: float, duration: float, cat: str = "",
         track: str = "main", **args) -> None:
    """Record a span whose window the caller timed itself (hot paths that
    read ``perf_counter`` once and only build tags when enabled)."""
    if not _ENABLED:
        return
    _emit(Span(name, cat, float(start), float(duration), track,
               _freeze_args(args)))


def spans() -> List[Span]:
    """Snapshot of the recorded spans, oldest first."""
    with _LOCK:
        return list(_SPANS)


# ---------------------------------------------------------------------------
# metrics registry: counters + fixed-bucket histograms
# ---------------------------------------------------------------------------


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


#: default histogram bounds: geometric 1 us .. ~134 s (latencies in
#: seconds); values beyond the last bound land in the overflow bucket
LATENCY_BUCKETS = tuple(1e-6 * 2.0 ** i for i in range(28))


class Histogram:
    """Fixed-bucket histogram: O(len(bounds)) per observe, no allocation.
    Quantiles interpolate within the landing bucket and clamp to the
    observed min/max, so p50/p99 stay meaningful at small counts."""

    __slots__ = ("name", "bounds", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, name: str = "",
                 bounds: Tuple[float, ...] = LATENCY_BUCKETS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if not self.count:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            lo = self.bounds[i - 1] if i > 0 else 0.0
            hi = self.bounds[i] if i < len(self.bounds) else self.vmax
            if seen + c >= rank:
                frac = max(0.0, min(1.0, (rank - seen) / c))
                est = lo + (hi - lo) * frac
                return max(self.vmin, min(self.vmax, est))
            seen += c
        return self.vmax


class MetricsRegistry:
    """Named counters and histograms, created on first touch."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def histogram(self, name: str,
                  bounds: Tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, bounds)
        return h

    def reset(self) -> None:
        self.counters.clear()
        self.histograms.clear()


_REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def histogram(name: str,
              bounds: Tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, bounds)
