"""Collective telemetry: structured tracing, a metrics registry, and
cost-model drift detection for the Communicator stack (port of
``repro.core.telemetry``: the same names and semantics).

Three pieces, all **zero-overhead when disabled** (every recording site in
runtime/comm/train/serve guards on :func:`enabled`, a single module-global
read):

  1. **Tracer** — a bounded span ring buffer recording per-collective
     lifecycle events (plan resolution, build/exec cache hit-or-miss,
     persistent-op init/compile/start/wait/release, per-bucket windows of
     the gradient sync, serving ticks), tagged with the resolved plan
     ``(collective, algo, chunks, codec, group tag, size bucket)``
     (:func:`plan_tags`). :func:`export_chrome_trace` emits Chrome/Perfetto
     trace-event JSON (load it at ``ui.perfetto.dev`` or
     ``chrome://tracing``): compute and dispatch spans ride the ``main``
     track, each persistent op's start->wait window its own ``comm:*``
     track and each gradient bucket's window its own ``bucket:<i>`` track.
     Spans are stamped on the clock of ``torch.profiler``'s host events,
     nanoseconds of the Unix epoch (:func:`now`), so a span lines up with
     the profiler's kernels and gaps; a window closed by a blocking wait
     ends after the device result is ready.
  2. **Metrics registry** — process-wide counters and fixed-bucket
     histograms (host-side only; recording never inserts a device sync).
     :func:`snapshot` unifies ``runtime.cache_stats()``,
     ``runtime.selection_stats()`` and ``comm.live_persistent_ops()`` with
     the registry and the per-plan observations in one dict.
  3. **Drift detector** — :func:`observe_plan` accumulates per-plan
     wall-clock samples keyed on ``(topology, collective, dtype, size
     bucket, plan)``, each a full dispatch-to-ready window (a persistent
     ``wait(block=True)``, calibration loops that end in a device
     synchronize); :func:`drift_report` compares the observed medians
     with the Selector's measured tuning table and the
     ``costmodel.plan_cost`` prior, flagging plans whose observation
     diverges beyond a threshold. ``Selector.ingest(telemetry)``
     (``core.autotune``) closes the loop by folding observed medians back
     into the table as measured evidence.

**Profiler ranges.** :func:`span` also opens a ``torch.profiler`` range of
its name whenever a profiler records (``torch.autograd.profiler.
_is_profiler_enabled``) or telemetry is enabled, so the program's spans
appear in the profiler's own trace without :func:`enable` (which adds the
ring buffer, plan observations and the sampled error-feedback probe). With
neither on, :func:`span` returns the shared no-op context: the guard is one
global read and one attribute read. :func:`begin`/:func:`end` windows cross
frames and overlap one another, so they stay in the ring buffer only and
the profiler's ranges nest. The ranges, by the stage they time:

  ==================================  ======================================
  ``train/fwd_bwd``                   each held rank's forward, backward and
                                      gradient gather (``train_step``, the
                                      fused ``make_manual_train_step``)
  ``train/grad_sync``                 the fused step's gradient sync
  ``train/metric_sync``               its lossless loss and metric syncs
  ``train/optimizer``                 ``optim.adamw.update``
  ``sync/bucket``                     one bucket's sync call
                                      (``sync_tree_bucketed``,
                                      ``OverlappedGradSync.start``)
  ``allreduce/intra_reduce_scatter``  the compressed allreduce's phases
  ``allreduce/wire_reduce_scatter``   (``mcoll._compressed_allreduce``):
  ``allreduce/wire_allgather``        the carried-error add and the fast
  ``allreduce/intra_allgather``       axis' reduce-scatter; encode, wire
  ``allreduce/residual``              all-to-all, decode-reduce; re-encode,
                                      wire allgather, decode; the fast
                                      axis' allgather; both residuals
                                      placed into the new carry
  ``persistent/writeback``            a persistent op's copies into its own
                                      buffers (``PersistentOp.start``)
  ``moe/alltoall``                    each expert-parallel all-to-all,
                                      forward and backward
  ``host_read/<site>``                each blocking device-to-host read or
                                      synchronizing copy on a step's path
                                      (:func:`host_read`; also counted as
                                      ``host_reads.<site>``)
  ==================================  ======================================

The module imports only the standard library; torch's profiler is looked
up in ``sys.modules`` (never imported from here), and runtime/comm/autotune
(and ``torch.distributed`` for the process rank) are imported lazily inside
:func:`snapshot` / :func:`drift_report`, so every core module may import
this one without cycles.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# enablement: one module-global bool, read by every instrumentation site
# ---------------------------------------------------------------------------

_ENABLED = False
_DEFAULT_CAPACITY = 65536

_LOCK = threading.Lock()


def enabled() -> bool:
    """Whether instrumentation sites record (the hot-path guard)."""
    return _ENABLED


def enable(capacity: Optional[int] = None) -> None:
    """Turn the tracer + plan observation on. ``capacity`` resizes the span
    ring buffer (existing spans are kept up to the new bound)."""
    global _ENABLED, _SPANS
    with _LOCK:
        if capacity is not None and int(capacity) != _SPANS.maxlen:
            _SPANS = deque(_SPANS, maxlen=max(1, int(capacity)))
        _ENABLED = True


def disable() -> None:
    """Turn instrumentation off (recorded spans/metrics are kept until
    :func:`reset`)."""
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop every recorded span, metric, and plan observation (enablement
    is unchanged) — per-phase assertions start from zero after this."""
    global _DROPPED
    with _LOCK:
        _SPANS.clear()
        _DROPPED = 0
        _REGISTRY.reset()
        _PLAN_OBS.clear()
        _SAMPLE_COUNTERS.clear()
        _DEFERRED.clear()


# ---------------------------------------------------------------------------
# tracer: span ring buffer -> Chrome/Perfetto trace JSON
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed lifecycle window. ``start_ns`` and ``duration_ns`` are
    nanoseconds on the trace's clock (:func:`now`; ``start``, ``duration``
    and ``end`` give them in seconds, exported relative to the earliest
    span); ``track`` is the logical timeline lane (``"main"`` for
    compute/dispatch, ``"comm:*"`` for in-flight collective windows so
    concurrent buckets never overlap on one lane)."""

    name: str
    cat: str
    start_ns: int
    duration_ns: int
    track: str
    args: Tuple[Tuple[str, Any], ...]

    @property
    def start(self) -> float:
        return self.start_ns / 1e9

    @property
    def duration(self) -> float:
        return self.duration_ns / 1e9

    @property
    def end(self) -> float:
        return (self.start_ns + self.duration_ns) / 1e9


#: the trace's clock: ``torch.profiler`` stamps its host events in
#: nanoseconds of the Unix epoch
_clock_ns = time.time_ns


def now() -> float:
    """Seconds on the trace's clock, for a caller that times a window
    itself and hands it to :func:`emit`."""
    return _clock_ns() / 1e9


_SPANS: "deque[Span]" = deque(maxlen=_DEFAULT_CAPACITY)
_DROPPED = 0


def _emit(span: Span) -> None:
    global _DROPPED
    with _LOCK:
        if len(_SPANS) == _SPANS.maxlen:
            _DROPPED += 1
        _SPANS.append(span)


def _freeze_args(args: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(args.items()))


class _NoProfiler:
    """``torch.autograd.profiler`` until torch is loaded: no profiler
    records; the first read after torch is loaded binds the real module."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _PROFILER
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
        _PROFILER = mod
        return mod._is_profiler_enabled


#: the module whose ``_is_profiler_enabled`` says a profiler records
_PROFILER: Any = _NoProfiler()
#: the profiler range's context class, bound on first use
_RANGE: Any = None


def _range(name: str):
    """An unopened profiler range named ``name``; None where torch is not
    loaded."""
    global _RANGE
    if _RANGE is None:
        if "torch" not in sys.modules:
            return None
        try:
            from torch._C._profiler import _RecordFunctionFast as _RANGE
        except ImportError:  # an older torch
            from torch.profiler import record_function as _RANGE
    return _RANGE(name)


class _SpanCtx:
    """Context manager emitting one span on exit (enabled path only),
    inside a profiler range of its name."""

    __slots__ = ("name", "cat", "track", "args", "_t0", "_range")

    def __init__(self, name, cat, track, args):
        self.name, self.cat, self.track = name, cat, track
        self.args = args

    def __enter__(self):
        self._range = _range(self.name)
        if self._range is not None:
            self._range.__enter__()
        self._t0 = _clock_ns()
        return self

    def __exit__(self, *exc):
        t1 = _clock_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _emit(Span(self.name, self.cat, self._t0, t1 - self._t0, self.track,
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
    """``with telemetry.span("compile/allreduce", plan=...):`` — records a
    complete span on exit, inside a profiler range of its name. Disabled,
    it is the range alone while a profiler records (tags are the ring
    buffer's), else a shared no-op context (no allocation beyond the call
    itself)."""
    if _ENABLED:
        return _SpanCtx(name, cat, track, args)
    if _PROFILER._is_profiler_enabled:
        return _range(name)
    return _NULL_CTX


def host_read(site: str):
    """The span ``host_read/<site>`` of one blocking device-to-host read
    (or a copy that synchronizes), counted as ``host_reads.<site>`` in the
    registry whether or not anything records."""
    _REGISTRY.counter("host_reads." + site).inc()
    return span("host_read/" + site, cat="host_read")


def begin(name: str, cat: str = "", track: str = "main", **args
          ) -> Optional[tuple]:
    """Open a window that closes in a *different* call frame (persistent-op
    ``start`` -> ``wait``). Returns an opaque token for :func:`end`, or
    ``None`` when disabled (``end(None)`` is a no-op). Ring buffer only:
    such windows overlap, so they are no profiler ranges."""
    if not _ENABLED:
        return None
    return (name, cat, track, _freeze_args(args), _clock_ns())


def end(token: Optional[tuple]) -> None:
    """Close a :func:`begin` window and record its span."""
    if token is None:
        return
    name, cat, track, args, t0 = token
    _emit(Span(name, cat, t0, _clock_ns() - t0, track, args))


def emit(name: str, start: float, duration: float, cat: str = "",
         track: str = "main", **args) -> None:
    """Record a span whose window the caller timed itself (hot paths that
    read :func:`now` once and only build tags when enabled); ``start`` in
    seconds on the trace's clock."""
    if not _ENABLED:
        return
    _emit(Span(name, cat, round(start * 1e9), round(duration * 1e9), track,
               _freeze_args(args)))


def instant(name: str, cat: str = "", track: str = "main", **args) -> None:
    """A zero-duration marker (cache hit, release, rebind)."""
    if not _ENABLED:
        return
    _emit(Span(name, cat, _clock_ns(), 0, track, _freeze_args(args)))


def spans() -> List[Span]:
    """Snapshot of the recorded spans, oldest first."""
    with _LOCK:
        return list(_SPANS)


def spans_dropped() -> int:
    """Spans evicted from the ring buffer since the last :func:`reset`."""
    return _DROPPED


def plan_tags(collective: str, algo: str, chunks: int = 1,
              codec: str = "none", group: str = "",
              nbytes: Optional[int] = None) -> Dict[str, Any]:
    """The canonical span tag dict for one resolved plan — every layer tags
    its spans through this so trace queries see one schema."""
    tags: Dict[str, Any] = {"collective": collective, "algo": algo,
                            "chunks": int(chunks), "codec": codec or "none",
                            "group": group or ""}
    if nbytes is not None:
        tags["size_bucket"] = _bucket(int(nbytes))
    return tags


def export_chrome_trace(path=None) -> dict:
    """Render the span buffer as Chrome trace-event JSON (the format
    Perfetto and ``chrome://tracing`` load). Tracks become named threads of
    one process, whose ``pid`` is this process's rank in the
    ``torch.distributed`` process group (0 alone), so the traces of a
    launched run's processes load side by side; spans are complete events
    (``ph="X"``) with microsecond timestamps relative to the earliest
    recorded span, whose start on the trace's clock (ns of the Unix epoch,
    as ``torch.profiler`` stamps its host events) is ``otherData``'s
    ``epoch_ns``, so this file and the profiler's own trace line up when
    merged. Returns the dict; writes it to ``path`` when given."""
    recorded = spans()
    pid, _ = _process_rank()
    tracks: Dict[str, int] = {"main": 0}
    for s in recorded:
        tracks.setdefault(s.track, len(tracks))
    epoch = min((s.start_ns for s in recorded), default=0)
    events: List[dict] = [
        {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
         "args": {"name": track}}
        for track, tid in tracks.items()]
    for s in recorded:
        events.append({
            "name": s.name, "cat": s.cat or "repro", "ph": "X",
            "ts": (s.start_ns - epoch) / 1e3, "dur": s.duration_ns / 1e3,
            "pid": pid, "tid": tracks[s.track], "args": dict(s.args)})
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "otherData": {"spans_dropped": _DROPPED, "epoch_ns": epoch}}
    if path is not None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(trace))
    return trace


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


#: default histogram bounds: geometric 1 µs .. ~134 s (latencies in
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

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin, "max": self.vmax,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Named counters + histograms, created on first touch."""

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

    def to_dict(self) -> dict:
        return {"counters": {n: c.value
                             for n, c in sorted(self.counters.items())},
                "histograms": {n: h.summary()
                               for n, h in sorted(self.histograms.items())}}


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry (always live: registry writes are cheap
    host-side increments; only *tracing + plan observation* gate on
    :func:`enabled`)."""
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def histogram(name: str,
              bounds: Tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, bounds)


# ---------------------------------------------------------------------------
# per-plan latency observations (the drift detector's evidence)
# ---------------------------------------------------------------------------

_MAX_SAMPLES = 64


def _bucket(nbytes: int) -> int:
    # power-of-two ceiling, kept in lockstep with autotune.size_bucket
    # (this module stays stdlib-only at import time)
    return 1 << max(0, int(nbytes - 1).bit_length())


@dataclasses.dataclass
class PlanObservation:
    """Bounded wall-clock samples for one resolved plan on one topology.
    ``topo`` is the live (hashable, frozen) Topology so drift/ingest can
    re-enter ``plan_cost`` / ``table.record`` with the exact key."""

    topo: Any
    collective: str
    dtype: str
    nbytes: int
    plan: str
    samples: "deque[float]" = dataclasses.field(
        default_factory=lambda: deque(maxlen=_MAX_SAMPLES))

    def median(self) -> Optional[float]:
        if not self.samples:
            return None
        vals = sorted(self.samples)
        n = len(vals)
        mid = vals[n // 2] if n % 2 else (vals[n // 2 - 1]
                                          + vals[n // 2]) / 2.0
        return float(mid)


_PLAN_OBS: Dict[tuple, PlanObservation] = {}


def observe_plan(topo, collective: str, dtype: str, nbytes: int, plan: str,
                 seconds: float) -> None:
    """Record one wall-clock sample for a resolved plan (no-op when
    disabled): a full dispatch-to-ready window, taken only at boundaries
    that already end in a device wait — calibration timing loops and
    blocking persistent waits — never by inserting a new device sync."""
    if not _ENABLED:
        return
    dtype = str(dtype)
    key = (topo, collective, dtype, _bucket(int(nbytes)), plan)
    with _LOCK:
        obs = _PLAN_OBS.get(key)
        if obs is None:
            obs = _PLAN_OBS[key] = PlanObservation(
                topo, collective, dtype, int(nbytes), plan)
        obs.samples.append(float(seconds))
    _REGISTRY.histogram(
        f"plan.{collective}.{plan}.sync_seconds").observe(float(seconds))


def plan_observations() -> List[PlanObservation]:
    """Snapshot of the accumulated per-plan observations."""
    with _LOCK:
        return list(_PLAN_OBS.values())


# -- sampled codec-quality observations (EF carry / achieved ratio) ---------

_SAMPLE_COUNTERS: Dict[str, int] = {}
SAMPLE_EVERY = 16


def should_sample(key: str, every: int = SAMPLE_EVERY) -> bool:
    """Deterministic 1-in-``every`` sampler per key — the gate for
    observations that DO materialize device values (error-feedback carry
    inspection), so their cost is paid rarely and only when telemetry is
    on. A sample first records the deferred observations whose values
    have landed (:func:`defer`)."""
    if not _ENABLED:
        return False
    with _LOCK:
        n = _SAMPLE_COUNTERS.get(key, 0)
        _SAMPLE_COUNTERS[key] = n + 1
    if n % max(1, int(every)):
        return False
    _drain(block=False)
    return True


#: observations whose device values are still on their way to the host
_DEFERRED: "deque[Callable[[bool], bool]]" = deque()


def defer(observe: Callable[[bool], bool]) -> None:
    """Queue an observation whose device values are being copied to the
    host behind an event, so that taking it never waits on the device:
    ``observe(block)`` records it and returns True once the values have
    landed (waiting for them when ``block``), else returns False. Queued
    observations are recorded in order at the next sample and by
    :func:`snapshot`."""
    with _LOCK:
        _DEFERRED.append(observe)


def _drain(block: bool) -> None:
    """Record the deferred observations in order, up to the first whose
    values have not landed (all of them, waiting, with ``block``)."""
    while True:
        with _LOCK:
            if not _DEFERRED:
                return
            observe = _DEFERRED[0]
        if not observe(block):
            return
        with _LOCK:
            _DEFERRED.popleft()


def observe_ef_error(codec: str, rel_error: float, bound: float) -> None:
    """Record one sampled achieved-vs-bound relative error from an
    error-feedback carry: the residual magnitude relative to the reduced
    payload, next to the codec's stated bound."""
    _REGISTRY.histogram(f"codec.{codec}.ef_rel_error",
                        bounds=tuple(10.0 ** e for e in
                                     range(-12, 3))).observe(rel_error)
    if bound > 0.0 and rel_error > bound:
        _REGISTRY.counter(f"codec.{codec}.ef_bound_exceeded").inc()


def observe_codec_ratio(codec: str, ratio: float) -> None:
    """Record one achieved compression ratio (payload bytes / wire
    bytes)."""
    _REGISTRY.histogram(f"codec.{codec}.achieved_ratio",
                        bounds=tuple(float(2 ** i) / 4.0
                                     for i in range(10))).observe(ratio)


# ---------------------------------------------------------------------------
# snapshot: one dict for the scattered observables
# ---------------------------------------------------------------------------


def _process_rank() -> Tuple[int, int]:
    """(rank, world size) of the live ``torch.distributed`` process group —
    (0, 1) when none is initialized, so telemetry works in one process."""
    import torch.distributed as dist  # lazy: the module stays stdlib-only
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


def snapshot() -> dict:
    """Unified observability snapshot: cache stats, selection stats, live
    persistent ops, tracer occupancy, registry counters/histograms, and the
    per-plan observation medians.

    Observations are process-local; rows carry this process's rank (and the
    top level a ``process`` block) so rank-0 merges of multi-controller
    snapshots don't alias per-process plan latencies."""
    from repro_torch.core import autotune, comm, runtime  # lazy: no cycle
    _drain(block=True)
    cs = runtime.cache_stats()
    ss = runtime.selection_stats()
    rank, nprocs = _process_rank()
    with _LOCK:
        n_spans = len(_SPANS)
        obs = list(_PLAN_OBS.values())
    out = {
        "enabled": _ENABLED,
        "process": {"index": rank, "count": nprocs},
        "tracer": {"spans": n_spans, "dropped": _DROPPED,
                   "capacity": _SPANS.maxlen},
        "cache": {**dataclasses.asdict(cs),
                  "exec_hit_rate": cs.exec_hit_rate},
        "selection": {"prior": ss.prior, "measured": ss.measured,
                      "total": ss.total,
                      "measured_fraction": ss.measured_fraction,
                      "by_choice": {f"{c}/{a}": n for (c, a), n
                                    in sorted(ss.by_choice.items())}},
        "live_persistent_ops": comm.live_persistent_ops(),
        "plans": [{
            "topology": autotune.topo_key(o.topo),
            "collective": o.collective, "dtype": o.dtype,
            "size_bucket": _bucket(o.nbytes), "plan": o.plan,
            "samples": len(o.samples),
            "observed_median_s": o.median(),
            "rank": rank,
        } for o in obs],
    }
    out.update(_REGISTRY.to_dict())
    return out


# ---------------------------------------------------------------------------
# drift detection: observed medians vs table entries vs cost-model priors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftRow:
    """One plan's observation vs its two references. Signed relative
    drifts are ``(observed - reference) / reference``; ``flagged`` means
    the *measured-table* entry diverges beyond the threshold (the table is
    a promise about this machine — the model is only a prior, reported but
    flagged separately via ``model_flagged`` at its looser threshold)."""

    collective: str
    plan: str
    topology: str
    dtype: str
    size_bucket: int
    samples: int
    observed_s: float
    table_s: Optional[float]
    model_s: Optional[float]
    drift_vs_table: Optional[float]
    drift_vs_model: Optional[float]
    flagged: bool
    model_flagged: bool
    #: process rank the observations were taken on (0 single-process);
    #: merged multi-controller reports keep per-rank rows distinct
    rank: int = 0


def drift_report(selector=None, threshold: float = 0.5,
                 model_threshold: float = 10.0,
                 min_samples: int = 1) -> List[DriftRow]:
    """Compare observed per-plan medians against the
    selector's measured table and the cost-model prior.

    ``threshold=0.5`` flags a plan whose observed median and table entry
    disagree by more than 1.5x in either direction; ``model_threshold``
    applies the same rule against ``plan_cost`` (much looser: the analytic
    model is not a promise about host-CPU wall clock). Rows come back
    sorted worst-first by table drift magnitude."""
    from repro_torch.core import autotune  # lazy: no import cycle
    sel = selector if selector is not None else autotune.default_selector()
    rank, _ = _process_rank()
    rows: List[DriftRow] = []
    for o in plan_observations():
        if len(o.samples) < max(1, int(min_samples)):
            continue
        observed = o.median()
        if not observed or observed <= 0.0:
            continue
        entry = sel.table.lookup(o.topo, o.collective, o.dtype,
                                 o.nbytes) or {}
        table_s = entry.get(o.plan)
        model_s = autotune.predicted_seconds(o.collective, o.plan, o.topo,
                                             o.nbytes)
        drift_t = ((observed - table_s) / table_s
                   if table_s and table_s > 0.0 else None)
        drift_m = ((observed - model_s) / model_s
                   if model_s and model_s > 0.0 else None)

        def _diverged(drift, thresh):
            if drift is None:
                return False
            ratio = 1.0 + drift
            return max(ratio, 1.0 / ratio) > 1.0 + thresh
        rows.append(DriftRow(
            o.collective, o.plan, autotune.topo_key(o.topo), o.dtype,
            _bucket(o.nbytes), len(o.samples), observed, table_s, model_s,
            drift_t, drift_m,
            flagged=_diverged(drift_t, float(threshold)),
            model_flagged=_diverged(drift_m, float(model_threshold)),
            rank=rank))
    rows.sort(key=lambda r: abs(r.drift_vs_table or 0.0), reverse=True)
    return rows


def drifted_plans(selector=None, threshold: float = 0.5,
                  min_samples: int = 1) -> List[DriftRow]:
    """Just the flagged rows of :func:`drift_report`."""
    return [r for r in drift_report(selector, threshold=threshold,
                                    min_samples=min_samples) if r.flagged]
