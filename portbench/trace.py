"""What the traced run reads from ``torch.profiler``: the device's kernels
(name, start, duration), the host's operations and annotated ranges, and
from them the busy time, the idle gaps by what the host was doing, and
the kernels launched inside a named range.

The events are read straight from the profiler's own results, without
building its tables (which take minutes at tens of thousands of
launches). A trace that recorded no device activity gives a busy time of
0, and the readers that need one then report nothing.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: runtime calls whose correlation ids tie a host launch to its kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaLaunchCooperativeKernel")


def profile(torch, fn: Callable[[], None]) -> Dict:
    """``fn()`` once under ``torch.profiler`` (host and device activity),
    timed on the host clock from its call to the end of a synchronize.
    Returns ``{"wall_s", "kernels": [(name, start_ns, dur_ns, corr)],
    "host": [(name, start_ns, end_ns, corr)]}``."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    sync()
    prof.start()
    t0 = time.perf_counter()
    fn()
    sync()
    wall = time.perf_counter() - t0
    prof.stop()
    kernels, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        corr = e.correlation_id() if hasattr(e, "correlation_id") else 0
        if e.device_type() == cuda:
            kernels.append((e.name(), start, dur, corr))
        else:
            host.append((e.name(), start, start + dur, corr))
    return {"wall_s": wall, "kernels": kernels, "host": host}


def traced_window(torch, step, first: int, seconds: float, profiled: int,
                  sync, on_profile: Optional[Callable[[], None]] = None,
                  window: Optional[Callable[..., Dict]] = None) -> Dict:
    """The traced run's window: an untraced window of ``seconds``, the
    same as an untraced run's (``window``, the run's own
    :func:`portbench.window.run`), whose step time the shares divide by,
    since the profiler's own host work stretches a step of many launches;
    then ``profiled`` steps under :func:`profile` (``on_profile()`` called
    just before). Returns the record the per-layer readers take
    (``steps`` the profiled ones)."""
    from portbench import window as _window

    window = window if window is not None else _window.run
    untraced = window(step, sync, seconds, first=first)
    first += untraced["steps"]
    if on_profile is not None:
        on_profile()

    def steps():
        for k in range(profiled):
            step(first + k)

    prof = profile(torch, steps)
    return {"steps": profiled, "untraced": untraced, "profile": prof,
            "busy_s": busy_s(prof), "next_step": first + profiled,
            "window": {"steps": profiled, "window_s": prof["wall_s"],
                       "step_s": [prof["wall_s"] / profiled]},
            "device_ops": top_kernels(prof), "idle_gaps": idle_gaps(prof)}


def step_s(tr: Dict) -> float:
    """A step's seconds in a traced run: its untraced window's wall time
    over its steps, as :func:`portbench.window.per_step_ms` takes it."""
    return tr["untraced"]["window_s"] / tr["untraced"]["steps"]


def union_ns(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of ``(start, end)`` intervals, sorted and merged."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(tr: Dict) -> float:
    """Seconds in which some operation ran on the device."""
    spans = union_ns([(s, s + d) for _, s, d, _ in tr["kernels"]])
    return sum(e - s for s, e in spans) / 1e9


def kernel_s(tr: Dict, match: Callable[[str], bool]) -> Tuple[float, int]:
    """(seconds, launches) of the kernels whose name ``match`` accepts."""
    hits = [d for n, _, d, _ in tr["kernels"] if match(n)]
    return sum(hits) / 1e9, len(hits)


def top_kernels(tr: Dict, n: int = 10) -> List[List]:
    """The ``n`` kernels that took most device time: [[name, seconds]]."""
    tot: Dict[str, float] = {}
    for name, _, d, _ in tr["kernels"]:
        tot[name] = tot.get(name, 0.0) + d / 1e9
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:120], v] for k, v in top]


def _innermost(host_sorted, starts, t: int) -> Optional[str]:
    """The name of the host operation running at ``t`` that started last
    (the innermost one), looking back over at most 5000 operations."""
    i = bisect.bisect_right(starts, t) - 1
    stop = max(-1, i - 5000)
    while i > stop:
        name, s, e, _ = host_sorted[i]
        if e >= t:
            return name
        i -= 1
    return None


def idle_gaps(tr: Dict, n: int = 10, consider: int = 400) -> List[List]:
    """The device's idle gaps inside the traced window, summed by what the
    host was doing when each began (the innermost host operation then; the
    gaps before the first and after the last kernel count too):
    [[host operation, seconds]], the ``n`` largest sums over the
    ``consider`` longest gaps."""
    spans = union_ns([(s, s + d) for _, s, d, _ in tr["kernels"]])
    if not spans:
        return []
    host = sorted(tr["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    lo = min((h[1] for h in host), default=spans[0][0])
    hi = max((h[2] for h in host), default=spans[-1][1])
    gaps = []
    if spans[0][0] > lo:
        gaps.append((spans[0][0] - lo, lo))
    gaps += [(b[0] - a[1], a[1]) for a, b in zip(spans, spans[1:])
             if b[0] > a[1]]
    if hi > spans[-1][1]:
        gaps.append((hi - spans[-1][1], spans[-1][1]))
    gaps.sort(reverse=True)
    tot: Dict[str, float] = {}
    for length, at in gaps[:consider]:
        name = _innermost(host, starts, at) or "(no host operation)"
        tot[name] = tot.get(name, 0.0) + length / 1e9
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:120], v] for k, v in top]


def range_kernel_s(tr: Dict, label: str) -> Optional[float]:
    """Device seconds of the kernels launched inside the host ranges named
    ``label`` (``torch.profiler.record_function``): each kernel is tied to
    its launch by the correlation id, and a launch lies in a range when
    its start does. None when no range was recorded."""
    ranges = [(s, e) for n, s, e, _ in tr["host"] if n == label]
    if not ranges:
        return None
    ranges = union_ns(ranges)
    rstarts = [s for s, _ in ranges]
    inside = set()
    for name, s, _, corr in tr["host"]:
        if corr and any(c in name for c in LAUNCH_CALLS):
            i = bisect.bisect_right(rstarts, s) - 1
            if i >= 0 and ranges[i][0] <= s <= ranges[i][1]:
                inside.add(corr)
    return sum(d for _, _, d, c in tr["kernels"] if c in inside) / 1e9
