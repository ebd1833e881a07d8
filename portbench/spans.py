"""What the per-layer readers take from the program's own profiler ranges
(the spans of ``repro_torch.core.telemetry``, which become ranges of the
profiler's trace whenever a profiler records): the device time of the
kernels launched inside the ranges of some names, and how many ranges of
a kind a profiled step opened. A program without such a range (an older
one) gives nothing to read."""
from __future__ import annotations

from typing import Dict, Optional

from portbench import trace


def _profiled(run: Dict) -> Optional[Dict]:
    tr = run["trace"]
    return tr if tr and tr["busy_s"] else None


def device_ms(run: Dict, *names: str) -> Optional[float]:
    """Device ms a profiled step in the kernels launched inside the ranges
    named ``names`` (each kernel tied to its launch by correlation id, as
    :func:`portbench.trace.range_kernel_s` ties it; ranges of different
    names must not overlap); None where none of them was recorded."""
    tr = _profiled(run)
    if tr is None:
        return None
    got = [trace.range_kernel_s(tr["profile"], n) for n in names]
    got = [s for s in got if s is not None]
    return 1e3 * sum(got) / tr["steps"] if got else None


def count(run: Dict, prefix: str, present: str) -> Optional[float]:
    """Ranges a profiled step whose names start with ``prefix``; None where
    no range named ``present`` was recorded (a program without the
    ranges), else the count, which may be 0."""
    tr = _profiled(run)
    if tr is None:
        return None
    host = tr["profile"]["host"]
    if not any(n == present for n, _, _, _ in host):
        return None
    return sum(n.startswith(prefix) for n, _, _, _ in host) / tr["steps"]
