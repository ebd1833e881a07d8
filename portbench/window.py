"""The measured window and its statistics.

A window runs whole steps back to back until ``seconds`` have passed on
the host clock. Each step is ended by a synchronize of the device, or,
where the mix sets ``ahead_steps``, up to that many steps are dispatched
ahead of the one waited for, so that the device stays fed while the host
stands still; when the time is up nothing more is sent, all that was sent
is waited for, and the clock is read after that wait. Its statistics are
taken over all of it: a rate is all the work of the window over all of its
time, and a percentile is over every step.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional


def run(step: Callable[[int], None], sync: Callable[[], None],
        seconds: float, first: int = 0, ahead: int = 0,
        mark: Optional[Callable[[], Any]] = None) -> Dict:
    """Steps ``first, first + 1, ...`` of ``step`` until ``seconds`` have
    passed. Returns ``{"step_s": [...], "window_s", "steps"}``.

    With ``ahead`` 0, each step is timed from its call to the end of its
    synchronize, and the window from its first call to the end of its
    last step. With ``ahead`` > 0, ``mark()`` after each step returns what
    marks its end on the device (an event with ``synchronize()``, or None
    where the device runs in the host's order), and after dispatching a
    step the host waits for the end of the step ``ahead`` before it; each
    step's time is the host clock from the previous step's end, as waited
    for, to its own (the first's from the window's start); once
    ``seconds`` have passed nothing more is dispatched, every step sent is
    waited for, and the window ends at the last wait."""
    times: List[float] = []
    sync()
    t0 = time.perf_counter()
    end = t0
    i = first
    if ahead <= 0:
        while True:
            s = time.perf_counter()
            step(i)
            sync()
            end = time.perf_counter()
            times.append(end - s)
            i += 1
            if end - t0 >= seconds:
                break
        return {"step_s": times, "window_s": end - t0, "steps": len(times)}
    pending: deque = deque()

    def wait_one():
        nonlocal end
        done = pending.popleft()
        if done is not None:
            done.synchronize()
        now = time.perf_counter()
        times.append(now - end)
        end = now

    while True:
        step(i)
        pending.append(mark() if mark is not None else None)
        i += 1
        if len(pending) > ahead:
            wait_one()
        if time.perf_counter() - t0 >= seconds:
            break
    while pending:
        wait_one()
    sync()
    end_all = time.perf_counter()
    if times:
        times[-1] += end_all - end
    return {"step_s": times, "window_s": end_all - t0, "steps": len(times)}


def per_step_ms(window: Dict) -> float:
    """The window's wall time over its whole steps, in ms."""
    return 1e3 * window["window_s"] / window["steps"]


def rate(work_per_step: float, window: Dict) -> float:
    """All the work of the window's steps over the window's wall time."""
    return work_per_step * window["steps"] / window["window_s"]


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values:
    the smallest value with at least ``q`` percent of them at or below
    it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]
