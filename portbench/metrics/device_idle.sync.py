"""device_idle.sync: the share of the profiled sync steps' time on the
device in which no operation ran, in percent: 1 - busy / span, busy the
union of the profiler's device activity, span from the first operation's
start to the last one's end. The window dispatches steps ahead, so the
card runs them back to back and the host's stalls show here only where
they outlast what is queued; the gaps before the first and after the last
profiled operation are the profiled steps' own start and end, which the
window does not have. (The window's step would be the wrong divisor: the
profiler stretches each kernel a little, and a card kept busy then reads
below zero.)"""


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    ks = tr["profile"]["kernels"]
    span_ns = max(s + d for _, s, d, _ in ks) - min(s for _, s, _, _ in ks)
    return 100.0 * (1.0 - tr["busy_s"] / (span_ns / 1e9))
