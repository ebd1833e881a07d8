"""device_idle.train: the share of a train step's wall time in which no
operation ran on the device, in percent: 1 - busy / wall, busy the union
of the profiler's device activity in a profiled step, wall the step of
the same run's untraced window (the profiler's own host work stretches
a profiled step, and that is not the program's idle time)."""
from portbench import trace


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["steps"] / trace.step_s(tr))
