"""ep_alltoall_ms.train: device ms a train step in the kernels launched
inside the expert-parallel all-to-alls (the benchmark's profiler range
around each all-to-all of the MoE, forward and backward), from the trace
of the traced steps."""


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    s = tr.get("ranges", {}).get("ep_alltoall")
    return None if s is None else 1e3 * s / tr["steps"]
