"""grid_device_ms.sync: device ms a sync step in kernels other than the
codec and staging kernels (the grid primitives' torch operations), from
the profiler's trace of the traced steps."""
from portbench import trace

OWN = ("block_encode", "decode_reduce", "fp8_encode", "shift_blocks",
       "pack_blocks")


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    s, n = trace.kernel_s(tr["profile"],
                          lambda k: not any(o in k for o in OWN))
    return 1e3 * s / tr["steps"] if n else None
