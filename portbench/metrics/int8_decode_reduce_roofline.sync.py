"""int8_decode_reduce_roofline.sync: the int8 decode-reduces' share of
their roofline on the sync path, in percent: the frozen least time of
every decode-reduce launched in the traced steps
(``costs.block_decode_reduce_cost`` of its recorded shape) over their
kernels' device time in the trace."""
from portbench import costs, trace

KERNEL = "int8_decode_reduce"


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    least = sum(costs.bound_s(*costs.block_decode_reduce_cost(
        "int8", R, W, nb, length))
        for c, R, W, nb, length in tr["decodes"] if c == "int8")
    s, n = trace.kernel_s(tr["profile"], lambda k: KERNEL in k)
    return costs.share_pct(least, s) if n else None
