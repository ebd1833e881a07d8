"""int8_encode_roofline.sync: the int8 block encodes' share of their
roofline on the sync path, in percent: the frozen least time of every
encode launched in the traced steps (``costs.block_encode_cost`` of its
recorded shape, bytes over HBM or fp32 operations over their peak,
whichever is larger) over their kernels' device time in the trace."""
from portbench import costs, trace

KERNEL = "int8_block_encode"


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    least = sum(costs.bound_s(*costs.block_encode_cost("int8", S, L, e))
                for c, S, L, e in tr["encodes"] if c == "int8")
    s, n = trace.kernel_s(tr["profile"], lambda k: KERNEL in k)
    return costs.share_pct(least, s) if n else None
