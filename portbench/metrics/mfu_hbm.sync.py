"""mfu_hbm.sync: the whole sync step's share of the card's memory peak,
in percent: the frozen least bytes of a step (every rank reads its
gradient and its carried error and writes its result and its new error,
16 B a parameter a rank) over 3.35 TB/s, over the step of the traced
run's untraced window. It still bounds a gain where a kernel is taken
off the path."""
from portbench import costs, trace


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    least = costs.sync_least_bytes(tr["n_params"], tr["world"]) \
        / costs.HBM_BYTES_PER_S
    return costs.share_pct(least, trace.step_s(tr))
