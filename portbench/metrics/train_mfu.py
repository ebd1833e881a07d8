"""train_mfu: the whole train step's share of the card's dense bf16
peak, in percent: the frozen model FLOPs of a step
(``costs.train_step_flops``) over the step of the traced run's
untraced window and 989.4 TFLOP/s."""
from portbench import costs, trace


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    t = run["traffic"]
    flops = costs.train_step_flops(run["cfg"], t["batch"], t["seq_len"])
    return costs.share_pct(flops / costs.BF16_FLOP_PER_S, trace.step_s(tr))
