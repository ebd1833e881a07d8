"""fwd_bwd_ms.train: device ms a train step in each rank's forward,
backward and gradient gather (the program's ``train/fwd_bwd`` ranges)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "train/fwd_bwd")
