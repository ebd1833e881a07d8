"""grad_sync_ms.train: device ms a fused train step in the bucketed
gradient sync (the program's ``train/grad_sync`` range)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "train/grad_sync")
