"""optimizer_ms.train: device ms a train step in the AdamW update (the
program's ``train/optimizer`` range: the clip's norm and the elementwise
passes over the flat float32 state)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "train/optimizer")
