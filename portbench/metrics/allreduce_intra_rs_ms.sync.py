"""allreduce_intra_rs_ms.sync: device ms a sync step in the compressed
allreduce's intra reduce-scatter (the program's
``allreduce/intra_reduce_scatter`` ranges: the carried error added, the
padding, the fast axis' reduce-scatter)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "allreduce/intra_reduce_scatter")
