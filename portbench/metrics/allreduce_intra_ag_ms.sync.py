"""allreduce_intra_ag_ms.sync: device ms a sync step in the compressed
allreduce's intra allgather (the program's ``allreduce/intra_allgather``
ranges: the fast axis' allgather, the slice and the cast)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "allreduce/intra_allgather")
