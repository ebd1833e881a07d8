"""moe_alltoall_ms.train: device ms a train step in the expert-parallel
all-to-alls, forward and backward (the program's ``moe/alltoall``
ranges), the same work ``ep_alltoall_ms.train`` times from the
benchmark's own ranges."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "moe/alltoall")
