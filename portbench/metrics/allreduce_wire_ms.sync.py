"""allreduce_wire_ms.sync: device ms a sync step in the compressed
allreduce's two wire phases (the program's
``allreduce/wire_reduce_scatter`` ranges: encode, wire all-to-all,
decode-reduce; and ``allreduce/wire_allgather``: re-encode, wire
allgather, decode)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "allreduce/wire_reduce_scatter",
                           "allreduce/wire_allgather")
