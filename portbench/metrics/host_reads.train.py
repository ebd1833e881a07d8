"""host_reads.train: blocking device-to-host reads and synchronizing
copies a train step (the program's ``host_read/<site>`` ranges, counted
over the profiled steps; 0 is a reading, where the step has its
``train/fwd_bwd`` ranges)."""
from portbench import spans


def read(run):
    return spans.count(run, "host_read/", "train/fwd_bwd")
