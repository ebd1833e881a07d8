"""allreduce_residual_ms.sync: device ms a sync step in placing the
compressed allreduce's two residuals into the new carried error (the
program's ``allreduce/residual`` ranges: the zeroed buffer and the
index-puts)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "allreduce/residual")
