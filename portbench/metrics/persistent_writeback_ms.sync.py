"""persistent_writeback_ms.sync: device ms a sync step in the persistent
ops' copies of each result and new carried error into their own buffers
(the program's ``persistent/writeback`` ranges)."""
from portbench import spans


def read(run):
    return spans.device_ms(run, "persistent/writeback")
