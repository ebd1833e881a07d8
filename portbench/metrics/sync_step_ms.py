"""sync_step_ms: the window's wall time over its whole sync steps, in ms
(host clock; the window ends when every step it sent has ended)."""
from portbench import window


def read(run):
    return window.per_step_ms(run["window"])
