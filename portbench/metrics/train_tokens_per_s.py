"""train_tokens_per_s: all tokens of the window's train steps over the
window's wall time (host clock; each step ends in a synchronize)."""
from portbench import window


def read(run):
    tr = run["traffic"]
    return window.rate(tr["batch"] * tr["seq_len"], run["window"])
