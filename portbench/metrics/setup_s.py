"""setup_s: seconds from the process's start to the measured window:
imports, weights and inputs drawn, the program's buffers and plans built,
its kernels built or loaded, and the warm-up steps (host clock)."""


def read(run):
    return run["setup_s"]
