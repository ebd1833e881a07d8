"""Quickstart: train a reduced Llama-family model for 100 steps,
checkpoint, and resume: the smallest end-to-end path through the stack.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs the training driver (``launch/train.py``) twice on one checkpoint
directory: 60 steps, saving every 25, then on to 100 from the latest
checkpoint. On the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import math
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        common = ["--arch", "smollm-360m", "--reduced", "--batch", "4",
                  "--seq", "64", "--ckpt-dir", d, "--ckpt-every", "25",
                  "--device", args.device]
        print("== phase 1: train 60 steps, checkpointing ==")
        first = train_main(common + ["--steps", "60"])
        print("== phase 2: resume from latest checkpoint, train to 100 ==")
        second = train_main(common + ["--steps", "100"])
    assert len(first) == 60 and len(second) == 40, (len(first),
                                                      len(second))
    assert all(math.isfinite(x) for x in first + second)
    print("quickstart OK")


if __name__ == "__main__":
    main()
