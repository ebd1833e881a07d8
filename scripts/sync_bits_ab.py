"""The full-width compressed sync step's bits in two or more source trees of
the port, on one card:

    python3 scripts/sync_bits_ab.py TREE_A TREE_B [--codecs int8_block fp8_sim]

Each TREE is a checkout of the repository (a ``git archive`` of a commit
will do). For each tree, in a fresh process that imports that tree's
``chip_smoke.py`` and ``src/repro_torch``, and for each codec, it runs
``chip_smoke.tp_sync_step``: one bucketed ``pip_mcoll`` sync step with
error feedback of smollm-360m's 409,007,040 float32 gradients a rank on
``RankGrid(2, 4)`` (391 buckets of 4 MiB, each rank's row drawn from a
generator seeded by its rank), and keeps the int64 digest of every
bucket's output and new error per rank, the step's host seconds and the
codec kernels' launches. Prints one line a tree and codec, then whether
every digest of every tree equals the first tree's; exits 1 where one
differs. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys


def run_one(codec: str) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.kernels import codec as kcodec
    from repro_torch.models.params import param_shapes

    if not torch.cuda.is_available():
        raise SystemExit("sync_bits_ab: needs a CUDA card")
    budget = dict(cs.SYNC_CODECS)[codec]
    cs.TP_CODEC, cs.TP_BUDGET = codec, budget
    dev = torch.device("cuda", 0)
    total = sum(int(torch.Size(s).numel())
                for _, s in param_shapes(get_config("smollm-360m")))
    comm = Communicator(RankGrid(2, 4, dev))
    kcodec.reset_launches()
    out = cs.tp_sync_step(torch, comm, total)
    out["launches"] = {k: v for k, v in kcodec.launches.items() if v}
    out["card"] = cs._smi("name,power.limit")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--codecs", nargs="+", default=["int8_block",
                                                    "fp8_sim"])
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:  # the child: this process's tree is on sys.path
        print(json.dumps(run_one(args.one)))
        return 0
    runs = {}
    for tree in args.trees:
        root = pathlib.Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{root / 'src'}")
        for codec in args.codecs:
            proc = subprocess.run(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 tree, "--one", codec], env=env, capture_output=True,
                text=True, cwd=root)
            if proc.returncode:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[(tree, codec)] = rec
            print(json.dumps({"tree": tree, "codec": codec,
                              "seconds": rec["seconds"],
                              "buckets": rec["buckets"],
                              "launches": rec["launches"],
                              "card": rec["card"]}))
    same = all(runs[(t, c)]["out"] == runs[(args.trees[0], c)]["out"]
               and runs[(t, c)]["err"] == runs[(args.trees[0], c)]["err"]
               for t in args.trees for c in args.codecs)
    print(json.dumps({"bitwise": same, "trees": args.trees,
                      "codecs": args.codecs}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
