"""The controls of the cells' correctness checks, run apart from the
benchmark's own runs.

    python3 portbench/control.py --workload <name> --seeds 11 12 13

For each seed, the cell's plain reference computed one precision below
what the configuration states (the block codec one step down for a
gradient sync; every product in float8 e4m3 for a bf16 model) is put in
the program's place and judged as the program is. Prints one JSON line a
seed with each number beside the cell's limit, and whether the control
failed, as it has to, at least one of them. Runs at the configuration's
own size, on the card (``--device cpu`` and a test's small configuration
on the CPU).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run(name: str, seed: int, device, bench=None, config=None,
        traffic=None) -> dict:
    import torch

    from portbench import harness

    bench = bench if bench is not None else harness.benchmark()
    cell = harness.workload(bench, name)
    conf = harness.load_json("configs", cell["config"])
    tr = traffic or harness.load_json("traffic", cell["traffic"])
    limits = harness.load_json("limits", name)
    driver = harness.load_module("drivers", tr["driver"])
    ctx = types.SimpleNamespace(
        torch=torch, device=torch.device(device), seed=int(seed),
        cfg=config if config is not None else conf["model"],
        grid=conf["grid"], traffic=tr, hooks={})
    checks = harness.compare(driver.control(ctx), limits)
    return {"workload": name, "seed": int(seed),
            "control_failed": not all(c["ok"] for c in checks.values()),
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    ok = True
    for seed in args.seeds:
        rec = run(args.workload, seed, args.device)
        ok &= rec["control_failed"]
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
