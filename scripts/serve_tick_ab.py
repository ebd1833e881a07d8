"""Decode-tick host times of two or more source trees of the port, run in
alternation on one card.

    python3 scripts/serve_tick_ab.py TREE_A TREE_B [--model rwkv6-1.6b]
        [--rounds 4] [--out chiprun_out/serve_tick_ab.json]

Each TREE is a checkout of the repository (its ``src/repro_torch`` is
imported, its kernels are built under its own ``build/``). Round ``i``
runs every tree once, each in a fresh process, in the given order on even
rounds and reversed on odd ones (A B B A A B ...), so a drift of the host
over the call falls on both sides alike.

Each run serves the smoke test's serving workload at full width with
random weights from seed 0: 16 requests of 32 new tokens, prompts of 64 to
1024 tokens, ``Engine(max_batch=8, max_len=2048, mesh=RankGrid(2, 4))``
with the model's kernel flag. It serves the requests twice on one engine
and reports, per pass, the host-clock p50 of the decode tick (around
``Engine._decode_tick``, which ends in a device-to-host read) and of the
tick's token sync dispatch (around ``Engine._sync_tokens``, no device
wait), then the tick sync alone: the median host time of one
``op.start(tokens).wait()`` followed by a device synchronize, over 200
calls. Prints one JSON line per run and, last, the medians per tree; the
whole record goes to ``--out``. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

SEED = 0
BATCH, MAX_LEN = 8, 2048
REQUESTS, NEW, PROMPT = 16, 32, (64, 1024)
SYNC_CALLS = 200
FLAGS = {"smollm-360m": {"use_flash_decode": True},
         "rwkv6-1.6b": {"use_rwkv_kernel": True}}


def _timed(fn, into):
    def call(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        into.append(time.perf_counter() - t0)
        return out
    return call


def child(model_name: str) -> dict:
    """One run in this process: the tree is the ``repro_torch`` on the
    path."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.grid import RankGrid
    from repro_torch.models.decoder import DecoderLM, RunFlags
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config(model_name)
    model = DecoderLM(cfg, torch.Generator("cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT[0], PROMPT[1] + 1, size=REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, size=(int(n),), dtype=np.int32)
               for n in lens]
    eng = Engine(model, cfg, max_batch=BATCH, max_len=MAX_LEN,
                 flags=RunFlags(**FLAGS[model_name]), mesh=RankGrid(2, 4))
    passes = []
    for _ in range(2):
        tick_s, sync_s = [], []
        tick, sync = eng._decode_tick, eng._sync_tokens
        eng._decode_tick = _timed(tick, tick_s)
        eng._sync_tokens = _timed(sync, sync_s)
        torch.cuda.synchronize()
        done = eng.run([Request(prompt=p.copy(), max_new_tokens=NEW)
                        for p in prompts])
        torch.cuda.synchronize()
        eng._decode_tick, eng._sync_tokens = tick, sync
        if len(done) != REQUESTS:
            raise AssertionError(f"served {len(done)} of {REQUESTS}")
        passes.append({"ticks": len(tick_s),
                       "tick_p50_s": statistics.median(tick_s),
                       "sync_dispatch_p50_s": statistics.median(sync_s)})
    op = eng._sync_op
    alone = []
    with torch.inference_mode():
        tokens = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
        for _ in range(SYNC_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op.start(tokens).wait()
            torch.cuda.synchronize()
            alone.append(time.perf_counter() - t0)
    return {"model": model_name, "plan": op.plan, "passes": passes,
            "sync_alone_p50_s": statistics.median(alone)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--model", default="rwkv6-1.6b", choices=sorted(FLAGS))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out/serve_tick_ab.json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.model)))
        return 0
    if len(args.trees) < 2:
        ap.error("give two or more source trees")
    trees = [pathlib.Path(t).resolve() for t in args.trees]
    runs = []
    for i in range(args.rounds):
        for tree in (trees if i % 2 == 0 else trees[::-1]):
            env = {**os.environ, "PYTHONPATH": str(tree / "src")}
            proc = subprocess.run(
                [sys.executable, __file__, "--child", "--model", args.model],
                env=env, cwd=tree, capture_output=True, text=True)
            if proc.returncode:
                sys.stderr.write(proc.stderr)
                return proc.returncode
            rec = {"tree": str(tree), "round": i,
                   **json.loads(proc.stdout.strip().splitlines()[-1])}
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    summary = {}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == str(tree)]
        summary[str(tree)] = {
            f"pass{p}_{key}": statistics.median(r["passes"][p][key]
                                                for r in mine)
            for p in (0, 1) for key in ("tick_p50_s", "sync_dispatch_p50_s")}
        summary[str(tree)]["sync_alone_p50_s"] = statistics.median(
            r["sync_alone_p50_s"] for r in mine)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"model": args.model, "runs": runs,
                               "medians": summary}, indent=1))
    print(json.dumps({"medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
