"""Peak device memory and the bits of a local ``train_step`` in two or
more source trees of the port, run in alternation on one card.

    python3 scripts/train_peak.py TREE_A TREE_B [--arch smollm-360m]
        [--layers 0] [--steps 2] [--rounds 2]
        [--out chiprun_out/train_peak.json]

Each TREE is a checkout of the repository (its ``src/repro_torch`` is
imported). Round ``i`` runs every tree once, each in a fresh process, in
the given order on even rounds and reversed on odd ones (A B B A ...).

A run builds ``--arch`` at full width (cut to its first ``--layers``
layers when given) with bf16 weights from seed 0 on the card, AdamW at a
constant 1e-4 over flat float32 buffers, and takes ``--steps`` calls of
``train_step`` on one device (no grid: the local MoE) on the step-0 batch
of ``SyntheticLM(vocab, 512, 8, seed=0)``. It prints one JSON line: the
peak device memory after each step (``max_memory_allocated`` from a reset
before the first), each step's host seconds around a synchronize, the
losses, and the sha256 of the weights, ``m`` and ``v`` after the last
step; a run that runs out of device memory reports where. Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

SEED = 0
BATCH, SEQ, LR = 8, 512, 1e-4


def _sha(tensors) -> str:
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def run_one(arch: str, layers: int, steps: int) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_peak: needs a CUDA card")
    from repro_torch.configs import first_layers, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.decoder import DecoderLM, RunFlags
    from repro_torch.models.params import FlatParams
    from repro_torch.optim import adamw
    from repro_torch.train.step import TrainConfig, train_step

    cfg = get_config(arch)
    if layers:
        cfg = first_layers(cfg, layers)
    dev = torch.device("cuda", 0)
    model = DecoderLM(cfg, torch.Generator("cuda").manual_seed(SEED))
    flat = FlatParams.of(model)
    ocfg = adamw.AdamWConfig(lr=LR, schedule="constant", warmup_steps=0)
    opt = adamw.init(flat, ocfg)
    tcfg = TrainConfig(optimizer=ocfg, flags=RunFlags(remat="none"))
    host = SyntheticLM(cfg.vocab, SEQ, BATCH, seed=0).batch(0)
    batch = {k: torch.from_numpy(v).to(dev).long() for k, v in host.items()}
    out = {"arch": arch, "layers": cfg.n_layers, "params": flat.n,
           "tokens": [BATCH, SEQ], "peak_bytes": [], "step_s": [],
           "losses": []}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            mets = train_step(model, opt, batch, tcfg, flat)
            out["losses"].append(float(mets["loss"]))
            torch.cuda.synchronize(dev)
            out["step_s"].append(time.perf_counter() - t0)
            out["peak_bytes"].append(torch.cuda.max_memory_allocated(dev))
    except torch.OutOfMemoryError as e:
        out["out_of_memory"] = str(e).splitlines()[0][:200]
        out["peak_bytes"].append(torch.cuda.max_memory_allocated(dev))
        return out
    out["sha256"] = {"weights": _sha(flat.tensors), "m": _sha([opt["m"]]),
                     "v": _sha([opt["v"]])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/train_peak.json")
    ap.add_argument("--one", action="store_true",
                    help="run once in this process (the tree on sys.path)")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.arch, args.layers, args.steps)))
        return 0
    runs = []
    for i in range(args.rounds):
        order = args.trees if i % 2 == 0 else args.trees[::-1]
        for tree in order:
            src = pathlib.Path(tree).resolve() / "src"
            env = dict(os.environ, PYTHONPATH=str(src))
            proc = subprocess.run(
                [sys.executable, __file__, "--one", "--arch", args.arch,
                 "--layers", str(args.layers), "--steps", str(args.steps)],
                env=env, capture_output=True, text=True, timeout=1200)
            if proc.returncode:
                print(proc.stderr[-3000:], file=sys.stderr)
                return proc.returncode
            rec = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                       tree=tree, round=i)
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
