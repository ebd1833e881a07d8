"""End-to-end training driver with checkpoint/restart fault tolerance
(port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 200 --batch 8 --seq 128 --reduced --ckpt-dir /tmp/ckpt

It runs on the card unless ``--device cpu`` is given. The weights are
drawn from a seeded ``torch.Generator`` on that device. Fault tolerance:
periodic checkpoints (async unless ``--ckpt-blocking``) in the reference's
format; on start it resumes from the latest checkpoint when one exists
(the synthetic data is a pure function of the step, so the stream
resumes exactly). A step-time watchdog flags straggler steps (over
``--straggler-factor`` times the rolling median); here it logs.

On the card the run turns on PyTorch's deterministic algorithms (and
cuBLAS's fixed workspace), so a resumed run prints the uninterrupted
run's losses: the embedding's backward accumulates rows with atomics
otherwise. XLA, the reference's compiler, is deterministic by default.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointManager,
                                            load_train_state, train_state)
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.decoder import DecoderLM, RunFlags
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, train_step


def _batch(batch, cfg, device) -> dict:
    """A host batch on ``device``: tokens and labels int64, frames and
    embeddings bf16 (the reference casts them so)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.to(device, torch.bfloat16) if k in ("frames", "embeds")
                  else t.to(device, torch.long))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-blocking", action="store_true",
                    help="synchronous saves (deterministic tests)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--die-at-step", type=int, default=None,
                    help="failure injection: hard-exit at this step")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="where the weights and the steps live")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                             total_steps=args.steps)
    tcfg = TrainConfig(optimizer=ocfg, microbatches=args.microbatches,
                       flags=RunFlags(remat="none"))

    gen = torch.Generator(device).manual_seed(0)
    model = (EncDecLM if cfg.family == "encdec" else DecoderLM)(
        cfg, gen, device)
    flat = FlatParams.of(model)
    opt_state = adamw.init(flat, ocfg)

    data = SyntheticLM(
        cfg.vocab, args.seq, args.batch,
        frames_dim=cfg.d_model if cfg.family == "encdec" else None,
        embeds_len=args.seq // 4 if cfg.input_mode == "vl" else 0,
        embeds_dim=cfg.d_model if cfg.input_mode == "vl" else None)

    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        state = mgr.restore(start_step, train_state(flat, opt_state))
        load_train_state(flat, opt_state, state)
        print(f"[train] resumed from step {start_step}")

    times = []
    losses = []
    it = data.iterator(start_step)
    for step in range(start_step, args.steps):
        batch = _batch(next(it), cfg, device)
        t0 = time.time()
        metrics = train_step(model, opt_state, batch, tcfg, flat)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        times.append(dt)
        losses.append(loss)
        if len(times) > 8:
            med = float(np.median(times[-32:]))
            if dt > args.straggler_factor * med and step > start_step + 3:
                print(f"[watchdog] straggler step {step}: {dt:.3f}s "
                      f"(median {med:.3f}s)")
        if step % args.log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"({dt:.3f}s/step)", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, train_state(flat, opt_state),
                     blocking=args.ckpt_blocking)
        if args.die_at_step is not None and step == args.die_at_step:
            print(f"[train] injected failure at step {step}", flush=True)
            os._exit(42)

    if mgr is not None:
        mgr.save(args.steps, train_state(flat, opt_state), blocking=True)
        mgr.wait()
    print(f"[train] done. first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
