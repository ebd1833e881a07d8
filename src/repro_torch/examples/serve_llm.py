"""Serve a reduced model with continuous batching: 12 requests with varied
prompt lengths stream through a 4-slot engine.

  PYTHONPATH=src python -m repro_torch.examples.serve_llm [--device cpu]

The weights are drawn from a seeded ``torch.Generator`` on the device (the
card unless ``--device cpu`` is given).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.models.decoder import DecoderLM
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = reduced_config("qwen1.5-4b")
    model = DecoderLM(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    engine = Engine(model, cfg, max_batch=4, max_len=96)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(int(n),),
                                        dtype=np.int32),
                    max_new_tokens=8)
            for n in rng.integers(4, 24, size=12)]
    done = engine.run(reqs)
    for i, r in enumerate(done):
        print(f"req{i:02d} prompt_len={len(r.prompt):3d} -> {r.out_tokens}")
    assert len(done) == len(reqs) and all(len(r.out_tokens) >= 8
                                          for r in done)
    print("serve_llm OK")


if __name__ == "__main__":
    main()
