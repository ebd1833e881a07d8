"""Phase 13 of ``chip_smoke.py`` (sharded training) alone on one card:

    python3 scripts/sharded_train_phase.py

(a) the expert-parallel MoE's backward, (b) the sharded train step at
full width, (c) checkpoints and the training driver; prints the phase's
``{"ep_backward": ...}``, ``{"sharded_train": ...}`` and
``{"train_driver": ...}`` lines, then the card's name and power limit and
each path's kernel launches. Builds no kernel: the phase launches none.
Needs one CUDA card.
"""
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        return cs.fail("no CUDA card")
    from repro_torch.kernels import attention, codec, mamba, rwkv, staging
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = cs.sharded_train_phase(torch, dev,
                                 (codec, attention, rwkv, mamba, staging))
    print(cs._smi("name,power.limit"))
    print(json.dumps({"sharded_launches": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
