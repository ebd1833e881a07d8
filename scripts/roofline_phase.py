"""Phase 14 of ``chip_smoke.py`` (the roofline on the card) alone on one
card:

    python3 scripts/roofline_phase.py

Builds the kernels (one nvcc per source, all at once), then runs (a) the
counted and timed one-device train steps, (b) the counted and timed
serving ticks with the flash-decode and WKV6 kernels, (c) two dry-run
cells on ``meta``, (d) the three examples; prints the phase's
``{"roofline_train": ...}``, ``{"roofline_tick": ...}``,
``{"roofline_dryrun": ...}`` and ``{"roofline_examples": ...}`` lines,
then the card's name and power limit and each
path's kernel launches. Needs one CUDA card.
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
    from repro_torch.kernels import (_build, attention, codec, mamba, rwkv,
                                     staging)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    out = cs.roofline_phase(torch, dev,
                            (codec, attention, rwkv, mamba, staging))
    print(cs._smi("name,power.limit"))
    print(json.dumps({"roofline_launches": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
