"""Phase 15 of ``chip_smoke.py`` (one process per rank on the card) alone
on one card:

    python3 scripts/process_groups_phase.py                 # phase 15
    python3 scripts/process_groups_phase.py --two-process   # 8, then 15

Builds the kernels (one nvcc per source, all at once, ``ipc.cu`` among
them), then runs ``chip_smoke.process_groups_phase``: the parent's
``RankGrid(2, 4)`` results (its own 148 collective cases and sync step,
since phase 8 does not run here), eight one-rank workers for the
collectives, the groups, the full-width sync step and the serving run
under the gloo and the ``"shm"`` transport and the ``"shm"`` calibration
with its ``h100_ipc`` fit, and four workers of two ranks for qwen3-moe's
expert-parallel layer under both transports. Prints the phase's
``{"process_groups": ...}`` line (also written to
``build/process_groups.json``), then the card's name and power limit and
each path's kernel launches summed over the workers. With
``--two-process`` phase 8 (two workers of four ranks on
``make_process_grid()``) runs first, prints its ``{"two_process": ...}``
line and hands phase 15 its parent results, as ``chip_smoke.py`` does.
Needs one CUDA card.
"""
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        return cs.fail("no CUDA card")
    # the workers import chip_smoke by name
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention, codec, mamba, rwkv, staging
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.3f} s")
    parent, earlier = None, None
    if "--two-process" in sys.argv[1:]:
        from repro_torch.configs import get_config
        t0 = time.perf_counter()
        parent = {}
        two = cs.two_process_phase(torch, dev, get_config("smollm-360m"),
                                   codec, staging, keep=parent)
        print(json.dumps({"two_process": two}))
        print(f"two-process phase done ({time.perf_counter() - t0:.3f} s)")
        earlier = {"two_process": two}
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec, on_paths = cs.process_groups_phase(
        torch, dev, (codec, attention, rwkv, mamba, staging), parent=parent,
        earlier=earlier)
    print(json.dumps({"process_groups": rec}))
    (ROOT / "build" / "process_groups.json").write_text(json.dumps(rec))
    print(f"process-groups phase done ({time.perf_counter() - t0:.3f} s)")
    print(cs._smi("name,power.limit"))
    print(json.dumps({"process_groups_launches": on_paths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
