"""Phase 1's codec part of ``chip_smoke.py`` alone on one card:

    python3 scripts/codec_phase.py [--parent DIR]

Builds the three codec libraries (one nvcc per source, all at once),
holds every codec kernel bitwise against its plain version at phase 1's
cases, and times each encode and decode-reduce kernel at the main path's
shapes (CUDA events and CUPTI, L2 flushed; each encode also at the
(8, 131072) re-encode and with the carried error; fp8's cluster plan).
``--parent DIR``: a checkout of the parent commit (``git archive``), whose
encodes are built into a fresh directory outside the repository, held
bitwise to this tree's on the timed inputs and timed beside them in the
same process. Prints the card's name and power limit, then one ``kernel``
line per record, and writes them to ``build/codec_phase.json``. Needs one
CUDA card.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        return cs.fail("no CUDA card")
    from repro_torch.kernels import _build, codec, ref
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all(("codec_int8", "codec_int4", "codec_fp8"))
    for lib in ("codec_int8", "codec_int4", "codec_fp8"):
        for line in _build.library_path(lib).with_suffix(".log") \
                .read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"{lib}: {line.strip()}")
    parent = cs.parent_libraries(args.parent) if args.parent else None
    records = cs.kernel_phase(torch, codec, ref, dev, parent=parent)
    print(cs._smi("name,power.limit"))
    for rec in records.values():
        print("kernel " + json.dumps(rec))
    out = ROOT / "build" / "codec_phase.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
