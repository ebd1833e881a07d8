"""Render the dry run's JSONL records into tables (port of
``repro.roofline.report``).

  python -m repro_torch.roofline.report results.jsonl [results_opt.jsonl]

The terms are a model from the H100 SXM5's data-sheet peaks
(``roofline/terms.py``) applied to counts of the port's eager program
(``launch/dryrun.py``), not a measurement. The dry-run table's mesh
column names the port's grids, ``32x8`` and ``64x8`` (nodes x GPUs), and
its compile column holds the counting time (``count_s``).
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Optional


def load(path: str) -> Dict:
    out = {}
    for line in open(path):
        r = json.loads(line)
        out[(r["arch"], r["shape"], r["multi_pod"])] = r
    return out


def fmt_s(x: Optional[float]) -> str:
    if x is None:
        return "-"
    if x >= 100:
        return f"{x:.0f}s"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def roofline_table(recs: Dict, baseline: Optional[Dict] = None) -> str:
    lines = [
        "| arch | shape | bottleneck | compute | memory | collective | "
        "step>= | useful | frac | peak/chip | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, mp), r in sorted(recs.items()):
        if mp:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | — "
                         f"| — | long_500k skip (full attention) |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {arch} | {shape} | ERROR | | | | | | | | "
                         f"{r.get('error', '')[:40]} |")
            continue
        ro = r["roofline"]
        peak = (r["memory"]["peak_bytes"] or 0) / 2 ** 30
        note = ""
        if baseline:
            b = baseline.get((arch, shape, mp))
            if b and b.get("status") == "ok":
                prev = b["roofline"]["step_lower_bound_s"]
                cur = ro["step_lower_bound_s"]
                if prev > 0 and abs(prev / max(cur, 1e-12) - 1) > 0.05:
                    note = f"{prev / cur:.1f}x vs baseline"
        lines.append(
            f"| {arch} | {shape} | {ro['bottleneck']} | "
            f"{fmt_s(ro['compute_s'])} | {fmt_s(ro['memory_s'])} | "
            f"{fmt_s(ro['collective_s'])} | "
            f"{fmt_s(ro['step_lower_bound_s'])} | "
            f"{ro['useful_ratio']:.2f} | {ro['roofline_fraction']:.3f} | "
            f"{peak:.0f}GiB | {note} |")
    return "\n".join(lines)


def dryrun_table(recs: Dict) -> str:
    lines = [
        "| arch | shape | mesh | status | compile | args/chip | temp/chip | "
        "collectives (count) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, mp), r in sorted(recs.items(),
                                       key=lambda kv: (kv[0][0], kv[0][1],
                                                       kv[0][2])):
        mesh = "64x8" if mp else "32x8"
        if r["status"] != "ok":
            status = r["status"]
            reason = (r.get("reason") or r.get("error", ""))[:50]
            lines.append(f"| {arch} | {shape} | {mesh} | {status} | | | | "
                         f"{reason} |")
            continue
        mem = r["memory"]
        cc = r["hlo"]["collective_counts"]
        cstr = " ".join(f"{k.replace('collective-', 'c-')}:{v}"
                        for k, v in sorted(cc.items()))
        lines.append(
            f"| {arch} | {shape} | {mesh} | ok | {r['count_s']}s | "
            f"{(mem['argument_bytes'] or 0) / 2**30:.1f}GiB | "
            f"{(mem['temp_bytes'] or 0) / 2**30:.1f}GiB | {cstr[:70]} |")
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    base = load(argv[0]) if argv else {}
    opt = load(argv[1]) if len(argv) > 1 else base
    print("## Roofline (single pod; a model from H100 SXM5 data-sheet "
          "peaks, not a measurement)\n")
    print(roofline_table(opt, base))
    print("\n## Dry-run matrix (both grids)\n")
    print(dryrun_table(opt))


if __name__ == "__main__":
    main()
