"""Dry run: count every (arch x shape x grid) cell on ``meta`` and derive
its H100 roofline terms (port of ``repro.launch.dryrun``).

  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
  python -m repro_torch.launch.dryrun --all --out results.jsonl   (resumable)

The reference lowers and compiles each cell on 512 forced host devices and
reads the post-SPMD module. Here :func:`run_cell` builds the cell on
``launch.mesh.make_production_grid(device="meta")`` (``RankGrid(32, 8)``,
or ``(64, 8)`` with ``--multi-pod``) with ``launch.specs.build_cell``,
runs its callable on ``meta`` weights and arguments under the work counter
(``roofline/counter.py``) and writes the reference's record. Nothing is
allocated and no card is needed; no device count is forced.

Per-device numbers, which the reference reads from its partitioned module,
are derived (ROADMAP.md, deliberate differences):

  * FLOPs and HBM bytes: the counted global program divided by the chips,
    the perfectly sharded lower bound (the reference's ``useful_ratio``
    also shows its module's replication; this one cannot). The HBM bytes
    are the eager program's (every op's inputs and outputs), not XLA's
    fused traffic;
  * collective bytes: what the grid primitives the program calls move per
    rank (the expert-parallel MoE's all-to-alls and all-gathers), plus the
    production layout's FSDP gathers, gradient reductions and TP
    reductions (``roofline/layout.py``);
  * memory: ``argument_bytes`` exactly, each leaf's shard; ``peak_bytes``
    adds the counted program's live peak (``peak_live_bytes``, a field of
    its own) divided over the chips, the FLOPs' sharding model.

The layer loop is weighted by its trip count, as ``hlo.py`` weights a
scan body: every pattern cycle of a model runs the same ops on the same
shapes, so a cell of ``n`` cycles counts as ``c1 + (n - 1) * (c2 - c1)``,
``c1`` and ``c2`` the counts of the same cell cut to one and two cycles
(``count_cell``; exact for every count that is linear in the layers, which
is all of them but the live peak, extrapolated the same way). The record's
``counted_cycles`` says so.

On ``meta`` a MoE splits its rows evenly over the experts, and the
expert-parallel path counts one rank per TP index for all ranks
(``layers/moe.py``); the record's ``moe_rule`` says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models.decoder import RunFlags
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.roofline import counter, layout
from repro_torch.roofline import terms as terms_lib
from repro_torch.train.step import TrainConfig


def _leaves(tree):
    if isinstance(tree, specs.LeafSpec):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def shard_bytes(leaf: specs.LeafSpec, grid_shape) -> int:
    """One device's bytes of a leaf: each dim divided by the grid axes its
    spec names (``NamedSharding.shard_shape``; ``spec_for`` replicates a
    dim they do not divide)."""
    dims = list(leaf.shape)
    for i, entry in enumerate(leaf.spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            dims[i] //= grid_shape[a]
    return math.prod(dims) * torch.empty((), dtype=leaf.dtype).element_size()


def argument_bytes(args, grid_shape) -> int:
    """The cell's arguments per device: the sum of its leaves' shards."""
    return sum(shard_bytes(leaf, grid_shape) for leaf in _leaves(args))


def _empty(leaf: specs.LeafSpec) -> torch.Tensor:
    return torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")


def _concrete(cfg, shape, args, tcfg: TrainConfig):
    """The callable's arguments on ``meta``, in the model's own layout."""
    model = specs.meta_model(cfg)
    if shape.kind == "train":
        flat = FlatParams.of(model)
        return (model, adamw.init(flat, tcfg.optimizer),
                {k: _empty(v) for k, v in args[2].items()})
    if cfg.family == "encdec":
        if shape.kind == "prefill":
            return model, _empty(args[1])
        B, S = shape.global_batch, shape.seq_len
        k, v = _empty(args[3]["k"]), _empty(args[3]["v"])
        xkv = [{"k": k[i], "v": v[i]} for i in range(k.shape[0])]
        return (model, _empty(args[1]), model.init_cache(B, S), xkv,
                S - 1)
    B, S = shape.global_batch, shape.seq_len
    caches = model.init_cache(B, S)
    if shape.kind == "prefill":
        return model, _empty(args[1]), caches
    return model, _empty(args[1]), caches, S - 1


def cycles(cfg) -> int:
    """The trip count of the model's layer loop: its pattern cycles (the
    encoder-decoder's layers, its encoder as deep as its decoder)."""
    if cfg.family == "encdec":
        return cfg.n_layers if cfg.enc_layers == cfg.n_layers else 0
    return cfg.n_layers // len(cfg.block_pattern)


def _cut(cfg, k: int):
    """``cfg`` cut to ``k`` cycles, every width the published one."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=k, enc_layers=k)
    return dataclasses.replace(cfg, n_layers=k * len(cfg.block_pattern))


def _weighted(c1, c2, n: int):
    """``c1 + (n - 1) * (c2 - c1)``, key by key through dicts."""
    if isinstance(c1, dict):
        return {k: _weighted(c1.get(k, 0), c2.get(k, 0), n)
                for k in sorted(set(c1) | set(c2))}
    return c1 + (n - 1) * (c2 - c1)


def count_cell(cfg, shape, grid, rules, tcfg: TrainConfig,
               flags: RunFlags) -> counter.Costs:
    """The counted costs of one step of the cell, the layer loop weighted
    by its trip count (counted at one and two cycles) where it has more
    than two."""
    def once(c):
        fn, args = specs.build_cell(c, shape, grid, rules, tcfg=tcfg,
                                    flags=flags)
        concrete = _concrete(c, shape, args, tcfg)
        with counter.WorkCounter() as wc:
            fn(*concrete)
        return wc.costs()
    n = cycles(cfg)
    if n <= 2:
        return once(cfg)
    c1, c2 = (once(_cut(cfg, k)).as_dict() for k in (1, 2))
    return counter.Costs(**{k: _weighted(c1[k], c2[k], n) for k in c1})


def _moe_rule(cfg, rules, grid_shape) -> Optional[str]:
    if cfg.moe is None:
        return None
    tp = grid_shape.get(rules.tp, 1) if rules.tp else 1
    rule = ("group sizes: each rank's rows split evenly over its experts "
            "(meta has no values)")
    if tp > 1 and cfg.moe.n_experts % tp == 0:
        world = math.prod(grid_shape.values())
        rule += (f"; expert parallel over {rules.tp}: one rank of each of "
                 f"the {tp} TP indices counted {world // tp} times (exact "
                 f"FLOPs; the backward's adds of the ranks' weight "
                 f"gradients not counted)")
    return rule


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             flags: RunFlags = None, tcfg: TrainConfig = None, *,
             cfg=None, shape=None, grid=None,
             hw: terms_lib.Hardware = terms_lib.H100_SXM) -> dict:
    """One cell's record. ``cfg``, ``shape`` and ``grid`` override the
    arch's config, the named shape and the production grid (reduced cells
    in the tests); the grid must be on ``meta``."""
    if tcfg is None and flags is not None:
        tcfg = TrainConfig(flags=flags)
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    t0 = time.time()
    grid = grid or mesh_lib.make_production_grid(multi_pod=multi_pod,
                                                 device="meta")
    gs = dict(grid.shape)
    rules = mesh_lib.default_rules(grid, shape.kind, shape.global_batch,
                                   shape.seq_len,
                                   param_bytes=cfg.n_params() * 2.0)
    flags = flags or RunFlags()
    tcfg = tcfg or TrainConfig(flags=flags)
    _, args = specs.build_cell(cfg, shape, grid, rules, tcfg=tcfg,
                               flags=flags)
    costs = count_cell(cfg, shape, grid, rules, tcfg, flags)
    count_s = time.time() - t0
    chips = grid.world
    lay_counts, lay_bytes = layout.collectives(
        cfg, shape, gs, rules, args[0], tcfg.flags.remat)
    coll_counts = dict(costs.collective_counts)
    coll_by = dict(costs.collective_bytes_by_op)
    for op, n in lay_counts.items():
        coll_counts[op] = coll_counts.get(op, 0) + n
        coll_by[op] = coll_by.get(op, 0.0) + lay_bytes[op]
    flops_dev = costs.flops / chips
    bytes_dev = costs.memory_bytes / chips
    coll_dev = sum(coll_by.values())
    flash_hbm = terms_lib.flash_hbm_traffic(cfg, shape, grid, flags)
    mf = terms_lib.model_flops(cfg, shape)
    mfa = terms_lib.model_flops_attn(cfg, shape)
    terms = terms_lib.compute_terms(flops_dev, bytes_dev, coll_dev, chips,
                                    mf + mfa, coll_counts, hw=hw)
    arg_bytes = argument_bytes(args, gs)
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok",
        "mesh": {"shape": [gs[a] for a in grid.axis_names],
                 "axes": list(grid.axis_names)},
        "rules": {"batch": list(rules.batch), "fsdp": list(rules.fsdp),
                  "tp": rules.tp, "seq": rules.seq},
        "count_s": round(count_s, 1),
        "hardware": hw.name,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": None,
            "temp_bytes": None,
            "peak_bytes": arg_bytes + costs.peak_live_bytes // chips,
        },
        "peak_live_bytes": costs.peak_live_bytes,
        "hlo": {
            "flops_per_dev": flops_dev,
            "bytes_per_dev": bytes_dev,
            "collective_bytes_per_dev": coll_dev,
            "collective_counts": coll_counts,
            "collective_bytes_by_op": coll_by,
        },
        "counted": {
            "flops": costs.flops, "memory_bytes": costs.memory_bytes,
            "aten_ops": costs.aten_ops, "kernel_ops": costs.kernel_ops,
            "kernels": costs.kernels,
            "primitive_collective_counts": costs.collective_counts,
            "primitive_collective_bytes_by_op":
                costs.collective_bytes_by_op,
            "layout_collective_counts": lay_counts,
            "layout_collective_bytes_by_op": lay_bytes,
        },
        "moe_rule": _moe_rule(cfg, rules, gs),
        "counted_cycles": ([1, 2] if cycles(cfg) > 2 else None),
        "cycles": cycles(cfg),
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "bottleneck": terms.bottleneck,
            "model_flops": mf,
            "model_flops_attn": mfa,
            "flash_hbm_bytes": flash_hbm,
            "useful_ratio": terms.useful_ratio,
            "step_lower_bound_s": terms.total_s(),
            "roofline_fraction": terms.roofline_fraction(),
        },
    }
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--kv-chunk", type=int, default=1024)
    args = ap.parse_args(argv)

    flags = RunFlags(remat=args.remat, q_chunk=args.q_chunk,
                     kv_chunk=args.kv_chunk)
    tcfg = TrainConfig(flags=flags, microbatches=args.microbatches)

    cells = []
    if args.all:
        pods = [False, True]
        if args.single_pod_only:
            pods = [False]
        if args.multi_pod_only:
            pods = [True]
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in pods:
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]

    done = set()
    out_path = pathlib.Path(args.out) if args.out else None
    if out_path and out_path.exists():
        for line in out_path.read_text().splitlines():
            try:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["multi_pod"]))
            except json.JSONDecodeError:
                pass

    for arch, shape, mp in cells:
        key = (arch, shape, mp)
        if key in done:
            print(f"[dryrun] cached {key}", flush=True)
            continue
        print(f"[dryrun] {arch} x {shape} multi_pod={mp} ...", flush=True)
        try:
            rec = run_cell(arch, shape, mp, flags=flags, tcfg=tcfg)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        line = json.dumps(rec)
        if out_path:
            with out_path.open("a") as f:
                f.write(line + "\n")
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" bottleneck={r['bottleneck']}"
                     f" step>={r['step_lower_bound_s']:.4f}s"
                     f" frac={r['roofline_fraction']:.3f}"
                     f" count={rec['count_s']}s")
        elif status == "error":
            extra = " " + rec["error"][:200]
        print(f"[dryrun] {arch} x {shape} mp={mp}: {status}{extra}",
              flush=True)


if __name__ == "__main__":
    main()
