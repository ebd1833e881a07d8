"""The port's dry run (``launch/dryrun.py``) and its report
(``roofline/report.py``) at reduced sizes on the CPU.

``run_cell`` on reduced configs of every family (attention, rwkv, hybrid
mamba, MoE local and expert parallel, encoder-decoder) x train, prefill
and decode on a ``RankGrid(4, 2)`` on ``meta``: the records' keys, positive
counts, argument bytes per device equal to the reference's (each leaf of
its ``launch/specs.py`` cell by ``NamedSharding.shard_shape`` on a (4, 2)
mesh of forced host devices, no compile; in one subprocess started with
the module), a second count bitwise the first, the layer loop's
trip-count weighting equal to a direct count, the expert-parallel MoE's
one-rank-per-TP-index count equal in FLOPs to all ranks' on real data; the
report's tables against the reference's; ``serve_llm`` and
``collectives_demo`` on the CPU. The full-size cells are in
``test_torch_dryrun_full.py``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.roofline import report as jreport  # noqa: E402

from repro_torch.configs import ShapeConfig, reduced_config  # noqa: E402
from repro_torch.core.grid import RankGrid  # noqa: E402
from repro_torch.launch import dryrun, mesh as tmesh, specs  # noqa: E402
from repro_torch.layers.moe import MoE  # noqa: E402
from repro_torch.models.decoder import RunFlags  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.counter import count  # noqa: E402
from repro_torch.sharding.rules import Rules  # noqa: E402
from repro_torch.train.step import TrainConfig  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
#: family -> (arch, experts past the reduced config's: the local MoE's 9
#: do not split over the grid's 2 TP ranks)
FAMILIES = {"attention": ("smollm-360m", 0), "rwkv": ("rwkv6-1.6b", 0),
            "hybrid": ("jamba-1.5-large-398b", 0),
            "moe_local": ("qwen3-moe-235b-a22b", 1),
            "moe_ep": ("qwen3-moe-235b-a22b", 0),
            "encdec": ("seamless-m4t-large-v2", 0)}
KINDS = {"train": ("train_4k", 64, 8), "prefill": ("prefill_32k", 64, 8),
         "decode": ("decode_32k", 64, 8)}
CELLS = [(f, k) for f in FAMILIES for k in KINDS]
GRID = (4, 2)
RECORD_KEYS = {"arch", "shape", "multi_pod", "status", "mesh", "rules",
               "count_s", "memory", "hlo", "roofline", "peak_live_bytes"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "bottleneck",
                 "model_flops", "model_flops_attn", "flash_hbm_bytes",
                 "useful_ratio", "step_lower_bound_s", "roofline_fraction"}
HLO_KEYS = {"flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
            "collective_counts", "collective_bytes_by_op"}


def _cfg(family, reduced=reduced_config):
    arch, extra = FAMILIES[family]
    cfg = reduced(arch)
    if extra:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=cfg.moe.n_experts + extra))
    return cfg


def _shape(kind, shape_cls=ShapeConfig):
    name, S, B = KINDS[kind]
    return shape_cls(name, S, B, kind)


def _reference_main(out: str) -> None:
    """The reference side: each cell's argument bytes per device from its
    ``launch/specs.py`` cell on a (4, 2) mesh (Auto axes: the reference's
    sharded code needs them), leaf by leaf by ``shard_shape``."""
    from jax.sharding import Mesh

    from repro.configs import ShapeConfig as JShape, reduced_config as jred
    from repro.launch import mesh as jmesh, specs as jspecs

    mesh = Mesh(np.array(jax.devices()).reshape(GRID), ("data", "model"))
    res = {}
    with jax.set_mesh(mesh):
        for family, kind in CELLS:
            cfg = _cfg(family, jred)
            shape = _shape(kind, JShape)
            rules = jmesh.default_rules(mesh, kind, shape.global_batch,
                                        shape.seq_len,
                                        param_bytes=cfg.n_params() * 2.0)
            _, args = jspecs.build_cell(cfg, shape, mesh, rules)
            res[f"{family}/{kind}"] = sum(
                int(np.prod(a.sharding.shard_shape(a.shape)))
                * a.dtype.itemsize for a in jax.tree_util.tree_leaves(args))
    pathlib.Path(out).write_text(json.dumps(res))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_proc(tmp_path_factory):
    """The reference side, started with the module so that it runs beside
    the port's counts."""
    out = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=f"{REPO / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_proc):
    proc, out = reference_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def records(reference_proc):
    return {(f, k): dryrun.run_cell(
        FAMILIES[f][0], KINDS[k][0], False, cfg=_cfg(f), shape=_shape(k),
        grid=RankGrid(*GRID, device="meta")) for f, k in CELLS}


@pytest.mark.parametrize("family,kind", CELLS)
def test_record(family, kind, records, reference):
    rec = records[(family, kind)]
    assert rec["status"] == "ok"
    assert RECORD_KEYS <= set(rec)
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert set(rec["hlo"]) == HLO_KEYS
    assert rec["mesh"] == {"shape": list(GRID), "axes": ["node", "local"]}
    assert rec["hlo"]["flops_per_dev"] > 0
    assert rec["hlo"]["bytes_per_dev"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["argument_bytes"] == \
        reference[f"{family}/{kind}"]
    assert rec["roofline"]["step_lower_bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))
    moe = family.startswith("moe") or family == "hybrid"
    assert (rec["moe_rule"] is not None) == moe
    ep = family == "moe_ep" or (family == "hybrid"
                                and _cfg(family).moe.n_experts % 2 == 0)
    assert ("all-to-all" in rec["counted"]["primitive_collective_counts"]) \
        == ep


def test_second_count_is_bitwise_the_first(records):
    again = dryrun.run_cell("smollm-360m", "train_4k", False,
                            cfg=_cfg("attention"), shape=_shape("train"),
                            grid=RankGrid(*GRID, device="meta"))
    first = dict(records[("attention", "train")])
    again.pop("count_s"), first.pop("count_s")
    assert json.dumps(again, sort_keys=True) == \
        json.dumps(first, sort_keys=True)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
def test_trip_count_weighting_equals_a_direct_count(arch):
    """Four cycles counted directly against one and two weighted: equal in
    FLOPs, bytes and collectives."""
    cfg = dataclasses.replace(reduced_config(arch), n_layers=4)
    shape = _shape("train")
    grid = RankGrid(*GRID, device="meta")
    rules = tmesh.default_rules(grid, "train", shape.global_batch,
                                shape.seq_len)
    tcfg = TrainConfig()
    fn, args = specs.build_cell(cfg, shape, grid, rules, tcfg=tcfg)
    _, direct = count(fn, *dryrun._concrete(cfg, shape, args, tcfg))
    weighted = dryrun.count_cell(cfg, shape, grid, rules, tcfg, RunFlags())
    assert dryrun.cycles(cfg) == 4
    for k in ("flops", "memory_bytes", "collective_bytes",
              "collective_counts", "collective_bytes_by_op", "kernels"):
        assert getattr(weighted, k) == getattr(direct, k), k


def test_expert_parallel_count_is_every_ranks():
    """The EP MoE on meta (even split, one rank per TP index counted for
    all) against every rank's run on seeded tokens on the CPU: the same
    FLOPs and collectives, forward and backward."""
    cfg = reduced_config("qwen3-moe-235b-a22b")
    rules = Rules(batch=("node",), tp="local")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, cfg.d_model, generator=gen).to(torch.bfloat16)

    def step(layer, x, grid):
        y, aux = layer(x, rules=rules, grid=grid)
        (y.float().sum() + aux).backward()
    layer = MoE(cfg, gen, device="cpu").requires_grad_(True)
    _, cpu = count(step, layer, x.requires_grad_(),
                   RankGrid(*GRID, device="cpu"))
    meta = MoE(cfg, device="meta").requires_grad_(True)
    xm = torch.empty(x.shape, dtype=x.dtype, device="meta",
                     requires_grad=True)
    _, got = count(step, meta, xm, RankGrid(*GRID, device="meta"))
    assert got.flops == cpu.flops > 0
    assert got.collective_counts == cpu.collective_counts
    assert got.collective_bytes_by_op == cpu.collective_bytes_by_op


def test_report_tables(records):
    recs = {(r["arch"] + "/" + f, r["shape"], mp): dict(r, multi_pod=mp)
            for (f, _), r in records.items() for mp in (False, True)}
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    assert report.roofline_table(recs, recs) == \
        jreport.roofline_table(recs, recs)
    ref = {k: dict(r, compile_s=r["count_s"]) for k, r in recs.items()}
    got = report.dryrun_table(recs).splitlines()
    want = jreport.dryrun_table(ref).splitlines()
    assert len(got) == len(want) == 2 + len(recs)
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        gc, wc = g.split(" | "), w.split(" | ")
        assert gc[2] in ("32x8", "64x8") and wc[2] in ("16x16", "2x16x16")
        assert gc[:2] + gc[3:] == wc[:2] + wc[3:]


def test_report_main_renders_a_file(records, tmp_path, capsys):
    path = tmp_path / "records.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records.values()))
    report.main([str(path)])
    out = capsys.readouterr().out
    assert "not a measurement" in out and "| smollm-360m |" in out


def test_examples_on_the_cpu():
    env = dict(os.environ,
               PYTHONPATH=f"{REPO / 'src'}:{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cpu"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in ("serve_llm", "collectives_demo")}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        assert out.splitlines()[-1] == f"{name} OK"


if __name__ == "__main__":
    _reference_main(sys.argv[1])
