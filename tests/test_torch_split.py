"""Sub-communicators (``Communicator.split``), the split lattice, timed
calibration into the tuning table, and the engine's scoped tick sync.

Two reference runs, each once per module in its own subprocess (this
file's ``__main__``, 8 forced host devices), started together:

  * every (collective, algorithm) pair through the reference's
    ``split(axes="local")``, ``split(axes=("node",))`` and a color split of
    a 2x4 mesh, on the same numpy operands (float32 with a -0.0 on the
    first rank, and a codec variant for every codec-capable pair);
    the port's children must give the same bits;
  * ``Communicator.calibrate(include_splits=True, names=("broadcast",
    "allgather"), sizes=(8, 4096), iters=1, codecs=())``: the port's sweep
    must record the same ``(collective, plan, bytes, group)`` rows.

The rest mirrors the reference's split tests (``tests/test_comm.py``) on
CPU rank grids, and holds ``Engine(sync_axes=...)`` to the sync-free
engine's tokens.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import autotune, mcoll, runtime
from repro_torch.core import comm as comm_mod
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid
from repro_torch.core.topology import Topology
from repro_torch.models.decoder import DecoderLM
from repro_torch.serve.engine import Engine, Request

N, P = 2, 4
WORLD = N * P
#: the color split: even and odd ranks, each group in reverse rank order
COLOR = tuple(r % 2 for r in range(WORLD))
KEY = tuple(-r for r in range(WORLD))
SPLITS = ("local", "node", "color")
#: the calibration both packages run (lossless plans: the codec variants
#: would double the reference's compile time)
CAL = dict(names=("broadcast", "allgather"), sizes=(8, 4096), iters=1,
           codecs=())


def _sizes(split):
    """(D, G): the ranks an operand spans and the group size."""
    return {"local": (WORLD, P), "node": (WORLD, N), "color": (P, P)}[split]


def _operands(split):
    """name -> collective -> global operand (numpy) for ``split``'s (D,
    G), per the runtime's conventions."""
    D, G = _sizes(split)
    rng = np.random.default_rng(100 + SPLITS.index(split))

    def make(scale):
        def f(*shape):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        return f

    ops = {}
    for name, m in (("f32", 1), ("wide", 60)):
        f = make(10 if name == "wide" else 1)
        ops[name] = {"allgather": f(D * 5 * m), "scatter": f(G * 5 * m, 2),
                     "broadcast": f(37 * m), "allreduce": f(D, 40 * m),
                     "reduce_scatter": f(D, G * 6 * m),
                     "alltoall": f(D, G, 5 * m)}
    for x in ops["f32"].values():
        x.reshape(-1)[3] = -0.0  # a signed zero on the first rank
    return ops


def _cases():
    cases = []
    for split in SPLITS:
        for coll in runtime.collectives():
            for algo in mcoll.algorithms(coll):
                cases.append((split, coll, algo, "f32", "none"))
                if mcoll.supports_codec(coll, algo):
                    cases.append((split, coll, algo, "wide", "int8_block"))
    return cases


CASES = _cases()


def _key(split, coll, algo, name, codec):
    return f"{split}/{coll}/{algo}/{name}/{codec}"


def _child(comm, split):
    if split == "color":
        return comm.split(color=COLOR, key=KEY)[1]
    return comm.split(axes=split if split == "local" else (split,))


def _run(child, split, coll, algo, name, codec, to_array, wrap):
    x = wrap(_operands(split)[name][coll])
    knobs = {} if codec == "none" else {"codec": codec}
    return to_array(child.invoke(coll, x, algo=algo, **knobs))


def _reference_collectives(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.core.comm import Communicator as JComm

    comm = JComm(jax.make_mesh((N, P), ("node", "local")))
    res = {}
    for case in CASES:
        res[_key(*case)] = _run(_child(comm, case[0]), *case, np.asarray,
                                jnp.asarray)
    np.savez(out_path, **res)


def _row_keys(rows):
    return sorted(f"{r.collective}|"
                  f"{autotune.encode_plan(r.algo, r.chunks, r.codec)}|"
                  f"{r.nbytes}|{r.group}" for r in rows)


def _reference_calibration(out_path: str) -> None:
    import jax
    from repro.core import autotune as jautotune
    from repro.core.comm import Communicator as JComm

    comm = JComm(jax.make_mesh((N, P), ("node", "local")),
                 selector=jautotune.Selector())
    rows = comm.calibrate(include_splits=True, **CAL)
    np.savez(out_path, rows=np.array(_row_keys(rows)))


@pytest.fixture(scope="module")
def _reference_runs(tmp_path_factory):
    """Both reference runs, started together."""
    pytest.importorskip("jax")
    base = tmp_path_factory.mktemp("split_ref")
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    runs = {}
    for what in ("collectives", "calibration"):
        out = base / f"{what}.npz"
        runs[what] = (out, subprocess.Popen(
            [sys.executable, __file__, what, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    yield runs
    for _, proc in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _load(runs, what):
    out, proc = runs[what]
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def reference(_reference_runs):
    return _load(_reference_runs, "collectives")


@pytest.fixture(scope="module")
def reference_rows(_reference_runs):
    return list(_load(_reference_runs, "calibration")["rows"])


@pytest.fixture(scope="module")
def root():
    return Communicator(RankGrid(N, P, device="cpu"))


# ---------------------------------------------------------------------------
# every collective through the splits, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split,coll,algo,name,codec", CASES,
                         ids=[_key(*c) for c in CASES])
def test_split_collective_matches_reference(reference, root, split, coll,
                                            algo, name, codec):
    got = _run(_child(root, split), split, coll, algo, name, codec,
               lambda t: t.numpy(), torch.from_numpy)
    want = reference[_key(split, coll, algo, name, codec)]
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("split", ["local", "node"])
@pytest.mark.parametrize("coll", runtime.collectives())
def test_split_persistent_op_result_shape(root, split, coll):
    """A group's persistent op allocates the blocking call's result shape
    (G < D: the wiring's group-aware shapes)."""
    child = _child(root, split)
    x = torch.from_numpy(_operands(split)["f32"][coll])
    op = child.persistent(coll, x, algo="xla" if coll != "scatter"
                          else "linear")
    want = child.invoke(coll, x, algo=op.algo)
    assert torch.equal(op(x), want)
    D, G = _sizes(split)
    assert tuple(want.shape) == runtime.wiring(coll).result_shape(
        x.shape, D, group=G)
    op.release()


# ---------------------------------------------------------------------------
# calibration over the split lattice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def calibrated():
    comm = Communicator(RankGrid(N, P, device="cpu"),
                        selector=autotune.Selector())
    return comm, comm.calibrate(include_splits=True, **CAL)


def test_calibrate_records_the_reference_rows(reference_rows, calibrated):
    _, rows = calibrated
    assert _row_keys(rows) == sorted(reference_rows)
    assert {r.group for r in rows} == {"", "node", "local", "nodexlocal"}


@pytest.mark.parametrize("coll", CAL["names"])
@pytest.mark.parametrize("nbytes", CAL["sizes"])
def test_calibrated_plans_resolve_from_measurement(calibrated, coll,
                                                   nbytes):
    """Every lattice member resolves ``auto`` at a calibrated size from its
    own measured rows, and picks their lossless argmin."""
    comm, rows = calibrated
    for c in (comm,) + comm.split_lattice():
        sel = c.plan(coll, nbytes)
        assert sel.source == "measured", (c, sel)
        mine = {autotune.encode_plan(r.algo, r.chunks, r.codec): r.seconds
                for r in rows if r.group == c.topo.group
                and r.collective == coll and r.nbytes == nbytes
                and r.codec == "none"}
        best = autotune.encode_plan(sel.algo, sel.chunks, sel.codec)
        assert mine[best] == min(mine.values())
        x = runtime.example_input(coll, c.topo, nbytes,
                                  devices=c.grid.world, device="cpu")
        assert c.invoke(coll, x).shape == c.invoke(coll, x,
                                                   algo=sel.algo).shape


def test_calibration_saves_group_keyed_rows(calibrated, tmp_path):
    comm, _ = calibrated
    path = tmp_path / "table.json"
    comm.calibrate(path=path, names=("broadcast",), sizes=(8,), iters=1,
                   codecs=())
    loaded = autotune.Selector(autotune.TuningTable.load(path))
    for c in comm.split_lattice():
        assert autotune.topo_key(c.topo).endswith(f"/g:{c.topo.group}")
        assert loaded.table.lookup(c.topo, "broadcast", "float32", 8) == \
            comm.selector.table.lookup(c.topo, "broadcast", "float32", 8)
        assert loaded.choose("broadcast", c.topo, 8).source == "measured"


# ---------------------------------------------------------------------------
# split semantics (the reference's tests/test_comm.py, on rank grids)
# ---------------------------------------------------------------------------


def test_split_memoized_and_shares_selector(root):
    g1 = root.split(axes="local")
    assert g1 is root.split(axes="local") is root.split(axes=("local",))
    assert g1.selector is root.selector and g1.grid is root.grid
    assert g1.topo.group == "local" and g1.topo.world == P
    assert root.split(axes="node") is not g1
    assert root.split(axes="local", group="tp") is not g1
    assert root.split_lattice() == (root.split(axes="node"), g1,
                                    root.split(axes=("node", "local")))


def test_split_world1_and_size1_axes_run_collectives():
    """A size-1 axis gives a world-1 child that still runs every
    collective: the identity semantics, not an error."""
    root = Communicator(RankGrid(1, 1, device="cpu"))
    g = root.split(axes="local")
    z = torch.ones((1, 16))
    assert torch.equal(g.allreduce(z), z)
    for name in runtime.collectives():
        x = runtime.example_input(name, g.topo, 64, device="cpu")
        assert torch.isfinite(g.invoke(name, x).double()).all()
    assert root.split_lattice() == (g,)


def test_single_axis_group_topology_dedupes_axes():
    topo = Topology(1, 4, node_axis="local", local_axis="local")
    assert topo.active_axes == ("local",)
    assert Topology(1, 1, node_axis="node", local_axis="node").active_axes \
        == ("node",)


def test_split_of_split_composes(root):
    both = root.split(axes=("node", "local"))
    gg = both.split(axes="local")
    assert gg.topo.world == P and gg.topo.group == "local"
    assert gg.grid is root.grid
    x = torch.from_numpy(_operands("local")["f32"]["allreduce"])
    assert torch.equal(gg.allreduce(x, algo="xla"),
                       root.split(axes="local").allreduce(x, algo="xla"))


def test_split_exec_cache_shared_between_identical_children(root):
    """Identically specced splits reuse one exec-cache entry: the group
    topology keys the cache. The root, on the same grid with the same
    operand, has its own entry."""
    runtime.clear_cache()
    z = torch.ones((WORLD, 32))
    a = root.split(axes="local").allreduce(z, algo="pip_mcoll")
    b = root.split(axes="local").allreduce(z, algo="pip_mcoll")
    s = runtime.cache_stats()
    assert s.exec_misses == 1 and s.exec_hits == 1, s
    assert torch.equal(a, b) and torch.equal(a, torch.full((WORLD, 32), 4.))
    full = root.allreduce(z, algo="pip_mcoll")
    assert s.exec_misses == 2, s
    assert torch.equal(full, torch.full((WORLD, 32), 8.))


def test_split_group_namespaces_tuning_keys():
    root = Communicator(RankGrid(N, P, device="cpu"),
                        selector=autotune.Selector())
    g = root.split(axes="local")
    assert autotune.topo_key(g.topo) != autotune.topo_key(root.topo)
    assert autotune.topo_key(g.topo).endswith("/g:local")
    root.selector.table.record(g.topo, "allreduce", "float32", 1 << 10,
                               "xla", 1e-9)
    assert root.selector.table.lookup(root.topo, "allreduce", "float32",
                                      1 << 10) is None
    sel = g.plan("allreduce", 1 << 10)
    assert sel.algo == "xla" and sel.source == "measured"


def test_split_calibration_table_roundtrip_with_group_keys(tmp_path):
    root = Communicator(RankGrid(N, P, device="cpu"),
                        selector=autotune.Selector())
    g = root.split(axes="local")
    root.selector.table.record(g.topo, "allreduce", "float32", 1 << 10,
                               "xla", 1e-9)
    path = tmp_path / "table.json"
    root.selector.table.save(path)
    loaded = autotune.TuningTable.load(path)
    assert loaded.lookup(g.topo, "allreduce", "float32", 1 << 10) == \
        {"xla": 1e-9}


def test_split_validation(root):
    with pytest.raises(ValueError, match="exactly one of"):
        root.split()
    with pytest.raises(ValueError, match="exactly one of"):
        root.split(axes="local", color=[0] * WORLD)
    with pytest.raises(ValueError, match="key= only"):
        root.split(axes="local", key=[0] * WORLD)
    with pytest.raises(ValueError, match="not in grid axes"):
        root.split(axes="tp")
    with pytest.raises(ValueError, match="one entry per parent rank"):
        root.split(color=[0, 1])
    with pytest.raises(ValueError, match="one entry per parent rank"):
        root.split(color=COLOR, key=[0])
    with pytest.raises(ValueError, match="does not match"):
        Communicator(root.grid, Topology(1, 3, "local", "local"))


def test_split_color_groups(root):
    groups = root.split(color=COLOR, key=KEY)
    assert groups == root.split(color=COLOR, key=KEY)  # memoized children
    assert set(groups) == {0, 1}
    for c, g in groups.items():
        assert g.topo.world == P and g.topo.group == f"color{c}"
        assert g.grid == RankGrid(1, P, "cpu") and g.selector is root.selector
        # ordered by (key, rank): the reversed ranks of one parity
        assert g.ranks == tuple(range(WORLD - 2 + c, -1, -2))
    # the caller's rows of group 1, in its order, allgathered
    x = torch.arange(WORLD * 3.0).reshape(WORLD, 3)
    g = groups[1]
    rows = x[list(g.ranks)]
    got = g.allgather(rows.reshape(-1), algo="ring", stacked=False)
    assert torch.equal(got, rows.reshape(-1))
    solo = root.split(color=[7] * WORLD, group="all")[7]
    assert solo.topo.group == "all" and solo.ranks == tuple(range(WORLD))


def test_communicator_memoized_per_grid_topo():
    grid = RankGrid(N, P, device="cpu")
    c1 = comm_mod.communicator(grid)
    assert c1 is comm_mod.communicator(RankGrid(N, P, device="cpu"))
    assert c1 is comm_mod.communicator(grid, Topology.from_grid(grid))
    assert comm_mod.communicator(RankGrid(1, WORLD, device="cpu")) \
        is not c1
    assert c1.split(axes="local") is comm_mod.communicator(grid).split(
        axes="local")


# ---------------------------------------------------------------------------
# the engine's tick sync scoped to a group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """A serving function on a reduced smollm, and its sync-free tokens."""
    cfg = reduced_config("smollm-360m")
    model = DecoderLM(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=(n,), dtype=np.int32)
               for n in (12, 3, 7, 9, 5)]

    def serve(**kw):
        eng = Engine(model, cfg, max_batch=2, max_len=64, **kw)
        done = eng.run([Request(prompt=p.copy(), max_new_tokens=6)
                        for p in prompts])
        return eng, {tuple(r.prompt.tolist()): r.out_tokens for r in done}

    return serve, serve()[1]


@pytest.mark.parametrize("sync_axes,group", [("node", "node"),
                                             (("node", "local"),
                                              "nodexlocal")])
def test_engine_sync_axes_keeps_the_sync_free_tokens(served, sync_axes,
                                                     group):
    serve, want = served
    eng, got = serve(mesh=RankGrid(N, P, device="cpu"), sync_axes=sync_axes)
    assert got == want
    assert eng.sync_comm is eng.comm.split(axes=sync_axes)
    assert eng.sync_comm.topo.group == group
    m = eng.metrics()
    assert m["sync_starts"] == m["ticks"] > 0 and m["plan_rebinds"] == 0
    assert eng._sync_op.comm is eng.sync_comm


if __name__ == "__main__":
    {"collectives": _reference_collectives,
     "calibration": _reference_calibration}[sys.argv[1]](sys.argv[2])
