"""The port's cost model and selector against the reference's.

For allreduce on ``host_cpu`` and ``host_ipc`` links, across topologies,
size buckets and error budgets, the prior's choice (algorithm, chunk
count, codec) and its modeled seconds equal the reference's; so they do
for the other five collectives on the 2x4 grid, with their plan lists. A
``TuningTable`` written by either package loads in the other and resolves
to the same measured plan.
"""
import numpy as np
import pytest

from repro_torch.core import autotune as ta
from repro_torch.core import costmodel as tcm
from repro_torch.core.topology import Topology as TTopo

pytest.importorskip("jax")
from repro.core import autotune as ja  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core.topology import Topology as JTopo  # noqa: E402

SHAPES = [(2, 4), (1, 8), (4, 2), (8, 1), (3, 4)]
LINKS = [("host_cpu", "host_cpu"), ("host_ipc", "host_cpu")]
SIZES = [2 ** k for k in range(4, 29, 2)]
BUDGETS = [0.0, 0.5 / 127, 2.0 ** -4, 0.1, 1.0]


@pytest.mark.parametrize("links", LINKS, ids=["host_cpu", "host_ipc"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{n}x{p}" for n, p in SHAPES])
def test_prior_choice_matches_reference(shape, links):
    tt = TTopo(*shape, node_link=links[0], local_link=links[1])
    jt = JTopo(*shape, node_link=links[0], local_link=links[1])
    ts, js = ta.Selector(), ja.Selector()
    assert ta.candidates("allreduce", tt) == ja.candidates("allreduce", jt)
    for budget in BUDGETS:
        for size in SIZES:
            got = ts.choose("allreduce", tt, size, error_budget=budget)
            want = js.choose("allreduce", jt, size, error_budget=budget)
            assert (got.algo, got.chunks, got.codec, got.source, got.net) == \
                (want.algo, want.chunks, want.codec, want.source, want.net), \
                (budget, size)
            assert got.seconds == want.seconds
    assert ta.topo_key(tt) == ja.topo_key(jt)


@pytest.mark.parametrize("coll", ["allgather", "scatter", "broadcast",
                                  "reduce_scatter", "alltoall"])
def test_other_collectives_choose_as_reference(coll):
    tt = TTopo(2, 4, node_link="host_ipc", local_link="host_cpu")
    jt = JTopo(2, 4, node_link="host_ipc", local_link="host_cpu")
    ts, js = ta.Selector(), ja.Selector()
    assert ta.candidates(coll, tt) == ja.candidates(coll, jt)
    for size in SIZES[::2]:
        assert ta.plans(coll, tt, size) == ja.plans(coll, jt, size)
        for budget in BUDGETS:
            for dtype in ("float32", "int32"):
                got = ts.choose(coll, tt, size, dtype=dtype,
                                error_budget=budget)
                want = js.choose(coll, jt, size, dtype=dtype,
                                 error_budget=budget)
                assert (got.algo, got.chunks, got.codec, got.seconds) == \
                    (want.algo, want.chunks, want.codec, want.seconds), \
                    (size, budget, dtype)


def test_cost_model_and_plans_match_reference():
    tt = TTopo(2, 4, node_link="host_ipc", local_link="host_cpu")
    jt = JTopo(2, 4, node_link="host_ipc", local_link="host_cpu")
    assert tcm.net_for(tt).__dict__ == jcm.net_for(jt).__dict__
    for size in SIZES:
        assert ta.plans("allreduce", tt, size) == ja.plans("allreduce", jt,
                                                           size)
        for algo in ta.candidates("allreduce", tt):
            for codec in ("none", "int8_block", "fp8_sim"):
                a = tcm.plan_cost("allreduce", algo, tt, size,
                                  tcm.net_for(tt), codec=codec)
                b = jcm.plan_cost("allreduce", algo, jt, size,
                                  jcm.net_for(jt), codec=codec)
                assert a.__dict__ == b.__dict__
        assert ta.predicted_seconds("allreduce", "pip_pipeline#c4@int8_block",
                                    tt, size) == \
            ja.predicted_seconds("allreduce", "pip_pipeline#c4@int8_block",
                                 jt, size)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tuning_table_round_trips_across_packages(tmp_path, writer):
    tt, jt = TTopo(2, 4, node_link="host_cpu", local_link="host_cpu"), \
        JTopo(2, 4, node_link="host_cpu", local_link="host_cpu")
    rows = [("xla", 1e-3), ("pip_mcoll@int8_block", 2e-4),
            ("pip_pipeline#c8", 5e-4)]
    path = tmp_path / "table.json"
    src, topo = (ta, tt) if writer == "port" else (ja, jt)
    table = src.TuningTable()
    for plan, sec in rows:
        table.record(topo, "allreduce", "float32", 4 << 20, plan, sec)
    table.save(path)
    for pkg, t in ((ta, tt), (ja, jt)):
        loaded = pkg.TuningTable.load(path)
        assert loaded.entries == table.entries
        sel = pkg.Selector(loaded)
        lossless = sel.choose("allreduce", t, 4 << 20)
        assert (lossless.algo, lossless.chunks, lossless.source) == \
            ("pip_pipeline", 8, "measured")
        lossy = sel.choose("allreduce", t, 4 << 20, error_budget=0.01)
        assert (lossy.algo, lossy.codec) == ("pip_mcoll", "int8_block")
    assert ta.encode_plan("pip_pipeline", 8, "int8_block") == \
        ja.encode_plan("pip_pipeline", 8, "int8_block")
    assert ta.decode_plan("pip_mcoll@int4_block") == \
        ja.decode_plan("pip_mcoll@int4_block")
    assert np.isclose(ta.size_bucket(5000), ja.size_bucket(5000))


def test_topology_from_grid_and_subset():
    from repro_torch.core.grid import RankGrid
    grid = RankGrid(2, 4, device="cpu")
    root = TTopo.from_grid(grid)
    assert (root.n_nodes, root.n_local, root.link_names) == \
        (2, 4, ("host_cpu", "host_cpu"))
    assert root.active_axes == ("node", "local")
    lanes = TTopo.subset(grid, "local", parent=root.with_links("host_ipc"))
    assert (lanes.n_nodes, lanes.n_local, lanes.group) == (1, 4, "local")
    assert lanes.active_axes == ("local",)
    both = TTopo.subset(grid, ("node", "local"),
                        parent=root.with_links("host_ipc"))
    assert both.link_names == ("host_ipc", "host_cpu")
    assert ta.topo_key(both) == ja.topo_key(
        JTopo(2, 4, node_link="host_ipc", local_link="host_cpu",
              group="nodexlocal"))
    with pytest.raises(ValueError):
        TTopo.subset(grid, ("node", "node"))
