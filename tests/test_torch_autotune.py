"""The port's cost model and selector against the reference's.

For allreduce on ``host_cpu`` and ``host_ipc`` links, across topologies,
size buckets and error budgets, the prior's choice (algorithm, chunk
count, codec) and its modeled seconds equal the reference's; so they do
for the other five collectives on the 2x4 grid, with their plan lists. A
``TuningTable`` written by either package loads in the other and resolves
to the same measured plan.

The port's own preset: ``derive_link`` gives a CUDA grid ``h100_grid``
(no warning; another platform still warns once), the preset is registered
with non-negative constants and its structural values, and ``fit_net``
recovers known constants from rows timed by a known preset.
"""
import numpy as np
import torch
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


class _StubGrid:
    """A stand-in exposing only the grid's device (nothing allocated)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.axis_names = ("node", "local")
        self.shape = {"node": 2, "local": 4}


def test_derive_link_on_cuda_is_the_h100_preset_without_warning():
    import warnings

    from repro_torch.core import topology
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert topology.derive_link(_StubGrid("cuda:0"), "node",
                                    "inter") == "h100_grid"
        root = TTopo.from_grid(_StubGrid("cuda:0"))
    assert root.link_names == ("h100_grid", "h100_grid")
    assert tcm.net_for(root) == tcm.h100_grid()
    # the link is part of the tuning-table key: a CUDA grid's rows are not
    # a CPU grid's
    assert ta.topo_key(root) == "2x4/h100_grid/h100_grid"
    assert ta.topo_key(root) != ta.topo_key(
        TTopo.from_grid(_StubGrid("cpu")))


def test_derive_link_warns_once_on_another_platform(monkeypatch):
    from repro_torch.core import topology
    monkeypatch.setattr(topology, "_FALLBACK_WARNED", set())
    with pytest.warns(RuntimeWarning, match="'meta'"):
        assert topology.derive_link(_StubGrid("meta"), "node",
                                    "inter") == "host_cpu"
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per platform
        assert topology.derive_link(_StubGrid("meta"), "local",
                                    "intra") == "host_cpu"
        assert topology.derive_link(_StubGrid("cpu"), "node",
                                    "inter") == "host_cpu"


def test_h100_preset_is_registered_and_structural():
    net = tcm.resolve_net("h100_grid")
    assert "h100_grid" in tcm.NET_PRESETS and net.name == "h100_grid"
    assert "h100_grid" not in jcm.NET_PRESETS  # the port's own preset
    for field in tcm.FIT_PARAMS:
        value = (1.0 / net.msg_rate if field == "inv_msg_rate"
                 else getattr(net, field))
        assert value >= 0.0, field
    # structural values: one address space (PiP), the model's flop rate
    assert net.copy_factor == 1.0
    assert net.flop_rate == tcm.NetParams("x", 0, 0, 0, 0, 1).flop_rate
    # the reference's presets are unchanged beside it
    for name in jcm.NET_PRESETS:
        assert tcm.resolve_net(name).__dict__ == \
            jcm.resolve_net(name).__dict__


def _lattice_samples(net, seed=None):
    """Lossless plans of the 2x4 grid and its axis groups at 8 B and 4 MiB
    per rank, timed by ``net`` (times ``1 + noise`` from a seeded draw)."""
    from repro_torch.core.grid import RankGrid
    grid = RankGrid(2, 4, device="cpu")
    root = TTopo.from_grid(grid)
    topos = [root] + [TTopo.subset(grid, a, parent=root)
                      for a in (("node",), ("local",), ("node", "local"))]
    rng = np.random.default_rng(seed)
    out = []
    for t in topos:
        for coll in ("allgather", "allreduce", "alltoall", "broadcast",
                     "reduce_scatter", "scatter"):
            for nb in (8, 4 << 20):
                for algo, ch, _ in ta.plans(coll, t, nb, codecs=()):
                    sec = tcm.plan_cost(coll, algo, t, nb, net,
                                        chunks=ch).time
                    if seed is not None:
                        sec *= 1.0 + rng.uniform(-0.05, 0.05)
                    out.append((coll, algo, t, nb, ch, sec))
    return out


def test_fit_net_recovers_known_constants():
    """Rows timed by a known preset (max() branches of the ring and vendor
    allgathers included) give its constants back; with 5% seeded noise
    each constant stays within 10% and every relative error under 7%."""
    true = tcm.NetParams("t", alpha_inter=3e-5, beta_inter=1 / 3e11,
                         alpha_intra=1e-5, beta_intra=1 / 1e12,
                         msg_rate=2e5, sync_overhead=4e-5)
    want = dict(zip(tcm.FIT_PARAMS, (4e-5, 3e-5, 5e-6, 1 / 3e11, 1e-5,
                                     1 / 1e12)))
    samples = _lattice_samples(true)
    net, rep = tcm.fit_net(samples, "fit")
    assert net.name == "fit" and net.copy_factor == 1.0
    assert rep["samples"] == len(samples) > 200
    for k, v in want.items():
        assert rep["params"][k] == pytest.approx(v, rel=1e-6), k
    assert rep["rms_rel_err"] < 1e-6
    net, rep = tcm.fit_net(_lattice_samples(true, seed=0), "fit")
    for k, v in want.items():
        assert rep["params"][k] == pytest.approx(v, rel=0.1), k
    assert max(abs(e) for e in rep["rel_err"]) < 0.07


def test_fit_net_keeps_constants_non_negative():
    """Rows no non-negative preset explains exactly (every plan at one
    time): the fit stays non-negative, and a constant the rows do not need
    is 0 (a per-message cost of 0 is an infinite message rate)."""
    flat = [s[:-1] + (1e-4,) for s in _lattice_samples(tcm.host_cpu())]
    net, rep = tcm.fit_net(flat, "flat")
    assert all(v >= 0.0 for v in rep["params"].values())
    assert rep["params"]["sync_overhead"] > 0.0
    if rep["params"]["inv_msg_rate"] == 0.0:
        assert net.msg_rate == float("inf")
    with pytest.raises(ValueError):
        tcm.fit_net([], "none")
