"""The port's multi-process backend in one process: the single-process
backend, the launcher's plumbing, the process-aware link derivation on a
stand-in two-process group, the tuning-table merge and the data pipeline's
host sharding (the unit half of ``tests/test_multiprocess.py``; the spawned
legs are ``tests/test_torch_multiprocess.py``)."""
import inspect
import sys

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.core import artifact, runtime
from repro_torch.core.autotune import TuningTable, topo_key
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import ProcessGrid, RankGrid
from repro_torch.core.topology import Topology, derive_link
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import backend as dist
from repro_torch.distributed import launch, transport
from repro_torch.launch.mesh import make_process_grid


# -- backend descriptor (this pytest process is single-process) --------------


def test_single_process_backend():
    be = dist.current_backend()
    assert be.name == "single" and be.process_count == 1 \
        and be.process_index == 0 and not be.multiprocess
    assert dist.auto_initialize() == be  # no REPRO_TORCH_DIST_* env: no-op
    assert not dist.is_multiprocess()
    assert dist.process_rank() == 0 and dist.process_count() == 1
    assert dist.ranks_per_process() == 1
    dist.barrier("noop")  # must not need a process group
    assert dist.merge_tuning_table(TuningTable()) == 0


def test_to_host_and_stamp():
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(dist.to_host(x), x)
    grid = RankGrid(1, 2, "cpu")
    assert torch.equal(dist.to_host(x, grid), x)
    data = dist.stamp_artifact({"topology": "1x1/host_cpu/host_cpu"})
    assert data["backend"] == "single" and data["process_count"] == 1


def test_stamped_fields_satisfy_artifact_schema():
    data = dist.stamp_artifact({})
    assert artifact.validate(data, sections=("backend", "process_count"))


# -- launcher plumbing -------------------------------------------------------


def test_worker_env_contract():
    env = launch._worker_env(
        {"XLA_FLAGS": "--foo", "PYTHONPATH": "/elsewhere"}, rank=1,
        processes=2, ranks_per_process=4, coord="127.0.0.1:5555",
        scratch="/tmp/s")
    assert env[dist.ENV_PROCS] == "2" and env[dist.ENV_RANK] == "1"
    assert env[dist.ENV_COORD] == "127.0.0.1:5555"
    assert env[dist.ENV_SCRATCH] == "/tmp/s"
    assert env[dist.ENV_RANKS] == "4"
    assert env["PYTHONPATH"].split(":")[:2] == [str(launch.SRC),
                                                "/elsewhere"]
    assert env["XLA_FLAGS"] == "--foo"  # nothing of XLA is set
    bare = launch._worker_env({}, 0, 2, 4, "c", "s")
    assert "XLA_FLAGS" not in bare
    assert int(bare["OMP_NUM_THREADS"]) >= 1  # a share of the cores
    assert launch._worker_env({"OMP_NUM_THREADS": "3"}, 0, 2, 4, "c",
                              "s")["OMP_NUM_THREADS"] == "3"


def test_fn_ref_forms():
    ref = launch._fn_ref("repro_torch.core.runtime:collectives")
    assert ref == {"kind": "module", "module": "repro_torch.core.runtime",
                   "name": "collectives"}
    assert launch._resolve_fn(ref) is runtime.collectives
    assert launch._fn_ref(runtime.collectives) == ref
    with pytest.raises(ValueError, match="module:function"):
        launch._fn_ref("not-a-spec")
    with pytest.raises(ValueError, match="module-level"):
        launch._fn_ref(lambda: None)


def test_spawn_failure_carries_rank_tails():
    with pytest.raises(launch.LaunchError, match="rank 0") as err:
        launch.spawn([sys.executable, "-c",
                      "import sys; print('boom'); sys.exit(3)"],
                     processes=1, ranks_per_process=1, timeout=60)
    assert "boom" in str(err.value) and "rc=[3]" in str(err.value)


def test_spawn_deadline_kills_the_workers():
    with pytest.raises(launch.LaunchError, match="timeout=yes"):
        launch.spawn([sys.executable, "-c", "import time; time.sleep(60)"],
                     processes=1, ranks_per_process=1, timeout=1)


def test_cli_spawns_the_script_and_prints_rank_0(monkeypatch, capsys):
    seen = {}

    def spawn(argv, processes, ranks_per_process, timeout):
        seen.update(argv=argv, processes=processes,
                    ranks_per_process=ranks_per_process)
        return ["rank 0 says\n", "rank 1 says\n"]
    monkeypatch.setattr(launch, "spawn", spawn)
    assert launch.main(["--processes", "2", "--ranks-per-process", "3",
                        "--", "script.py", "--flag"]) == 0
    assert seen == {"argv": [sys.executable, "script.py", "--flag"],
                    "processes": 2, "ranks_per_process": 3}
    assert capsys.readouterr().out == "rank 0 says\n"
    with pytest.raises(SystemExit):
        launch.main([])


# -- a stand-in two-process gloo group (no process is spawned) ---------------


@pytest.fixture
def two_processes(monkeypatch):
    """This process as rank 1 of a 2-process group of ``backend``."""
    state = {"backend": "gloo"}
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_backend", lambda *a: state["backend"])
    monkeypatch.setattr(tdist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(tdist, "get_rank", lambda *a: 1)
    return state


def test_process_grid_holds_its_node(two_processes):
    grid = ProcessGrid(2, 4, "cpu")
    assert (grid.rank, grid.rows, grid.offset, grid.process_count) == \
        (1, 4, 4, 2)
    assert grid.axis_index("node").tolist() == [1] * 4
    assert grid.axis_index("local").tolist() == [0, 1, 2, 3]
    assert grid.axis_index(("node", "local")).tolist() == [4, 5, 6, 7]
    assert grid != RankGrid(2, 4, "cpu") and grid == ProcessGrid(2, 4, "cpu")
    be = dist.current_backend()
    assert be.name == "multiprocess" and be.process_index == 1
    # two processes of 4 ranks: 4 must divide n_local, so a process holds
    # ranks of one node; (4, 2) would put two nodes in a process
    with pytest.raises(ValueError, match="must divide n_local=2"):
        ProcessGrid(4, 2, "cpu")
    with pytest.raises(ValueError, match="must divide n_local=3"):
        ProcessGrid(1, 3, "cpu")
    assert ProcessGrid(1, 8, "cpu").held == tuple(range(4, 8))


def test_derive_link_splits_on_process_boundary(two_processes, monkeypatch):
    grid = ProcessGrid(2, 4, "cpu")
    assert derive_link(grid, "node", "inter") == "host_ipc"
    assert derive_link(grid, "local", "intra") == "host_cpu"
    topo = Topology.from_grid(grid)
    assert topo.link_names == ("host_ipc", "host_cpu")
    assert topo_key(topo) == "2x4/host_ipc/host_cpu"
    # on the card the grid chooses its transport from the processes'
    # cards: these two report different cards, so gloo (processes on one
    # card choose "shm", h100_ipc: tests/test_torch_shm_transport.py)
    monkeypatch.setattr(transport, "_CHOSEN", {})
    monkeypatch.setattr(transport, "_card_id", lambda device: "GPU-1")
    monkeypatch.setattr(tdist, "all_gather_object", lambda out, obj:
                        out.__setitem__(slice(None),
                                        [(obj[0], "GPU-0"), obj]))
    card = Topology.from_grid(ProcessGrid(2, 4, "cuda"))
    assert topo_key(card) == "2x4/host_ipc/h100_grid"
    # a group of the node axis inherits the process link
    assert Topology.subset(grid, ("node",), parent=topo).link_names == \
        ("host_ipc", "host_ipc")


def test_derive_link_single_process_stays_in_process():
    for grid in (RankGrid(2, 4, "cpu"), ProcessGrid(1, 4, "cpu")):
        assert derive_link(grid, "node", "inter") == "host_cpu"
        assert derive_link(grid, "local", "intra") == "host_cpu"


def test_other_backends_raise_naming_item_5b(two_processes):
    two_processes["backend"] = "nccl"
    with pytest.raises(NotImplementedError, match="item 5b"):
        dist.current_backend()
    with pytest.raises(NotImplementedError, match="item 5b"):
        ProcessGrid(2, 4, "cpu")


def test_color_split_across_processes_raises(two_processes):
    """A color group across processes is a grid over its members'
    processes holding this process's members in the group's order
    (consecutive or not); one inside a process is a RankGrid of its own."""
    comm = Communicator(ProcessGrid(2, 4, "cpu"))
    across = comm.split(color=[0, 1] * 4)
    assert sorted(across) == [0, 1]
    assert across[0].ranks == (0, 2, 4, 6) and across[1].ranks == (1, 3, 5, 7)
    for c, child in across.items():
        g = child.grid
        assert isinstance(g, ProcessGrid) and g.process_count == 2
        assert (g.n_nodes, g.n_local, g.held, g.rows) == (1, 4, (2, 3), 2)
        assert g.axis_index("local").tolist() == [2, 3]
        assert topo_key(child.topo) == f"1x4/host_cpu/host_ipc/g:color{c}"
    rev = comm.split(color=[0, 1] * 4, key=list(range(8))[::-1])
    assert rev[0].ranks == (6, 4, 2, 0) and rev[0].grid.held == (0, 1)
    mixed = comm.split(color=[0] * 8, key=[0, 2, 4, 6, 1, 3, 5, 7])
    assert mixed[0].ranks == (0, 4, 1, 5, 2, 6, 3, 7)
    assert mixed[0].grid.held == (1, 3, 5, 7)
    assert mixed[0].grid.axis_index("local").tolist() == [1, 3, 5, 7]
    inside = comm.split(color=[0] * 4 + [1] * 4)
    assert inside[1].ranks == (4, 5, 6, 7)
    assert type(inside[1].grid) is RankGrid


def test_held_rows_wiring_and_result_shapes(two_processes):
    """A process's part of each operand and result (no collective runs:
    the stand-in group carries no traffic)."""
    grid = ProcessGrid(2, 4, "cpu")
    x = torch.zeros(8, 5)
    assert runtime.logical(grid, "allreduce", x) is x
    held = runtime.logical(grid, "allreduce", x[:4])
    assert held.shape == (8, 5) and held.dtype == torch.float32
    assert runtime.logical(grid, "allgather", x[:4]).shape == (4, 5)
    w = runtime.wiring
    assert w("allreduce").result_shape((8, 5), 8, rows=4) == (4, 5)
    assert w("reduce_scatter").result_shape((8, 16), 8, rows=4) == (8,)
    assert w("allgather").result_shape((16,), 8, rows=4) == (4, 16)
    assert w("allgather").result_shape((16,), 8, False, rows=4) == (16,)


# -- cross-rank table merge --------------------------------------------------


def test_merge_reduce_max_keeps_slowest_rank():
    topo = Topology(2, 4, node_link="host_ipc", local_link="host_cpu")
    a, b = TuningTable(), TuningTable()
    a.record(topo, "allreduce", "float32", 4096, "pip_mcoll", 1e-4)
    b.record(topo, "allreduce", "float32", 4096, "pip_mcoll", 3e-4)
    b.record(topo, "allreduce", "float32", 4096, "ring", 2e-4)
    a.merge(b, reduce=max)
    entry = a.lookup(topo, "allreduce", "float32", 4096)
    assert entry["pip_mcoll"] == pytest.approx(3e-4)  # slowest rank wins
    assert entry["ring"] == pytest.approx(2e-4)       # new keys fold in
    # default merge keeps other-wins semantics
    c = TuningTable()
    c.record(topo, "allreduce", "float32", 4096, "pip_mcoll", 9e-4)
    a.merge(c)
    assert a.lookup(topo, "allreduce", "float32",
                    4096)["pip_mcoll"] == pytest.approx(9e-4)


def test_merge_tuning_table_folds_every_rank(two_processes, monkeypatch,
                                             tmp_path):
    """Rank 1 of two: its table and rank 0's (already in the scratch
    directory) fold with max, and rank 1 keeps the whole merged table."""
    monkeypatch.setenv(dist.ENV_SCRATCH, str(tmp_path))
    names = []
    monkeypatch.setattr(dist, "barrier", names.append)
    topo = Topology(2, 4, node_link="host_ipc", local_link="host_cpu")
    other = TuningTable()
    other.record(topo, "allreduce", "float32", 4096, "xla", 5e-4)
    other.record(topo, "allreduce", "float32", 4096, "ring", 1e-4)
    other.save(tmp_path / "table.calibrate.rank0.json")
    mine = TuningTable()
    mine.record(topo, "allreduce", "float32", 4096, "xla", 2e-4)
    mine.record(topo, "broadcast", "float32", 8, "xla", 3e-5)
    assert dist.merge_tuning_table(mine) == 1
    assert mine.lookup(topo, "allreduce", "float32", 4096) == \
        {"xla": 5e-4, "ring": 1e-4}
    assert mine.lookup(topo, "broadcast", "float32", 8) == {"xla": 3e-5}
    assert names == ["merge_tuning_table/calibrate/written",
                     "merge_tuning_table/calibrate/merged"]


# -- entry points and the data pipeline --------------------------------------


def test_entry_points_default_to_the_card():
    assert ProcessGrid().device.type == "cuda"
    assert inspect.signature(make_process_grid).parameters[
        "device"].default == "cuda"
    assert make_process_grid("cpu") == ProcessGrid(1, 1, "cpu")


def test_one_process_grid_is_the_rank_grid():
    """A ProcessGrid of one process holds every rank: its collectives are
    the RankGrid's, bitwise."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 24)).astype(np.float32))
    a, b = Communicator(ProcessGrid(1, 4, "cpu")), \
        Communicator(RankGrid(1, 4, "cpu"))
    for coll in ("allreduce", "reduce_scatter"):
        for algo in ("pip_mcoll", "xla"):
            assert torch.equal(a.invoke(coll, x, algo=algo),
                               b.invoke(coll, x, algo=algo))


def test_synthetic_lm_host_sharding(monkeypatch):
    """Rank 1 of two generates only the second half of the 1-process
    batch, bitwise."""
    whole = SyntheticLM(vocab=64, seq_len=32, global_batch=4,
                        seed=3).batch(step=5)
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "process_rank", lambda: 1)
    ds = SyntheticLM(vocab=64, seq_len=32, global_batch=4, seed=3)
    assert (ds.host_batch, ds.host_offset) == (2, 2)
    half = ds.batch(step=5)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(half[k], whole[k][2:])
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLM(vocab=64, seq_len=32, global_batch=3, seed=3)


@pytest.mark.parametrize("kw", [
    {},
    {"frames_dim": 6},
    {"embeds_len": 3, "embeds_dim": 5},
], ids=["tokens", "frames", "embeds"])
def test_synthetic_lm_matches_reference(kw):
    pytest.importorskip("jax")
    from repro.data.pipeline import SyntheticLM as JLM
    mine = SyntheticLM(vocab=97, seq_len=40, global_batch=3, seed=11, **kw)
    ref = JLM(vocab=97, seq_len=40, global_batch=3, seed=11, **kw)
    for step in (0, 7):
        got, want = mine.batch(step), ref.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = mine.iterator(start_step=7, prefetch=1)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  ref.batch(7)["tokens"])
    it.close()
