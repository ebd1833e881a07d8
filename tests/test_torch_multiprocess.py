"""The port's ``torch.distributed`` transport on CPU ranks over gloo:
two spawned processes form a ``ProcessGrid`` and run every plan, held
bitwise against the one-process ``RankGrid`` and against the reference.

Three spawns per module, each under its own deadline (``launch.run``'s
``timeout``; every process group has its own timeout too):

  * the reference: a single-process ``(2, 2)`` Communicator on 4 forced
    host devices in a subprocess (this file's ``__main__`` block), through
    every plan of ``runtime.example_input``'s 4096-byte operands, plus its
    ``SyntheticLM`` batch, written to an ``.npz``;
  * 2x2: two workers of 2 ranks take the reference's operands through
    every plan both packages list; ``to_host`` of each result must equal
    the reference's and ``RankGrid(2, 2, "cpu")``'s bitwise;
  * 2x4: two workers of 4 ranks take seeded float32 (with a -0.0), int32
    and the three codecs' payloads (with and without the error-feedback
    carry) through every plan, and run the legs below; every result must
    equal ``RankGrid(2, 4, "cpu")``'s bitwise, which
    ``tests/test_torch_collectives.py`` holds against the reference.

A fourth spawn, two workers of 2 ranks, runs the train steps of
``train/manual_step.py`` on the ``ProcessGrid`` (each process computes and
holds only its own ranks' gradient rows): the fused step lossless and with
int8 error feedback, and the overlapped step's segmented decomposition,
two steps each; every process's losses, weights and AdamW moments must be
bitwise those of the same steps on ``RankGrid(2, 2, "cpu")``.

The 2x4 workers also run a persistent op, ``split(axes=...)`` children, a
color split inside each process and one across processes (each process
holds its members' rows of the one-process child's result), the
calibrate-merge leg (one table, written by rank 0 under
``2x4/host_ipc/host_cpu``, each plan the max over ranks, ``auto`` alike on
both ranks), the data leg (the stacked 2-process ``SyntheticLM`` batch is
the 1-process batch and the reference's) and a traced call whose Chrome
trace carries the worker's process rank and gloo transport spans.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import autotune, mcoll, runtime
from repro_torch.core import telemetry as tm
from repro_torch.core.autotune import Selector, TuningTable
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid
from repro_torch.core.topology import Topology
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import backend, launch

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
#: seconds a spawn may take before its workers are killed
SPAWN_TIMEOUT = 300
NBYTES = 4096
CODECS = ("int8_block", "int4_block", "fp8_sim")
N, P = 2, 4
WORLD = N * P
CALIBRATED = ("allreduce", "broadcast")
DATA = dict(vocab=64, seq_len=32, seed=3)


#: the train legs: reduced smollm, a global batch of 2 sequences a rank
TRAIN_BATCH, TRAIN_T = 4, 16
TRAIN_BUCKET = 256 << 10


def _plans(topo):
    return [(c, a) for c in runtime.collectives()
            for a in mcoll.algorithms(c) if a in autotune.candidates(c, topo)]


# ---------------------------------------------------------------------------
# 2x4 cases: one table shared by the workers and the parent
# ---------------------------------------------------------------------------


def _operands():
    """name -> collective -> global operand (numpy) of the 2x4 grid."""
    rng = np.random.default_rng(4321)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def i32(*shape):
        return rng.integers(-1000, 1000, shape).astype(np.int32)

    ops = {
        "f32": {"allgather": f32(WORLD * 5), "scatter": f32(WORLD * 5),
                "broadcast": f32(37), "allreduce": f32(WORLD, 45),
                "reduce_scatter": f32(WORLD, WORLD * 6),
                "alltoall": f32(WORLD, WORLD, 5)},
        "i32": {"allgather": i32(WORLD * 5), "scatter": i32(WORLD * 5),
                "broadcast": i32(37), "allreduce": i32(WORLD, 45),
                "reduce_scatter": i32(WORLD, WORLD * 6),
                "alltoall": i32(WORLD, WORLD, 5)},
        # codec payloads: several quantization blocks per wire slice, rows
        # scaled over four decades so the block scales differ widely
        "wide": {"allgather": f32(WORLD * 300) * 50,
                 "scatter": f32(WORLD * 300, 2) * 3,
                 "broadcast": f32(700) * 3,
                 "allreduce": f32(WORLD, 1000)
                 * rng.uniform(0.01, 100, (WORLD, 1)).astype(np.float32),
                 "reduce_scatter": f32(WORLD, WORLD * 96)
                 * rng.uniform(0.01, 100, (WORLD, 1)).astype(np.float32),
                 "alltoall": f32(WORLD, WORLD, 70) * 7},
    }
    for x in ops["f32"].values():
        x.reshape(-1)[3] = -0.0  # a signed zero on rank 0 (the root)
    return ops


def _cases():
    """(collective, algo, operand, knobs) for every blocking call."""
    cases = []
    for coll, algo in _plans(Topology(N, P)):
        cases += [(coll, algo, "f32", {}), (coll, algo, "i32", {})]
        if mcoll.supports_chunks(coll, algo):
            cases.append((coll, algo, "f32", {"chunks": 3}))
        if mcoll.supports_codec(coll, algo):
            cases += [(coll, algo, "wide", {"codec": c}) for c in CODECS]
    cases.append(("allgather", "pip_mcoll", "f32", {"stacked": False}))
    return cases


def _carry_cases():
    return [(algo, codec) for algo in mcoll.algorithms("allreduce")
            if runtime.supports_carry("allreduce", algo) for codec in CODECS]


CASES = _cases()
CARRY_CASES = _carry_cases()


def _key(coll, algo, name, knobs):
    return f"{coll}/{algo}/{name}" + "".join(
        f"#{k}={v}" for k, v in sorted(knobs.items()))


def _carry_err(x):
    """A nonzero carried error: a small seeded residual per rank."""
    rng = np.random.default_rng(7)
    return (rng.standard_normal(x.shape) * 1e-3).astype(np.float32)


def _carry_steps(comm, algo, codec, x, e, rows=slice(None)):
    """Two carry steps of a compressed allreduce persistent op on the rows
    ``rows`` of ``x`` and ``e``: ``[y1, e1, y2, e2]`` as numpy."""
    xs = torch.from_numpy(x[rows]).clone()
    es = torch.from_numpy(e[rows]).clone()
    op = comm.allreduce_init(xs, algo=algo, codec=codec, carry=True)
    out = []
    for _ in range(2):
        y, e_new = op.start(xs, carry=es).wait()
        out += [y.numpy().copy(), e_new.numpy().copy()]
    op.release()
    return out


def _child_call(comm, ax, coll):
    """``coll`` through the ``split(axes=ax)`` child on its group-shaped
    ``example_input`` operand (every rank of the grid's rows)."""
    child = comm.split(axes=ax)
    x = runtime.example_input(coll, child.topo, 96, devices=WORLD,
                              device="cpu")
    return child.invoke(coll, x, algo="pip_mcoll")


def _color_results(comm, color, ops):
    """``{color: allreduce of the group's rows}`` of a color split, for
    the groups whose ranks this process holds."""
    grid = comm.grid
    out = {}
    for c, child in comm.split(color=color).items():
        held = [r for r in child.ranks
                if grid.offset <= r < grid.offset + grid.rows]
        if held:
            x = torch.from_numpy(ops["f32"]["allreduce"][list(child.ranks)])
            out[c] = child.allreduce(x, algo="pip_mcoll").numpy()
    return out


def _train_legs(grid):
    """Two steps of each train leg on ``grid`` from the same seeded weights
    and batch (plans pinned: ``auto`` resolves by the grid's links, which
    differ between one process and two): ``{leg: {"losses", "params",
    "m", "v"}}`` (the flat buffers as numpy), read on this process."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.decoder import DecoderLM, RunFlags
    from repro_torch.models.params import FlatParams
    from repro_torch.optim import adamw
    from repro_torch.train import manual_step as ms
    from repro_torch.train.step import TrainConfig

    torch.set_num_threads(1)  # the same arithmetic in every process
    cfg = reduced_config("smollm-360m")
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                             schedule="constant")
    tcfg = TrainConfig(optimizer=ocfg, flags=RunFlags(remat="none"))
    rng = np.random.default_rng(11)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_T))).long()
        for k in ("tokens", "labels")}
    comm = Communicator(grid)
    ef = dict(algo="pip_mcoll", error_budget=0.004, codec="int8_block",
              bucket_bytes=TRAIN_BUCKET)
    out = {}
    for leg in ("fused", "fused_int8_ef", "segmented"):
        model = DecoderLM(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
        flat = FlatParams.of(model)
        opt = adamw.init(flat, ocfg)
        if leg == "segmented":
            step = ms.make_overlapped_train_step(
                cfg, tcfg, grid, algo="pip_pipeline",
                bucket_bytes=TRAIN_BUCKET, segmented=True)
            run = lambda: step(model, opt, batch)
        else:
            kw = (ef if leg == "fused_int8_ef"
                  else dict(algo="pip_pipeline", bucket_bytes=TRAIN_BUCKET))
            step = ms.make_manual_train_step(cfg, tcfg, grid, **kw)
            err = ms.init_error_state(flat.n, comm, kw.get("error_budget",
                                                           0.0),
                                      TRAIN_BUCKET)
            run = lambda: step(model, opt, err, batch)[1]
        losses = [float(run()["loss"]) for _ in range(2)]
        out[leg] = {"losses": losses, "params": flat.read().numpy(),
                    "m": opt["m"].numpy().copy(),
                    "v": opt["v"].numpy().copy()}
    return out


# ---------------------------------------------------------------------------
# the workers (module-level: the launcher imports them by name)
# ---------------------------------------------------------------------------


def _worker_train():
    from repro_torch.launch.mesh import make_process_grid
    grid = make_process_grid(device="cpu")
    return {"rank": grid.rank, "rows": grid.rows,
            "legs": _train_legs(grid)}


def _worker_2x2(ref_path):
    from repro_torch.launch.mesh import make_process_grid
    grid = make_process_grid(device="cpu")
    comm = Communicator(grid)
    with np.load(ref_path) as z:
        data = dict(z)
    out = {}
    for key in data:
        if key.startswith("out/"):
            _, name, algo = key.split("/")
            x = torch.from_numpy(data[f"in/{name}"])
            y = comm.invoke(name, x, algo=algo)
            out[key] = backend.to_host(y, grid).numpy()
    return {"rank": grid.rank, "topo_key": autotune.topo_key(comm.topo),
            "out": out}


def _worker_2x4(scratch):
    from repro_torch.launch.mesh import make_process_grid
    be = backend.current_backend()
    grid = make_process_grid(device="cpu")
    comm = Communicator(grid)
    ops = _operands()
    res = {"rank": be.process_index, "backend": be.name,
           "process_count": be.process_count, "rows": grid.rows,
           "offset": grid.offset, "links": comm.topo.link_names,
           "topo_key": autotune.topo_key(comm.topo),
           "axis_index": grid.axis_index(("node", "local")).tolist()}
    mine = slice(grid.offset, grid.offset + grid.rows)

    out = {}
    for coll, algo, name, knobs in CASES:
        y = comm.invoke(coll, torch.from_numpy(ops[name][coll]), algo=algo,
                        **knobs)
        if knobs.get("stacked", True):
            y = backend.to_host(y, grid)
        out[_key(coll, algo, name, knobs)] = y.numpy()
    res["out"] = out
    res["bytes_sent"] = grid.bytes_sent

    # the error-feedback carry: this process's rows of gradient and error
    x = ops["wide"]["allreduce"]
    e = _carry_err(x)
    res["carry"] = {f"{a}@{c}": _carry_steps(comm, a, c, x, e, mine)
                    for a, c in CARRY_CASES}
    # a held operand is its rows of the full one
    res["held"] = comm.allreduce(torch.from_numpy(ops["f32"]["allreduce"]
                                                  [mine]),
                                 algo="pip_mcoll").numpy()

    # a persistent op, two starts in flight
    xp = torch.from_numpy(ops["f32"]["alltoall"])
    op = comm.alltoall_init(xp, algo="pip_mcoll", depth=2)
    h1, h2 = op.start(xp), op.start(xp)
    res["persistent"] = [backend.to_host(h.wait(), grid).numpy()
                         for h in (h1, h2)]
    op.release()

    # axis children share the grid; a color group inside one process
    res["split"] = {f"{ax}/{coll}": backend.to_host(
        _child_call(comm, ax, coll), grid).numpy()
        for ax in ("node", "local") for coll in runtime.collectives()}
    res["color"] = _color_results(comm, [0] * P + [1] * P, ops)
    res["color_across"] = _color_results(comm, [0, 1] * P, ops)

    # a traced call: gloo spans, the Chrome trace's pid is the rank
    tm.reset()
    tm.enable()
    try:
        comm.allreduce(torch.from_numpy(ops["f32"]["allreduce"]), algo="xla")
        trace = tm.export_chrome_trace()
    finally:
        tm.disable()
        tm.reset()
    res["trace_pids"] = sorted({ev["pid"] for ev in trace["traceEvents"]})
    res["gloo_spans"] = sum(ev.get("args", {}).get("transport") == "gloo"
                            for ev in trace["traceEvents"])

    # calibrate: every rank sweeps, the tables merge with max, rank 0 saves
    ccomm = Communicator(grid, selector=Selector())
    path = pathlib.Path(scratch) / f"merged.rank{be.process_index}.json"
    rows = ccomm.calibrate(names=CALIBRATED, sizes=(NBYTES,), iters=2,
                           codecs=(), path=str(path))
    res["cal_rows"] = [(r.collective, autotune.encode_plan(r.algo, r.chunks,
                                                           r.codec),
                        r.seconds) for r in rows]
    res["cal_table"] = ccomm.selector.table.to_json()
    res["cal_auto"] = {c: ccomm.plan(c, NBYTES).algo for c in CALIBRATED}
    res["cal_path"] = str(path)

    # the data pipeline: this process generates only its slice
    ds = SyntheticLM(global_batch=2 * N, **DATA)
    res["data"] = (ds.host_batch, ds.host_offset, ds.batch(step=5)["tokens"])
    return res


# ---------------------------------------------------------------------------
# the spawns, once per module
# ---------------------------------------------------------------------------


def _reference(out_path: str) -> None:
    """The reference's (2, 2) Communicator on 4 host devices, every plan of
    its ``example_input`` operands, and its 1-process data batch."""
    import jax
    from repro.core import autotune as ja
    from repro.core import mcoll as jm
    from repro.core import runtime as jr
    from repro.core.comm import Communicator as JComm
    from repro.core.topology import Topology as JTopo
    from repro.data.pipeline import SyntheticLM as JLM

    mesh = jax.make_mesh((2, 2), ("node", "local"))
    topo = JTopo.from_mesh(mesh)
    comm = JComm(mesh, topo)
    res = {}
    for name in jr.collectives():
        x = np.asarray(jr.example_input(name, topo, NBYTES))
        res[f"in/{name}"] = x
        for algo in jm.algorithms(name):
            if algo in ja.candidates(name, topo):
                res[f"out/{name}/{algo}"] = np.asarray(
                    getattr(comm, name)(x, algo=algo))
    res["data/tokens"] = JLM(global_batch=2 * N, **DATA).batch(
        step=5)["tokens"]
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def worker_path():
    """The launcher's workers import this module by name."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH",
                  f"{HERE}:{os.environ.get('PYTHONPATH', '')}")
        yield


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("mp_ref") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{REPO / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return str(out), dict(z)


@pytest.fixture(scope="module")
def spawned_2x2(worker_path, reference):
    res = launch.run(_worker_2x2, reference[0], processes=2,
                     ranks_per_process=2, timeout=SPAWN_TIMEOUT)
    assert [r["rank"] for r in res] == [0, 1]
    return res


@pytest.fixture(scope="module")
def spawned_2x4(worker_path, tmp_path_factory):
    scratch = tmp_path_factory.mktemp("mp_2x4")
    res = launch.run(_worker_2x4, str(scratch), processes=2,
                     ranks_per_process=P, timeout=SPAWN_TIMEOUT)
    assert [r["rank"] for r in res] == [0, 1]
    return res


@pytest.fixture(scope="module")
def spawned_train(worker_path):
    res = launch.run(_worker_train, processes=2, ranks_per_process=2,
                     timeout=SPAWN_TIMEOUT)
    assert [r["rank"] for r in res] == [0, 1]
    return res


@pytest.fixture(scope="module")
def comm_2x4():
    return Communicator(RankGrid(N, P, "cpu"))


def _bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# 2x2: the reference's operands, every plan both packages list
# ---------------------------------------------------------------------------

PLANS_2x2 = _plans(Topology(2, 2))


@pytest.mark.parametrize("coll,algo", PLANS_2x2,
                         ids=[f"{c}/{a}" for c, a in PLANS_2x2])
def test_2x2_matches_reference_and_rank_grid(spawned_2x2, reference, coll,
                                             algo):
    _, ref = reference
    key = f"out/{coll}/{algo}"
    assert key in ref, f"the reference does not list {coll}/{algo}"
    one = Communicator(RankGrid(2, 2, "cpu")).invoke(
        coll, torch.from_numpy(ref[f"in/{coll}"]), algo=algo).numpy()
    _bitwise(one, ref[key])
    for r in spawned_2x2:
        _bitwise(r["out"][key], ref[key])


def test_2x2_lists_the_reference_plans(spawned_2x2, reference):
    _, ref = reference
    listed = {k for k in ref if k.startswith("out/")}
    assert listed == {f"out/{c}/{a}" for c, a in PLANS_2x2}
    for r in spawned_2x2:
        assert set(r["out"]) == listed
        assert r["topo_key"] == "2x2/host_ipc/host_cpu"


# ---------------------------------------------------------------------------
# 2x2: the train steps on the process grid against the one-process grid
# ---------------------------------------------------------------------------

TRAIN_LEGS = ("fused", "fused_int8_ef", "segmented")


@pytest.fixture(scope="module")
def train_one_process():
    n = torch.get_num_threads()
    try:
        return _train_legs(RankGrid(2, 2, "cpu"))
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("leg", TRAIN_LEGS)
def test_2x2_train_step_matches_rank_grid(spawned_train, train_one_process,
                                          leg):
    """Each process shards the batch to its own 2 ranks, computes their
    gradients, syncs over gloo and updates its weights from its first
    held row: losses, weights, m and v bitwise the one-process step's."""
    want = train_one_process[leg]
    assert all(b < a for a, b in zip(want["losses"], want["losses"][1:]))
    assert float(np.abs(want["m"]).max()) > 0
    for r in spawned_train:
        assert r["rows"] == 2
        got = r["legs"][leg]
        assert got["losses"] == want["losses"]
        for k in ("params", "m", "v"):
            _bitwise(got[k], want[k])


# ---------------------------------------------------------------------------
# 2x4: every plan, seeded floats, int32 and the codecs, against RankGrid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coll,algo,name,knobs", CASES,
                         ids=[_key(*c) for c in CASES])
def test_2x4_matches_rank_grid(spawned_2x4, comm_2x4, coll, algo, name,
                               knobs):
    x = torch.from_numpy(_operands()[name][coll])
    want = comm_2x4.invoke(coll, x, algo=algo, **knobs).numpy()
    for r in spawned_2x4:
        _bitwise(r["out"][_key(coll, algo, name, knobs)], want)


@pytest.mark.parametrize("algo,codec", CARRY_CASES,
                         ids=[f"{a}@{c}" for a, c in CARRY_CASES])
def test_2x4_carry_matches_rank_grid(spawned_2x4, comm_2x4, algo, codec):
    """Two error-feedback steps: each process's output and new error rows
    are bitwise the one-process grid's rows."""
    x = _operands()["wide"]["allreduce"]
    want = _carry_steps(comm_2x4, algo, codec, x, _carry_err(x))
    assert np.abs(want[1]).max() > 0  # the carry is live
    for r in spawned_2x4:
        rows = slice(r["offset"], r["offset"] + r["rows"])
        for got, w in zip(r["carry"][f"{algo}@{codec}"], want):
            _bitwise(got, w[rows])


def test_2x4_process_layout(spawned_2x4):
    for r in spawned_2x4:
        assert r["backend"] == "multiprocess" and r["process_count"] == 2
        assert r["rows"] == P and r["offset"] == P * r["rank"]
        assert r["axis_index"] == list(range(r["offset"],
                                             r["offset"] + P))
        assert r["links"] == ("host_ipc", "host_cpu")
        assert r["topo_key"] == "2x4/host_ipc/host_cpu"
        assert r["bytes_sent"] > 0


def test_2x4_held_operand_and_persistent_op(spawned_2x4, comm_2x4):
    ops = _operands()
    full = comm_2x4.allreduce(torch.from_numpy(ops["f32"]["allreduce"]),
                              algo="pip_mcoll").numpy()
    want = comm_2x4.alltoall(torch.from_numpy(ops["f32"]["alltoall"]),
                             algo="pip_mcoll").numpy()
    for r in spawned_2x4:
        _bitwise(r["held"], full[r["offset"]:r["offset"] + r["rows"]])
        for got in r["persistent"]:
            _bitwise(got, want)


@pytest.mark.parametrize("ax", ["node", "local"])
def test_2x4_axis_children(spawned_2x4, comm_2x4, ax):
    for coll in runtime.collectives():
        want = _child_call(comm_2x4, ax, coll).numpy()
        for r in spawned_2x4:
            _bitwise(r["split"][f"{ax}/{coll}"], want)


def test_2x4_color_splits(spawned_2x4, comm_2x4):
    """A color group inside one process runs there; one across processes
    runs over its members' processes, each holding its own members' rows
    of the one-process child's result, bitwise."""
    want = _color_results(comm_2x4, [0] * P + [1] * P, _operands())
    across = _color_results(comm_2x4, [0, 1] * P, _operands())
    for r in spawned_2x4:
        assert list(r["color"]) == [r["rank"]]
        _bitwise(r["color"][r["rank"]], want[r["rank"]])
        assert sorted(r["color_across"]) == [0, 1]
        for c, got in r["color_across"].items():
            ranks = range(c, WORLD, 2)  # the group in (key, rank) order
            held = [i for i, k in enumerate(ranks)
                    if r["offset"] <= k < r["offset"] + r["rows"]]
            assert len(held) == 2
            _bitwise(got, across[c][held])


def test_2x4_trace_carries_rank_and_gloo_spans(spawned_2x4):
    for r in spawned_2x4:
        assert r["trace_pids"] == [r["rank"]]
        assert r["gloo_spans"] > 0


def test_2x4_calibrate_merge(spawned_2x4):
    """One table, written by rank 0 alone, keyed on the process-aware
    topology; each plan the max over the ranks' medians; every rank holds
    the same table and resolves ``auto`` alike, to the table's argmin."""
    r0, r1 = spawned_2x4
    assert pathlib.Path(r0["cal_path"]).exists()
    assert not pathlib.Path(r1["cal_path"]).exists()
    saved = TuningTable.load(r0["cal_path"])
    assert saved.to_json() == r0["cal_table"] == r1["cal_table"]
    assert list(saved.entries) == ["2x4/host_ipc/host_cpu"]
    worst = {}
    for r in spawned_2x4:
        for coll, plan, sec in r["cal_rows"]:
            worst[coll, plan] = max(worst.get((coll, plan), 0.0), sec)
    topo = Topology(N, P, node_link="host_ipc", local_link="host_cpu")
    for coll in CALIBRATED:
        entry = saved.lookup(topo, coll, "float32", NBYTES)
        assert entry == {p: s for (c, p), s in worst.items() if c == coll}
        assert r0["cal_auto"][coll] == r1["cal_auto"][coll] == \
            autotune.decode_plan(min(entry, key=entry.get))[0]


def test_2x4_data_batch_is_the_one_process_batch(spawned_2x4, reference):
    parts = []
    for r in spawned_2x4:
        host_batch, host_offset, tokens = r["data"]
        assert (host_batch, host_offset) == (2, 2 * r["rank"])
        parts.append(tokens)
    stacked = np.concatenate(parts)
    single = SyntheticLM(global_batch=2 * N, **DATA).batch(step=5)["tokens"]
    np.testing.assert_array_equal(stacked, single)
    np.testing.assert_array_equal(stacked, reference[1]["data/tokens"])


if __name__ == "__main__":
    _reference(sys.argv[1])
