"""The ``"shm"`` transport (``distributed/transport.py``) on its own.

One spawn of three one-rank CPU processes (``launch.run``) with a slot
capacity of ``CAP`` bytes, so that nearly every payload goes in chunks and
two processes send each other more chunks than their two slots hold:

  * every dtype, fp8 wire forms, unsigned and bool included, from every
    process to every other at once, each direction its own size, arrives
    bit for bit; so does a one-element strided view;
  * empty sends and receives post nothing; a one-way exchange works; a
    ``ppermute`` of zero-byte rows crosses processes;
  * a ``(1, 3)`` ``ProcessGrid`` over the transport runs every collective
    under ``pip_mcoll`` and ``xla`` bitwise ``RankGrid(1, 3)``'s;
  * a peer that never posts makes the waiting process raise
    ``RuntimeError`` naming it, within a short timeout.

In process, on ``tests/test_torch_process_groups.py``'s stand-in group: a
``ShmTransport`` whose processes report another host, or on ``cuda``
another card, raises ``ValueError`` naming ROADMAP item 5b, as do CPU
slots that ``/dev/shm`` cannot hold; a grid refuses a transport by name or
on another device type; a grid handed none chooses gloo on CPU ranks and
``"shm"`` on the card when every process reports this card (gloo when one
reports another); ``derive_link`` keys a crossing axis ``host_ipc`` on
CPU ranks and ``h100_ipc`` on a stand-in ``cuda`` grid. On the card
(``-m cuda``): two processes' ``ppermute`` and ``all_to_all`` on the
grid's own choice, ``"shm"``, bitwise a gloo grid's, with no payload byte
through host memory.
"""
import os
import pathlib
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.core import autotune, costmodel, mcoll, runtime
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import ProcessGrid, RankGrid
from repro_torch.core.topology import Topology, derive_link
from repro_torch.distributed import backend, launch, transport

HERE = pathlib.Path(__file__).resolve().parent
#: the spawn's slot capacity: a payload above it goes in chunks
CAP = 64
PROCS = 3
SPAWN_TIMEOUT = 120
#: the silent peer's wait
SILENT_TIMEOUT_S = 1.0
DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
          torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
          torch.uint16, torch.uint32, torch.uint64, torch.bool,
          torch.float8_e4m3fn, torch.float8_e5m2, torch.complex64)
#: the grid leg's collectives and algorithms
GRID_ALGOS = ("pip_mcoll", "xla")


def _payload(dtype, src, dst, i):
    """What process ``src`` sends ``dst`` in round ``i``: random bits
    (bool: 0 or 1), a size of its own for each direction."""
    n = 3 * CAP + 13 * src + 7 * dst + i
    size = torch.empty((), dtype=dtype).element_size()
    bits = np.random.default_rng([src, dst, i]).integers(
        0, 256, size=n * size, dtype=np.uint8)
    if dtype == torch.bool:
        bits %= 2
    return torch.from_numpy(bits).view(dtype)


def _grid_cases():
    return [(c, a) for c in runtime.collectives() for a in GRID_ALGOS
            if a in mcoll.algorithms(c)]


def _grid_input(coll):
    return runtime.example_input(coll, Topology(1, PROCS), 200, device="cpu")


def _worker():
    torch.set_num_threads(1)
    me = backend.process_rank()
    peers = [j for j in range(PROCS) if j != me]
    tr = transport.ShmTransport("cpu", capacity=CAP)
    res = {"rank": me, "dtypes": {}}
    for i, dt in enumerate(DTYPES):
        recvs = {j: torch.empty(_payload(dt, j, me, i).numel()
                                * _payload(dt, j, me, i).element_size(),
                                dtype=torch.uint8) for j in peers}
        res["dtypes"][str(dt)] = (tr.exchange(
            "test", {j: _payload(dt, me, j, i) for j in peers}, recvs),
            {j: r.numpy().tobytes() for j, r in recvs.items()})
    # a one-element view with a stride of 4 elements
    view = (torch.arange(12.0) + me).reshape(3, 4)[1:2, 2]
    assert view.stride() == (4,)
    got = {j: torch.empty(4, dtype=torch.uint8) for j in peers}
    tr.exchange("view", {j: view for j in peers}, got)
    res["view"] = {j: g.view(torch.float32).item() for j, g in got.items()}
    # empty both ways: nothing posted; then one way, 0 -> 1 only
    posted = tr._block.posted.copy()
    res["empty_host_bytes"] = tr.exchange(
        "empty", {j: torch.empty(0) for j in peers},
        {j: torch.empty(0, dtype=torch.uint8) for j in peers})
    res["empty_posted_same"] = bool((tr._block.posted == posted).all())
    one = {1: torch.full((100,), 7, dtype=torch.int16)} if me == 0 else {}
    back = {0: torch.empty(200, dtype=torch.uint8)} if me == 1 else {}
    tr.exchange("one_way", one, back)
    res["one_way"] = {j: b.view(torch.int16).unique().tolist()
                      for j, b in back.items()}
    # every collective through a grid over this transport
    comm = Communicator(ProcessGrid(1, PROCS, "cpu", transport=tr))
    res["grid"] = {f"{c}/{a}": backend.to_host(
        comm.invoke(c, _grid_input(c), algo=a), comm.grid).numpy()
        for c, a in _grid_cases()}
    res["grid_bytes"] = (comm.grid.bytes_sent, comm.grid.host_bytes)
    # rows of no bytes: nothing to send, an empty result
    ring = [(k, (k + 1) % PROCS) for k in range(PROCS)]
    res["zero_rows"] = tuple(comm.grid.ppermute(
        torch.empty((1, 0, 3)), "local", ring).shape)
    res["slot_bytes"] = tr.slot_bytes
    tr.close()
    # process 1 waits for a chunk process 0 never posts
    silent = transport.ShmTransport("cpu", capacity=CAP,
                                    timeout_s=SILENT_TIMEOUT_S)
    if me == 1:
        t0 = time.monotonic()
        try:
            silent.exchange("silent", {},
                            {0: torch.empty(8, dtype=torch.uint8)})
        except RuntimeError as err:
            res["silent"] = (str(err), time.monotonic() - t0)
    silent.close()
    return res


@pytest.fixture(scope="module")
def spawned():
    with pytest.MonkeyPatch.context() as mp:
        # the workers import this module by name, one thread each
        mp.setenv("PYTHONPATH", f"{HERE.parent / 'src'}:{HERE}:"
                  f"{os.environ.get('PYTHONPATH', '')}")
        mp.setenv("OMP_NUM_THREADS", "1")
        out = launch.run(_worker, processes=PROCS, ranks_per_process=1,
                         timeout=SPAWN_TIMEOUT)
    assert [r["rank"] for r in out] == list(range(PROCS))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunked_payloads_arrive_bit_for_bit(spawned, dtype):
    i = DTYPES.index(dtype)
    for r in spawned:
        me = r["rank"]
        host, got = r["dtypes"][str(dtype)]
        want = {j: _payload(dtype, j, me, i) for j in got}
        assert all(w.numel() * w.element_size() > 2 * CAP
                   for w in want.values())  # more chunks than slots
        for j, w in want.items():
            assert got[j] == transport.as_bytes(w).numpy().tobytes()
        sent = sum(_payload(dtype, me, j, i).numel() for j in got)
        assert host == (sent + sum(w.numel() for w in want.values())) \
            * want[next(iter(want))].element_size()  # CPU ranks: all host


def test_strided_one_element_view(spawned):
    for r in spawned:
        assert r["view"] == {j: 6.0 + j for j in r["view"]}


def test_empty_and_one_way_exchanges(spawned):
    for r in spawned:
        assert r["empty_host_bytes"] == 0 and r["empty_posted_same"]
        assert r["one_way"] == ({0: [7]} if r["rank"] == 1 else {})


@pytest.mark.parametrize("coll,algo", _grid_cases(),
                         ids=[f"{c}/{a}" for c, a in _grid_cases()])
def test_grid_over_small_slots_matches_rank_grid(spawned, coll, algo):
    want = Communicator(RankGrid(1, PROCS, "cpu")).invoke(
        coll, _grid_input(coll), algo=algo).numpy()
    for r in spawned:
        got = r["grid"][f"{coll}/{algo}"]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        sent, host = r["grid_bytes"]
        assert sent > 0 and host > sent  # sent and received, host memory
        assert r["slot_bytes"] == 2 * CAP * (PROCS - 1)


def test_zero_size_rows_cross_processes(spawned):
    assert all(r["zero_rows"] == (1, 0, 3) for r in spawned)


def test_silent_peer_raises_within_the_timeout(spawned):
    msg, waited = spawned[1]["silent"]
    assert "process 0" in msg and "pair 0->1" in msg and "chunk 0" in msg
    assert SILENT_TIMEOUT_S <= waited < SILENT_TIMEOUT_S + 5
    assert all("silent" not in r for r in spawned if r["rank"] != 1)


# ---------------------------------------------------------------------------
# in process: a stand-in process group
# ---------------------------------------------------------------------------


@pytest.fixture
def group(monkeypatch):
    """``group(n, rank, others)``: this process as ``rank`` of ``n`` gloo
    processes, whose ``all_gather_object`` gives the others' entries as
    ``others(entry, i)`` makes them from this process's."""
    def make(n, rank, others=lambda mine, i: dict(mine)):
        monkeypatch.setattr(tdist, "is_initialized", lambda: True)
        monkeypatch.setattr(tdist, "get_backend", lambda *a: "gloo")
        monkeypatch.setattr(tdist, "get_world_size", lambda *a: n)
        monkeypatch.setattr(tdist, "get_rank", lambda *a: rank)

        def gather(out, obj):
            for i in range(n):
                out[i] = obj if i == rank else others(obj, i)
        monkeypatch.setattr(tdist, "all_gather_object", gather)
    return make


def test_shm_grid_on_another_host_raises(group):
    group(2, 1, lambda mine, i: {**mine, "host": "elsewhere/0",
                                 "block": "psm_unused"})
    with pytest.raises(ValueError, match="one host.*item 5b"):
        transport.ShmTransport("cpu")


def test_shm_grid_on_another_card_raises(group, monkeypatch):
    monkeypatch.setattr(transport, "_card_id", lambda device: "GPU-mine")
    group(2, 1, lambda mine, i: {**mine, "card": "GPU-other",
                                 "block": "psm_unused"})
    with pytest.raises(ValueError, match="one card.*item 5b"):
        transport.ShmTransport("cuda")


def test_shm_slots_beyond_dev_shm_raise(group, monkeypatch):
    """CPU slots that ``/dev/shm`` cannot hold raise on every process,
    naming the shortfall, before any slot is made."""
    monkeypatch.setattr(transport, "_shm_free", lambda: 1000)
    group(2, 1, lambda mine, i: {**mine, "block": "psm_unused"})
    with pytest.raises(ValueError, match="need 4096 bytes.*1000 free: "
                                         "3096 short"):
        transport.ShmTransport("cpu", capacity=1024)


def test_unknown_transport_raises(group):
    """A transport is an instance: a name raises (the grid chooses its own
    when handed none)."""
    group(2, 0)
    for name in ("nccl", "shm"):
        with pytest.raises(TypeError, match="a Transport instance"):
            ProcessGrid(2, 4, "cpu", transport=name)


def test_transport_on_another_device_raises(group, monkeypatch):
    monkeypatch.setattr(transport, "CLOSE_GRACE_S", 0.0)
    group(2, 0)
    tr = transport.ShmTransport("cpu")
    try:
        with pytest.raises(ValueError, match="moves only cpu tensors"):
            ProcessGrid(2, 4, "cuda", transport=tr)
    finally:
        tr.close()


class _Chosen(transport.Transport):
    """A stand-in for the ``ShmTransport`` that ``choose`` makes."""
    name = "shm"

    def __init__(self, device):
        self.device = torch.device(device)


def test_grid_chooses_its_transport(group, monkeypatch):
    """gloo on CPU ranks with no collective step; on the card ``"shm"``
    when every process reports this host and card (one transport for the
    process group, one step), gloo when one reports another card."""
    monkeypatch.setattr(transport, "_CHOSEN", {})
    monkeypatch.setattr(transport, "ShmTransport", _Chosen)
    monkeypatch.setattr(transport, "_card_id", lambda device: "GPU-mine")
    steps = []

    def others(mine, i):
        steps.append(i)
        return mine
    group(2, 1, others)
    cpu = ProcessGrid(2, 4, "cpu")
    assert isinstance(cpu.transport, transport.GlooTransport) and not steps
    card = ProcessGrid(2, 4, "cuda")
    assert isinstance(card.transport, _Chosen) and steps == [0]
    assert autotune.topo_key(Topology.from_grid(card)) == \
        "2x4/h100_ipc/h100_grid"
    assert ProcessGrid.over([0, 1, 1, 0], "cuda").transport \
        is card.transport and steps == [0]
    monkeypatch.setattr(transport, "_CHOSEN", {})
    group(2, 1, lambda mine, i: (mine[0], "GPU-other"))
    other = ProcessGrid(2, 4, "cuda")
    assert isinstance(other.transport, transport.GlooTransport)
    assert autotune.topo_key(Topology.from_grid(other)) == \
        "2x4/host_ipc/h100_grid"


class _CudaShmGrid:
    """A stand-in ``ProcessGrid(2, 4, "cuda")`` of eight one-rank processes
    on one card, which chooses ``"shm"``: every axis crosses processes."""
    axis_names = ("node", "local")
    shape = {"node": 2, "local": 4}
    device = torch.device("cuda", 0)
    transport = types.SimpleNamespace(name="shm")

    def crosses(self, axis):
        return True


def test_derive_link_keys(group, monkeypatch):
    """``host_ipc`` for a crossing axis of a CPU ``"shm"`` grid (the
    reference's constants), ``h100_ipc`` on the card."""
    monkeypatch.setattr(transport, "CLOSE_GRACE_S", 0.0)
    group(2, 0)
    grid = ProcessGrid(2, 2, "cpu", transport=transport.ShmTransport("cpu"))
    try:
        assert grid.transport.name == "shm" and grid.process_count == 2
        assert autotune.topo_key(Topology.from_grid(grid)) == \
            "2x2/host_ipc/host_cpu"
        assert ProcessGrid(2, 2, "cpu") != grid  # the transport is keyed
    finally:
        grid.transport.close()
    topo = Topology.from_grid(_CudaShmGrid())
    assert autotune.topo_key(topo) == "2x4/h100_ipc/h100_ipc"
    assert derive_link(_CudaShmGrid(), "local", "intra") == "h100_ipc"
    assert costmodel.net_for(topo) == costmodel.NET_PRESETS["h100_ipc"]()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda_worker():
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}
    # gloo handed in, then the grid's own choice, "shm" on one card
    for name, tr in (("gloo", transport.GlooTransport()), ("shm", None)):
        grid = ProcessGrid(1, 2, dev, transport=tr)
        assert grid.transport.name == name
        me = grid.rank
        gen = torch.Generator(dev).manual_seed(7 + me)
        # 5 MiB a rank: more than one 4 MiB slot
        x = torch.randn((1, 5 << 18), device=dev, generator=gen)
        y = torch.randint(-9, 9, (1, 2, 3 << 19), device=dev,
                          generator=gen, dtype=torch.int32)
        res = [grid.ppermute(x, "local", [(0, 1), (1, 0)]),
               grid.all_to_all(y, "local", 0, 0)]
        torch.cuda.synchronize()
        out[name] = {"results": [r.cpu().numpy() for r in res],
                     "host_bytes": grid.host_bytes,
                     "bytes_sent": grid.bytes_sent}
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_shm_exchanges_match_gloo(cuda, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", f"{HERE.parent / 'src'}:{HERE}:"
                       f"{os.environ.get('PYTHONPATH', '')}")
    for r in launch.run(_cuda_worker, processes=2, ranks_per_process=1,
                        timeout=SPAWN_TIMEOUT):
        for got, want in zip(r["shm"]["results"], r["gloo"]["results"]):
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8))
        assert r["shm"]["host_bytes"] == 0
        assert r["shm"]["bytes_sent"] == r["gloo"]["bytes_sent"] > 0
        assert r["gloo"]["host_bytes"] == 2 * r["gloo"]["bytes_sent"]
