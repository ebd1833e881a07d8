"""Process groups on CPU ranks over gloo: any axis of a ``ProcessGrid``
crosses processes, down to one rank a process, and the expert-parallel
MoE, the sharded train step and the serving sync run on such a grid.

Two spawns and a reference subprocess per module, started together (each
spawn under ``launch.run``'s deadline, one intra-op thread a worker; the
parent computes the one-process ``RankGrid`` results meanwhile):

  * A: ``ProcessGrid(2, 2)`` over four one-rank processes, so the local
    axis crosses processes too. Every plan of ``PLANS_2x2`` on the
    reference's ``example_input`` operands, bitwise the reference's
    ``(2, 2)`` Communicator (this file's ``__main__``, 4 forced host
    devices) and ``RankGrid(2, 2)``; the ``("node",)`` and ``("local",)``
    children and two color splits across processes (``[0, 1] * 2``, with
    and without a key that reverses each group), bitwise the one-process
    children's rows; three int8 error-feedback sync steps; reduced
    qwen3-moe's expert-parallel layer with TP over ``local``; a reduced
    smollm ``Engine`` whose synced tokens must be the sync-free engine's.
  * B: ``ProcessGrid(2, 4)`` over four processes of two ranks, so each
    node is two processes. Every collective under ``pip_mcoll`` and
    ``xla`` where it has it (float32 with a -0.0 and int32), binomial
    scatter, Bruck's allgather and an int8 allreduce, a color split
    whose key interleaves processes, the EP layer with TP crossing a
    process boundary inside a node, and two ``train_step(..., rules=,
    grid=)`` steps of reduced qwen3-moe.

The MoE's forward (bf16 tokens and experts, float32 router, numpy-seeded)
under every lossless plan forced through ``Communicator.plan`` must be
bitwise ``RankGrid``'s and, on the ``(2, 2)`` grid, within
``tests/test_torch_moe.py``'s bars of the reference's ``moe.apply`` (y
within ``2^-6`` of the largest |y|, aux within ``1e-5``). Its backward
(float32 weights and tokens, ``sum(y * r)``) must be bitwise
``RankGrid``'s: every process routes every rank's slice, so the router's
and ``x``'s gradients come from the same operations on the same
operands, and each expert's gradient sums the ranks that routed rows to
it in rank order, which with two ranks an expert (two nodes here) is the
order autograd's own sum takes, since a sum of two terms does not depend
on it. (Where three or more ranks share an expert the order differs and
the bar would be ``tests/test_torch_moe_backward.py``'s float32 ``1e-5``
of each leaf's largest entry; no layout here has that.) The train step's
loss, every gradient leaf and AdamW's ``m`` and ``v`` must be bitwise
``RankGrid(2, 4)``'s, on every process.

Every worker runs its legs twice in the same spawn: on the transport the
grid chooses (gloo, on CPU ranks) and on a grid handed a
``ShmTransport("cpu")`` of ``SHM_SLOT`` bytes a slot; every result of the
second must be bitwise the first's and meet the same bars.

In process, with ``tests/test_torch_distributed.py``'s stand-in group:
the held rows and ``axis_index`` of ``ProcessGrid(2, 4)`` over 8 and 4
processes, ``derive_link``'s keys against the reference's on
``tests/test_multiprocess.py``-style fake meshes, counts that do not divide
``n_local``, and a color child of which a process holds no member.
"""
import concurrent.futures
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.core import autotune, mcoll, runtime
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import ProcessGrid, RankGrid
from repro_torch.core.topology import Topology, derive_link
from repro_torch.distributed import backend, launch
from repro_torch.distributed.transport import ShmTransport

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
#: seconds a spawn may take before its workers are killed
SPAWN_TIMEOUT = 300
#: the "shm" grids' slot bytes: payloads above it go in chunks
SHM_SLOT = 1 << 20
NBYTES = 4096
MOE_ARCH = "qwen3-moe-235b-a22b"
#: name -> (algo, chunks) forced through Communicator.plan
LOSSLESS = {"pip_mcoll": ("pip_mcoll", 1),
            "pip_pipeline_c2": ("pip_pipeline", 2), "xla": ("xla", 1)}
#: capacity factor: None is the TP size (nothing drops), else the value
CAPS = {"tp": None, "default": 1.25}
MOE_S = 8
#: tests/test_torch_moe.py's bars against the reference
Y_TOL, AUX_TOL = 2.0 ** -6, 1e-5
#: the EF sync steps: codec, budget, buckets of BUCKET elements
EF_CODEC, EF_BUDGET, EF_TOTAL, EF_BUCKET, EF_STEPS = (
    "int8_block", 0.5 / 127, 3 * 4096 + 100, 4096, 3)
#: the engine leg (reduced smollm)
SERVE_BATCH, SERVE_LEN, SERVE_NEW = 4, 64, 6
SERVE_PROMPTS = (12, 3, 7, 9, 5)
#: B's collectives: every collective under these algorithms where it has
#: them, and a few more
B_ALGOS = ("pip_mcoll", "xla")
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0,
                 weight_decay=0.1)


def _plans(topo):
    return [(c, a) for c in runtime.collectives()
            for a in mcoll.algorithms(c) if a in autotune.candidates(c, topo)]


PLANS_2x2 = _plans(Topology(2, 2))


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _np(t):
    """A tensor as numpy, bf16 as its int16 bit pattern (numpy has no
    bf16)."""
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# the legs: one function per leg, run by the workers and by the parent
# ---------------------------------------------------------------------------


def _held_rows(grid, member_ranks):
    """The member indices of a group (its ranks in member order) that
    this process holds."""
    return [i for i, r in enumerate(member_ranks) if r in grid.held]


def _collectives_2x2(comm):
    grid = comm.grid
    out = {}
    for coll, algo in PLANS_2x2:
        x = runtime.example_input(coll, comm.topo, NBYTES, device="cpu")
        out[f"{coll}/{algo}"] = backend.to_host(
            comm.invoke(coll, x, algo=algo), grid).numpy()
    return out


def _b_operands():
    """collective -> global float32 (a -0.0 on rank 0) and int32 operands
    of the 2x4 grid."""
    rng = np.random.default_rng(4321)
    W = 8
    shapes = {"allgather": (W * 5,), "scatter": (W * 5,), "broadcast": (37,),
              "allreduce": (W, 45), "reduce_scatter": (W, W * 6),
              "alltoall": (W, W, 5)}
    out = {}
    for coll, shape in shapes.items():
        f = rng.standard_normal(shape).astype(np.float32)
        f.reshape(-1)[3] = -0.0
        out[coll] = {"f32": f, "i32": rng.integers(-1000, 1000, shape)
                     .astype(np.int32)}
    return out


B_CASES = [(c, a, d) for c in runtime.collectives() for a in B_ALGOS
           if a in mcoll.algorithms(c) for d in ("f32", "i32")] + [
    ("scatter", "binomial", "f32"), ("allgather", "bruck", "f32"),
    ("allreduce", "pip_mcoll", "int8")]


def _collectives_2x4(comm):
    ops = _b_operands()
    out = {}
    for coll, algo, dt in B_CASES:
        knobs = {"codec": "int8_block"} if dt == "int8" else {}
        x = torch.from_numpy(ops[coll]["f32" if dt == "int8" else dt]
                             * (30 if dt == "int8" else 1))
        out[f"{coll}/{algo}/{dt}"] = backend.to_host(
            comm.invoke(coll, x, algo=algo, **knobs), comm.grid).numpy()
    return out


def _children(comm):
    """Every collective through the ``("node",)`` and ``("local",)``
    children on their ``example_input`` operands, the full result."""
    out = {}
    for ax in ("node", "local"):
        child = comm.split(axes=ax)
        for coll in runtime.collectives():
            x = runtime.example_input(coll, child.topo, 96,
                                      devices=comm.grid.world, device="cpu")
            out[f"{ax}/{coll}"] = backend.to_host(
                child.invoke(coll, x, algo="pip_mcoll"), comm.grid).numpy()
    return out


def _color_splits(comm, splits):
    """``{split: {color: (held member indices, allreduce rows, alltoall
    rows)}}``: each child's collectives on its group's operand, the rows
    this process holds (every row on a one-process grid)."""
    grid, W = comm.grid, comm.grid.world
    rng = np.random.default_rng(8)
    x = rng.standard_normal((W, 33)).astype(np.float32)
    out = {}
    for name, (color, key) in splits.items():
        out[name] = {}
        for c, child in comm.split(color=color, key=key).items():
            held = _held_rows(grid, child.ranks)
            if not held:
                continue
            G = len(child.ranks)
            a2a = np.random.default_rng([9, c]).standard_normal(
                (G, G, 3)).astype(np.float32)
            out[name][c] = (
                held, child.ranks,
                child.allreduce(torch.from_numpy(x[list(child.ranks)]),
                                algo="pip_mcoll").numpy(),
                child.alltoall(torch.from_numpy(a2a),
                               algo="pip_mcoll").numpy())
    return out


A_SPLITS = {"alternate": ([0, 1] * 2, None),
            "alternate_reversed": ([0, 1] * 2, [3, 2, 1, 0])}
#: the key interleaves processes: member order 0 4 1 5 2 6 3 7, so each
#: process of two ranks holds members two apart
B_SPLITS = {"interleaved": ([0] * 8, [0, 2, 4, 6, 1, 3, 5, 7]),
            "alternate_reversed": ([0, 1] * 4, list(range(8))[::-1])}


def _ef_steps(comm):
    """``EF_STEPS`` int8 error-feedback bucketed sync steps of a gradient
    whose rank rows are seeded by global rank; per step the held rows of
    every bucket's output and of the carried error."""
    from repro_torch.train import manual_step as ms
    grid = comm.grid
    slices = ms.bucket_slices(EF_TOTAL, EF_BUCKET)
    gs = ms.OverlappedGradSync(comm, slices, metric_len=2, algo="pip_mcoll",
                               codec=EF_CODEC, error_budget=EF_BUDGET)
    gs.ensure_ops(0)
    out = []
    for step in range(EF_STEPS):
        g = torch.stack([torch.from_numpy(np.random.default_rng(
            [step, r]).standard_normal(EF_TOTAL).astype(np.float32) * 1e-2)
            for r in grid.held])
        mvec = torch.ones((grid.rows, 2))
        synced, _ = gs.sync([g[:, s:s + n] for s, n in slices], mvec)
        out.append(([y.numpy().copy() for y in synced],
                    [e.numpy().copy() for e in gs.errs]))
    gs.release()
    return out


def _moe_params(E, D, F):
    rng = np.random.default_rng(5)
    f = lambda shape, scale: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    return {"router": f((D, E), D ** -0.5), "w_gate": f((E, D, F), D ** -0.5),
            "w_up": f((E, D, F), D ** -0.5), "w_down": f((E, F, D), F ** -0.5)}


def _moe_inputs(dp, D):
    rng = np.random.default_rng(11 + dp)
    return (rng.standard_normal((2 * dp, MOE_S, D)).astype(np.float32),
            rng.standard_normal((2 * dp, MOE_S, D)).astype(np.float32))


def _moe_cfg(cap, tp):
    from repro_torch.configs import reduced_config
    cfg = reduced_config(MOE_ARCH)
    factor = float(tp) if CAPS[cap] is None else CAPS[cap]
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def _forced(algo, chunks):
    def plan(self, collective, nbytes, dtype="float32", error_budget=0.0):
        return autotune.Selection(collective, algo, 0.0, "prior", "",
                                  chunks=chunks)
    return plan


def _moe(grid):
    """Reduced qwen3-moe's EP layer on ``grid`` (batch over ``node``, TP
    over ``local``): per capacity and lossless plan the bf16 forward's y,
    aux, routing ids and kept flags; per capacity the float32 backward's
    gradients of ``sum(y * r)`` under ``pip_mcoll``."""
    from repro_torch.core import comm as tcomm
    from repro_torch.layers import moe as tmoe
    from repro_torch.sharding.rules import Rules

    rules = Rules(batch=("node",), tp="local")
    dp, tp = grid.n_nodes, grid.n_local
    kept_plan = tcomm.Communicator.plan
    out = {}
    try:
        for cap in CAPS:
            cfg = _moe_cfg(cap, tp)
            E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
            p = _moe_params(E, D, F)
            x, r = _moe_inputs(dp, D)
            for dtype in (torch.bfloat16, torch.float32):
                layer = tmoe.MoE(cfg, device="cpu")
                with torch.no_grad():
                    for name, w in layer.named_parameters():
                        w.copy_(torch.from_numpy(p[name]))
                if dtype == torch.float32:
                    layer = layer.float()
                    tcomm.Communicator.plan = _forced("pip_mcoll", 1)
                    xt = torch.from_numpy(x).requires_grad_()
                    y, aux = layer.requires_grad_(True)(
                        xt, rules=rules, grid=grid)
                    leaves = [layer.router, layer.w_gate, layer.w_up,
                              layer.w_down, xt]
                    grads = torch.autograd.grad(
                        (y * torch.from_numpy(r)).sum() + aux, leaves)
                    out[f"{cap}/grads"] = [g.numpy() for g in grads]
                    continue
                xb = torch.from_numpy(x).bfloat16()
                for name, (algo, chunks) in LOSSLESS.items():
                    tcomm.Communicator.plan = _forced(algo, chunks)
                    with torch.no_grad():
                        y, aux = layer(xb, rules=rules, grid=grid)
                    out[f"{cap}/{name}"] = {
                        "y": _np(y), "aux": float(aux),
                        "ids": layer.ep_routing["ids"].numpy(),
                        "kept": layer.ep_routing["kept"].numpy()}
    finally:
        tcomm.Communicator.plan = kept_plan
    return out


def _engine(grid):
    """The reduced smollm engine's tokens with the tick sync on ``grid``
    (``None``: the sync-free engine)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.serve.engine import Engine, Request

    cfg = reduced_config("smollm-360m")
    model = DecoderLM(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(n,),
                                        dtype=np.int32),
                    max_new_tokens=SERVE_NEW) for n in SERVE_PROMPTS]
    eng = Engine(model, cfg, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                 mesh=grid)
    done = eng.run(reqs)
    m = eng.metrics()
    return {"tokens": {tuple(r.prompt.tolist()): r.out_tokens
                       for r in done},
            "ticks": m["ticks"], "sync_starts": m["sync_starts"]}


def _train(grid):
    """Two ``train_step(..., rules=, grid=)`` steps of reduced qwen3-moe
    (float32, seeded weights): the first batch's gradient (flat), each
    step's loss, and the weights, ``m`` and ``v`` after each step."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.decoder import DecoderLM, RunFlags
    from repro_torch.models.params import FlatParams
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import Rules
    from repro_torch.train.step import TrainConfig, train_step, value_and_grad

    cfg = reduced_config(MOE_ARCH)
    model = DecoderLM(cfg, torch.Generator().manual_seed(0),
                      device="cpu").float()
    model.trainable()
    flat = FlatParams.of(model)
    ocfg = adamw.AdamWConfig(**TRAIN_OPT)
    opt = adamw.init(flat, ocfg)
    tcfg = TrainConfig(optimizer=ocfg, flags=RunFlags(
        remat="none", logits_dtype="float32"))
    kw = dict(rules=Rules(batch=("node",), tp="local"), grid=grid)
    out = {"blocks_ep": [], "steps": []}
    for s in range(2):
        toks = torch.from_numpy(np.random.default_rng(30 + s).integers(
            0, 512, size=(4, 17))).long()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if s == 0:
            _, _, grads = value_and_grad(model, flat, batch, tcfg, **kw)
            out["grad"] = flat.gather(grads).numpy().copy()
            del grads
        mets = train_step(model, opt, batch, tcfg, flat, **kw)
        out["steps"].append({"loss": float(mets["loss"]),
                             "params": flat.read().numpy().copy(),
                             "m": opt["m"].numpy().copy(),
                             "v": opt["v"].numpy().copy()})
    out["blocks_ep"] = [tuple(b.moe.ep_routing["ids"].shape)
                        for b in model.blocks if hasattr(b, "moe")
                        and hasattr(b.moe, "ep_routing")]
    return out


def _layout(comm):
    grid = comm.grid
    return {"rank": grid.rank, "held": grid.held, "rows": grid.rows,
            "process_count": grid.process_count,
            "topo_key": autotune.topo_key(comm.topo),
            "links": comm.topo.link_names,
            "axis_index": {ax: grid.axis_index(ax).tolist()
                           for ax in ("node", "local")}}


# ---------------------------------------------------------------------------
# the workers (module-level: the launcher imports them by name)
# ---------------------------------------------------------------------------


def _legs_a(comm):
    return {"transport": comm.grid.transport.name,
            "layout": _layout(comm), "plans": _collectives_2x2(comm),
            "children": _children(comm),
            "colors": _color_splits(comm, A_SPLITS), "ef": _ef_steps(comm),
            "moe": _moe(comm.grid), "engine": _engine(comm.grid),
            "bytes_sent": comm.grid.bytes_sent,
            "host_bytes": comm.grid.host_bytes}


def _legs_b(comm):
    return {"transport": comm.grid.transport.name,
            "layout": _layout(comm), "plans": _collectives_2x4(comm),
            "colors": _color_splits(comm, B_SPLITS), "moe": _moe(comm.grid),
            "train": _train(comm.grid), "bytes_sent": comm.grid.bytes_sent,
            "host_bytes": comm.grid.host_bytes}


def _worker(shape, legs):
    """Every leg on the grid's own transport, then on a grid handed a
    ``ShmTransport`` (under ``"shm"``)."""
    torch.set_num_threads(1)
    out = legs(Communicator(ProcessGrid(*shape, "cpu")))
    shm = ShmTransport("cpu", capacity=SHM_SLOT)
    out["shm"] = legs(Communicator(ProcessGrid(*shape, "cpu",
                                               transport=shm)))
    out["shm"]["slot_bytes"] = shm.slot_bytes
    return out


def _worker_a():
    return _worker((2, 2), _legs_a)


def _worker_b():
    return _worker((2, 4), _legs_b)


def _parent():
    """The one-process grids' results of every leg."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers' arithmetic
    try:
        a = Communicator(RankGrid(2, 2, "cpu"))
        b = Communicator(RankGrid(2, 4, "cpu"))
        return {"a": {"plans": _collectives_2x2(a), "children": _children(a),
                      "colors": _color_splits(a, A_SPLITS), "ef": _ef_steps(a),
                      "moe": _moe(a.grid), "engine": _engine(None)},
                "b": {"plans": _collectives_2x4(b),
                      "colors": _color_splits(b, B_SPLITS),
                      "moe": _moe(b.grid), "train": _train(b.grid)}}
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the reference: the (2, 2) Communicator's plans and moe.apply on (2, 2)
# ---------------------------------------------------------------------------


def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from jax.sharding import Mesh

    import torch_family as tf
    from repro.configs import reduced_config as jreduced
    from repro.core import autotune as ja
    from repro.core import comm as jcomm
    from repro.core import mcoll as jm
    from repro.core import runtime as jr
    from repro.core.topology import Topology as JTopo
    from repro.layers import moe as jmoe
    from repro.sharding.rules import Rules as JRules

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("node", "local"))
    topo = JTopo.from_mesh(mesh)
    comm = jcomm.Communicator(mesh, topo)
    res = {}
    for name in jr.collectives():
        x = np.asarray(jr.example_input(name, topo, NBYTES))
        res[f"in/{name}"] = x
        for algo in jm.algorithms(name):
            if algo in ja.candidates(name, topo):
                res[f"out/{name}/{algo}"] = np.asarray(
                    getattr(comm, name)(x, algo=algo))

    def plan(self, collective, nbytes, dtype="float32", error_budget=0.0):
        return ja.Selection(collective, "pip_mcoll", 0.0, "prior", "")
    jcomm.Communicator.plan = plan
    rules = JRules(batch=("node",), tp="local")
    for cap, factor in CAPS.items():
        base = jreduced(MOE_ARCH)
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=2.0 if factor is None else factor))
        p = _moe_params(cfg.moe.n_experts, cfg.d_model,
                        cfg.moe.d_ff_expert)
        params = {k: jnp.asarray(v if k == "router"
                                 else v.astype(ml_dtypes.bfloat16))
                  for k, v in p.items()}
        x = jnp.asarray(_moe_inputs(2, cfg.d_model)[0].astype(
            ml_dtypes.bfloat16))
        fn = jax.jit(lambda p_, x_, cfg=cfg: jmoe.apply(
            p_, x_, cfg, rules=rules, mesh=mesh))
        y, aux = tf.fast_compile(fn, params, x)(params, x)
        res[f"moe/{cap}/y"] = np.asarray(y, np.float32)
        res[f"moe/{cap}/aux_mean"] = np.asarray(aux.mean())
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the spawns, once per module, with the reference and the parent's runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    ref_path = tmp_path_factory.mktemp("pg_ref") / "ref.npz"
    path = f"{REPO / 'src'}:{HERE}:{os.environ.get('PYTHONPATH', '')}"
    ref = subprocess.Popen(
        [sys.executable, __file__, str(ref_path)],
        env=dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with pytest.MonkeyPatch.context() as mp:
        # the workers import this module by name, one thread each
        mp.setenv("PYTHONPATH", path)
        mp.setenv("OMP_NUM_THREADS", "1")
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            a = ex.submit(launch.run, _worker_a, processes=4,
                          ranks_per_process=1, timeout=SPAWN_TIMEOUT)
            b = ex.submit(launch.run, _worker_b, processes=4,
                          ranks_per_process=2, timeout=SPAWN_TIMEOUT)
            try:
                parent = _parent()
            finally:
                spawned = {"a": a.result(), "b": b.result()}
    try:
        _, err = ref.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-4000:]
    with np.load(ref_path) as z:
        reference = dict(z)
    for k in ("a", "b"):
        assert [r["layout"]["rank"] for r in spawned[k]] == [0, 1, 2, 3]
    return {"parent": parent, "ref": reference, **spawned}


# ---------------------------------------------------------------------------
# A: ProcessGrid(2, 2) over four one-rank processes
# ---------------------------------------------------------------------------


def test_a_layout(runs):
    for r in runs["a"]:
        lay = r["layout"]
        assert lay["held"] == (lay["rank"],) and lay["rows"] == 1
        assert lay["process_count"] == 4
        assert lay["topo_key"] == "2x2/host_ipc/host_ipc"
        assert lay["axis_index"] == {"node": [lay["rank"] // 2],
                                     "local": [lay["rank"] % 2]}
        assert r["bytes_sent"] > 0


@pytest.mark.parametrize("coll,algo", PLANS_2x2,
                         ids=[f"{c}/{a}" for c, a in PLANS_2x2])
def test_a_plans_match_reference_and_rank_grid(runs, coll, algo):
    ref = runs["ref"]
    x = runtime.example_input(coll, Topology(2, 2), NBYTES, device="cpu")
    _bitwise(x.numpy(), ref[f"in/{coll}"])
    want = ref[f"out/{coll}/{algo}"]
    _bitwise(runs["parent"]["a"]["plans"][f"{coll}/{algo}"], want)
    for r in runs["a"]:
        _bitwise(r["plans"][f"{coll}/{algo}"], want)


@pytest.mark.parametrize("ax", ["node", "local"])
def test_a_axis_children(runs, ax):
    want = runs["parent"]["a"]["children"]
    for r in runs["a"]:
        for coll in runtime.collectives():
            _bitwise(r["children"][f"{ax}/{coll}"], want[f"{ax}/{coll}"])


def _check_colors(got_runs, want, name):
    seen = {}
    for r in got_runs:
        for c, (held, ranks, ar, a2a) in r["colors"][name].items():
            _, want_ranks, ar_w, a2a_w = want[name][c]
            assert ranks == want_ranks
            _bitwise(ar, ar_w[held])
            _bitwise(a2a, a2a_w[held])
            seen.setdefault(c, []).extend(held)
    # every member of every color is held by exactly one process
    assert {c: sorted(h) for c, h in seen.items()} == {
        c: list(range(len(v[1]))) for c, v in want[name].items()}


@pytest.mark.parametrize("name", list(A_SPLITS))
def test_a_color_splits_across_processes(runs, name):
    _check_colors(runs["a"], runs["parent"]["a"]["colors"], name)


def test_a_ef_sync_steps(runs):
    """Three int8 error-feedback steps: every bucket's output and carried
    error rows bitwise the one-process grid's."""
    want = runs["parent"]["a"]["ef"]
    assert np.abs(want[-1][1][0]).max() > 0  # the carry is live
    for r in runs["a"]:
        i = r["layout"]["rank"]
        for (ys, es), (yw, ew) in zip(r["ef"], want):
            for got, w in zip(ys + es, yw + ew):
                _bitwise(got, w[i:i + 1])


def _check_moe_forward(got_runs, want, cap, plan):
    w = want[f"{cap}/{plan}"]
    dropped = int((~w["kept"]).sum())
    assert (dropped == 0) == (cap == "tp"), dropped
    for r in got_runs:
        g = r["moe"][f"{cap}/{plan}"]
        for k in ("y", "ids", "kept"):
            _bitwise(g[k], w[k])
        assert g["aux"] == w["aux"]


MOE_CASES = [(c, p) for c in CAPS for p in LOSSLESS]


@pytest.mark.parametrize("cap,plan", MOE_CASES,
                         ids=[f"{c}/{p}" for c, p in MOE_CASES])
def test_a_moe_forward(runs, cap, plan):
    """The EP layer with TP over ``local``, which crosses processes here:
    bitwise ``RankGrid(2, 2)``'s, and within tests/test_torch_moe.py's bars
    of the reference's ``moe.apply`` on a (2, 2) mesh."""
    want = runs["parent"]["a"]["moe"]
    _check_moe_forward(runs["a"], want, cap, plan)
    y = torch.from_numpy(want[f"{cap}/{plan}"]["y"]).view(
        torch.bfloat16).float().numpy()
    ref_y = runs["ref"][f"moe/{cap}/y"]
    assert np.abs(y - ref_y).max() <= Y_TOL * np.abs(ref_y).max()
    np.testing.assert_allclose(want[f"{cap}/{plan}"]["aux"],
                               runs["ref"][f"moe/{cap}/aux_mean"],
                               rtol=AUX_TOL, atol=AUX_TOL)


@pytest.mark.parametrize("cap", list(CAPS))
def test_a_moe_backward(runs, cap):
    """The gradients of ``sum(y * r) + aux`` with respect to the router,
    the three expert weights and ``x``: bitwise ``RankGrid(2, 2)``'s (two
    ranks an expert: the module docstring)."""
    want = runs["parent"]["a"]["moe"][f"{cap}/grads"]
    assert all(np.abs(w).max() > 0 for w in want)
    for r in runs["a"]:
        for got, w in zip(r["moe"][f"{cap}/grads"], want):
            _bitwise(got, w)


def test_a_engine_tokens_are_the_sync_free_engines(runs):
    want = runs["parent"]["a"]["engine"]
    for r in runs["a"]:
        got = r["engine"]
        assert got["tokens"] == want["tokens"]
        assert got["sync_starts"] == got["ticks"] >= SERVE_NEW - 1


# ---------------------------------------------------------------------------
# B: ProcessGrid(2, 4) over four processes of two ranks
# ---------------------------------------------------------------------------


def test_b_layout(runs):
    for r in runs["b"]:
        lay, p = r["layout"], r["layout"]["rank"]
        assert lay["held"] == (2 * p, 2 * p + 1) and lay["rows"] == 2
        assert lay["topo_key"] == "2x4/host_ipc/host_ipc"
        assert lay["axis_index"] == {"node": [p // 2] * 2,
                                     "local": [2 * (p % 2), 2 * (p % 2) + 1]}


@pytest.mark.parametrize("coll,algo,dt", B_CASES,
                         ids=[f"{c}/{a}/{d}" for c, a, d in B_CASES])
def test_b_collectives_match_rank_grid(runs, coll, algo, dt):
    want = runs["parent"]["b"]["plans"][f"{coll}/{algo}/{dt}"]
    for r in runs["b"]:
        _bitwise(r["plans"][f"{coll}/{algo}/{dt}"], want)


@pytest.mark.parametrize("name", list(B_SPLITS))
def test_b_color_splits_interleave_processes(runs, name):
    if name == "interleaved":
        for r in runs["b"]:
            (held, ranks, _, _), = r["colors"][name].values()
            assert ranks == (0, 4, 1, 5, 2, 6, 3, 7)
            p = r["layout"]["rank"]
            assert held == sorted(ranks.index(k) for k in (2 * p, 2 * p + 1))
            assert held[1] - held[0] == 2  # not consecutive
    _check_colors(runs["b"], runs["parent"]["b"]["colors"], name)


@pytest.mark.parametrize("cap,plan", MOE_CASES,
                         ids=[f"{c}/{p}" for c, p in MOE_CASES])
def test_b_moe_forward(runs, cap, plan):
    """TP over ``local`` crosses a process boundary inside each node."""
    _check_moe_forward(runs["b"], runs["parent"]["b"]["moe"], cap, plan)


@pytest.mark.parametrize("cap", list(CAPS))
def test_b_moe_backward(runs, cap):
    want = runs["parent"]["b"]["moe"][f"{cap}/grads"]
    for r in runs["b"]:
        for got, w in zip(r["moe"][f"{cap}/grads"], want):
            _bitwise(got, w)


@pytest.mark.parametrize("step", [0, 1])
def test_b_train_step_matches_rank_grid(runs, step):
    """The sharded step on every process: the loss, the first batch's
    every gradient leaf, the weights and AdamW's ``m`` and ``v`` bitwise
    ``RankGrid(2, 4)``'s, so every process holds the same model."""
    want = runs["parent"]["b"]["train"]
    assert want["blocks_ep"] and all(s[0] == 8 for s in want["blocks_ep"])
    w = want["steps"][step]
    for r in runs["b"]:
        got = r["train"]
        assert got["blocks_ep"] == want["blocks_ep"]
        if step == 0:
            _bitwise(got["grad"], want["grad"])
        g = got["steps"][step]
        assert g["loss"] == w["loss"]
        for k in ("params", "m", "v"):
            _bitwise(g[k], w[k])


# ---------------------------------------------------------------------------
# the same legs on a "shm" grid in the same workers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shm_runs(runs):
    """``runs`` with each worker's results on its ``"shm"`` grid in place
    of its gloo grid's: every check above holds them to the same bars."""
    return {**runs, **{k: [r["shm"] for r in runs[k]] for k in ("a", "b")}}


def _same(got, want):
    """Equal structures, their arrays bitwise."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        _bitwise(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("spawn", ["a", "b"])
def test_shm_results_are_the_gloo_grids(runs, spawn):
    """Every leg's every result bitwise the gloo grid's in the same worker
    (gloo the grid's own choice on CPU ranks), the same bytes sent, and all
    of them through host memory on CPU ranks (sent and received); the
    slots one ``SHM_SLOT`` pair per peer."""
    skip = ("layout", "transport", "slot_bytes", "shm")
    for r in runs[spawn]:
        s = r["shm"]
        assert (r["transport"], s["transport"]) == ("gloo", "shm")
        _same({k: v for k, v in s.items() if k not in skip},
              {k: v for k, v in r.items() if k not in skip})
        assert s["layout"] == r["layout"]
        assert s["host_bytes"] == r["host_bytes"] > r["bytes_sent"] > 0
        assert s["slot_bytes"] == 2 * SHM_SLOT * (len(runs[spawn]) - 1)


def test_shm_a_layout(shm_runs):
    test_a_layout(shm_runs)


@pytest.mark.parametrize("coll,algo", PLANS_2x2,
                         ids=[f"{c}/{a}" for c, a in PLANS_2x2])
def test_shm_a_plans(shm_runs, coll, algo):
    test_a_plans_match_reference_and_rank_grid(shm_runs, coll, algo)


@pytest.mark.parametrize("ax", ["node", "local"])
def test_shm_a_axis_children(shm_runs, ax):
    test_a_axis_children(shm_runs, ax)


@pytest.mark.parametrize("name", list(A_SPLITS))
def test_shm_a_color_splits(shm_runs, name):
    test_a_color_splits_across_processes(shm_runs, name)


def test_shm_a_ef_sync_steps(shm_runs):
    test_a_ef_sync_steps(shm_runs)


@pytest.mark.parametrize("cap,plan", MOE_CASES,
                         ids=[f"{c}/{p}" for c, p in MOE_CASES])
def test_shm_a_moe_forward(shm_runs, cap, plan):
    test_a_moe_forward(shm_runs, cap, plan)


@pytest.mark.parametrize("cap", list(CAPS))
def test_shm_a_moe_backward(shm_runs, cap):
    test_a_moe_backward(shm_runs, cap)


def test_shm_a_engine_tokens(shm_runs):
    test_a_engine_tokens_are_the_sync_free_engines(shm_runs)


def test_shm_b_layout(shm_runs):
    test_b_layout(shm_runs)


@pytest.mark.parametrize("coll,algo,dt", B_CASES,
                         ids=[f"{c}/{a}/{d}" for c, a, d in B_CASES])
def test_shm_b_collectives(shm_runs, coll, algo, dt):
    test_b_collectives_match_rank_grid(shm_runs, coll, algo, dt)


@pytest.mark.parametrize("name", list(B_SPLITS))
def test_shm_b_color_splits(shm_runs, name):
    test_b_color_splits_interleave_processes(shm_runs, name)


@pytest.mark.parametrize("cap,plan", MOE_CASES,
                         ids=[f"{c}/{p}" for c, p in MOE_CASES])
def test_shm_b_moe_forward(shm_runs, cap, plan):
    test_b_moe_forward(shm_runs, cap, plan)


@pytest.mark.parametrize("cap", list(CAPS))
def test_shm_b_moe_backward(shm_runs, cap):
    test_b_moe_backward(shm_runs, cap)


@pytest.mark.parametrize("step", [0, 1])
def test_shm_b_train_step(shm_runs, step):
    test_b_train_step_matches_rank_grid(shm_runs, step)


# ---------------------------------------------------------------------------
# in process: a stand-in process group (no process is spawned)
# ---------------------------------------------------------------------------


@pytest.fixture
def group(monkeypatch):
    """``group(n, rank)``: this process as ``rank`` of ``n`` gloo
    processes."""
    def make(n, rank):
        monkeypatch.setattr(tdist, "is_initialized", lambda: True)
        monkeypatch.setattr(tdist, "get_backend", lambda *a: "gloo")
        monkeypatch.setattr(tdist, "get_world_size", lambda *a: n)
        monkeypatch.setattr(tdist, "get_rank", lambda *a: rank)
    return make


@pytest.mark.parametrize("n", [8, 4])
def test_held_rows_and_axis_index(group, n):
    r = 8 // n
    for p in range(n):
        group(n, p)
        grid = ProcessGrid(2, 4, "cpu")
        held = tuple(range(p * r, p * r + r))
        assert (grid.held, grid.rows, grid.offset, grid.process_count) == \
            (held, r, p * r, n)
        assert grid.axis_index("node").tolist() == [f // 4 for f in held]
        assert grid.axis_index("local").tolist() == [f % 4 for f in held]
        assert grid.axis_index(("node", "local")).tolist() == list(held)
        x = torch.arange(8.0)[:, None]
        assert grid.held_of(x).flatten().tolist() == list(map(float, held))


class _Dev:
    def __init__(self, platform, process_index):
        self.platform, self.process_index = platform, process_index


class _FakeMesh:
    axis_names = ("node", "local")

    def __init__(self, rows):
        self.devices = np.array(rows, dtype=object)

    @property
    def shape(self):
        return {"node": self.devices.shape[0],
                "local": self.devices.shape[1]}


#: (nodes, local, devices a process)
LINK_LAYOUTS = [(2, 4, 1), (2, 4, 2), (2, 4, 4), (2, 2, 1), (2, 2, 2),
                (1, 4, 1), (4, 2, 1), (1, 8, 8)]


@pytest.mark.parametrize("N,P,r", LINK_LAYOUTS,
                         ids=[f"{n}x{p}/{r}" for n, p, r in LINK_LAYOUTS])
def test_derive_link_keys_are_the_references(group, N, P, r):
    """The port's key on every process equals the reference's
    ``derive_link`` on a CPU mesh whose devices live ``r`` to a process."""
    pytest.importorskip("jax")
    from repro.core import autotune as ja
    from repro.core.topology import Topology as JTopo
    mesh = _FakeMesh([[_Dev("cpu", (n * P + j) // r) for j in range(P)]
                      for n in range(N)])
    want = ja.topo_key(JTopo.from_mesh(mesh))
    n = N * P // r
    for p in range(n):
        group(n, p)
        assert autotune.topo_key(Topology.from_grid(
            ProcessGrid(N, P, "cpu"))) == want
    if r == 1 and N * P > 1:
        assert want == f"{N}x{P}/" + "/".join(
            "host_ipc" if s > 1 else "host_cpu" for s in (N, P))


@pytest.mark.parametrize("n,shape", [(3, (2, 4)), (2, (4, 2)), (4, (8, 2)),
                                     (4, (1, 6)), (2, (1, 3)), (1, (2, 4))])
def test_counts_that_do_not_divide_n_local_raise(group, n, shape):
    """Each process must hold world / n ranks of one node."""
    group(n, 0)
    with pytest.raises(ValueError, match="must divide n_local"):
        ProcessGrid(*shape, "cpu")


def test_color_child_without_members_raises(group):
    """Process 0 of four holds no member of the color group over processes
    2 and 3: it gets the same dict of colors, and that child's collectives
    raise, saying so."""
    group(4, 0)
    comm = Communicator(ProcessGrid(2, 4, "cpu"))
    kids = comm.split(color=[0] * 4 + [1] * 4, key=[0, 2, 1, 3, 4, 6, 5, 7])
    assert sorted(kids) == [0, 1]
    assert kids[0].ranks == (0, 2, 1, 3) and kids[0].grid.held == (0, 2)
    other = kids[1].grid
    assert other.rows == 0 and other.process_count == 2
    with pytest.raises(RuntimeError, match="holds no rank of this grid"):
        kids[1].allreduce(torch.zeros(4, 3), algo="pip_mcoll")
    assert derive_link(other, "local", "intra") == "host_ipc"


if __name__ == "__main__":
    _reference(sys.argv[1])
