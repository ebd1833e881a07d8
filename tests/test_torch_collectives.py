"""The port's allgather, scatter, broadcast, reduce_scatter and alltoall
(18 algorithms) on a 2x4 CPU rank grid against the reference Communicator
on 8 forced host devices.

The reference side runs once per module in a subprocess (this file's
``__main__`` block, ``--xla_force_host_platform_device_count=8``) and
writes an ``.npz``; both sides take the same numpy-seeded operands: float32
(with a -0.0 in it), int32 and a float32 payload with trailing dims.

Parity is bitwise for every case here:

  * data movement (gathers, scatters, broadcasts, exchanges) and integer
    payloads by definition; the psum masks of the broadcast trees and of
    ``xla`` broadcast turn a root's -0.0 into +0.0 on both sides;
  * float reduce_scatter in both orders: ``pip_mcoll`` adds over nodes,
    then lanes; ``xla`` in flat rank order — each its reference's bits;
  * the compressed forms: gathers, exchanges, broadcasts and scatters
    deliver bitwise ``decode(encode(x))`` of the source rows (the wire-form
    invariant); the compressed reduce_scatter decode-reduces in the same
    order with the same single-rounding multiply-adds as the reference's
    Pallas kernels.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import compress, mcoll, oracles, runtime
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid

N, P = 2, 4
WORLD = N * P
CODECS = ("int8_block", "int4_block", "fp8_sim")
OPERANDS = ("f32", "i32", "f32_2d")
NEW = ("allgather", "scatter", "broadcast", "reduce_scatter", "alltoall")
PAIRS = [(c, a) for c in NEW for a in mcoll.algorithms(c)]


def _operands():
    """name -> collective -> global operand (numpy), per the reference's
    conventions: allgather/scatter ``(W*m, ...)``, broadcast ``(m, ...)``,
    reduce_scatter ``(W, W*s, ...)``, alltoall ``(W, W, s...)``."""
    rng = np.random.default_rng(1234)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def i32(*shape):
        return rng.integers(-1000, 1000, shape).astype(np.int32)

    ops = {
        "f32": {"allgather": f32(WORLD * 5), "scatter": f32(WORLD * 5),
                "broadcast": f32(37), "reduce_scatter": f32(WORLD, WORLD * 6),
                "alltoall": f32(WORLD, WORLD, 5)},
        "i32": {"allgather": i32(WORLD * 5), "scatter": i32(WORLD * 5),
                "broadcast": i32(37), "reduce_scatter": i32(WORLD, WORLD * 6),
                "alltoall": i32(WORLD, WORLD, 5)},
        "f32_2d": {"allgather": f32(WORLD * 3, 4, 2),
                   "scatter": f32(WORLD * 3, 4, 2),
                   "broadcast": f32(5, 3, 2),
                   "reduce_scatter": f32(WORLD, WORLD * 2, 3),
                   "alltoall": f32(WORLD, WORLD, 2, 3)},
        # codec payloads: several quantization blocks per wire slice, rows
        # scaled over four decades so the block scales differ widely
        "wide": {"allgather": f32(WORLD * 300) * 50,
                 "scatter": f32(WORLD * 300, 2)
                 * rng.uniform(0.01, 100, (WORLD * 300, 1)).astype(np.float32),
                 "broadcast": f32(700) * 3,
                 "reduce_scatter": f32(WORLD, WORLD * 96)
                 * rng.uniform(0.01, 100, (WORLD, 1)).astype(np.float32),
                 "alltoall": f32(WORLD, WORLD, 70) * 7},
    }
    for name in ("f32", "f32_2d"):
        for x in ops[name].values():
            x.reshape(-1)[3] = -0.0  # a signed zero on rank 0 (the root)
    return ops


def _cases():
    """(collective, algo, operand, knobs) for every case of the module."""
    cases = []
    for coll, algo in PAIRS:
        for name in OPERANDS:
            cases.append((coll, algo, name, {}))
        if mcoll.supports_chunks(coll, algo):
            for name in ("f32", "i32"):
                cases.append((coll, algo, name, {"chunks": 3}))
        if coll in ("scatter", "broadcast"):
            for root in (3, 6):  # same node as 0, other lane; other node
                cases.append((coll, algo, "f32", {"root": root}))
        if mcoll.supports_codec(coll, algo):
            for codec in CODECS:
                cases.append((coll, algo, "wide", {"codec": codec}))
    for coll, algo in (("scatter", "pip_mcoll"), ("broadcast", "pip_mcoll"),
                       ("alltoall", "pip_pipeline")):
        for codec in CODECS:
            cases.append((coll, algo, "wide", {"codec": codec, "chunks": 3}))
    for coll in ("scatter", "broadcast"):
        cases.append((coll, "pip_mcoll", "wide",
                      {"codec": "int4_block", "root": 6}))
    cases.append(("allgather", "pip_mcoll", "f32", {"stacked": False}))
    cases.append(("allgather", "pip_mcoll", "i32", {"codec": "zlib_sim"}))
    cases.append(("alltoall", "pip_mcoll", "i32", {"codec": "zlib_sim"}))
    return cases


CASES = _cases()


def _key(coll, algo, name, knobs):
    return f"{coll}/{algo}/{name}" + "".join(
        f"#{k}={v}" for k, v in sorted(knobs.items()))


def _reference(out_path: str) -> None:
    """Run every case through the reference Communicator on 8 devices."""
    import jax
    from repro.core.comm import Communicator as JComm

    comm = JComm(jax.make_mesh((N, P), ("node", "local")))
    ops = _operands()
    res = {_key(*c): np.asarray(comm.invoke(c[0], ops[c[2]][c[0]],
                                            algo=c[1], **c[3]))
           for c in CASES}
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("collectives_ref") / "ref.npz"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def comm():
    return Communicator(RankGrid(N, P, device="cpu"))


def _run(comm, coll, algo, name, knobs):
    x = torch.from_numpy(_operands()[name][coll])
    return comm.invoke(coll, x, algo=algo, **knobs).numpy()


@pytest.mark.parametrize("coll,algo,name,knobs", CASES,
                         ids=[_key(*c) for c in CASES])
def test_collective_matches_reference(reference, comm, coll, algo, name,
                                      knobs):
    got = _run(comm, coll, algo, name, knobs)
    want = reference[_key(coll, algo, name, knobs)]
    assert got.shape == want.shape and got.dtype == want.dtype
    # bitwise, signed zeros included
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# semantics on the port alone: plain oracles and the wire-form invariant
# ---------------------------------------------------------------------------


def _oracle(coll, x):
    """What every lossless collective must deliver (global conventions)."""
    t = torch.from_numpy(x)
    if coll == "reduce_scatter":
        return oracles.exact_sum(coll, t).numpy()
    return oracles.movement(coll, t, N, P).numpy()


@pytest.mark.parametrize("coll,algo", PAIRS,
                         ids=[f"{c}/{a}" for c, a in PAIRS])
def test_integer_payloads_match_numpy(comm, coll, algo):
    x = _operands()["i32"][coll]
    knobs = {"root": 5} if coll in ("scatter", "broadcast") else {}
    got = _run(comm, coll, algo, "i32", knobs)
    np.testing.assert_array_equal(got, _oracle(coll, x))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("coll", ["allgather", "scatter", "broadcast",
                                  "alltoall"])
def test_compressed_outputs_are_the_wire_form_round_trip(comm, coll, codec):
    """Each rank receives bitwise decode(encode(.)) of what the source
    encoded: the node block (allgather), the root's per-destination rows
    (scatter), the root's payload (broadcast), the per-node payloads
    (alltoall)."""
    x = _operands()["wide"][coll]
    got = _run(comm, coll, "pip_mcoll", "wide", {"codec": codec})
    want = oracles.movement(coll, torch.from_numpy(x), N, P, codec).numpy()
    np.testing.assert_array_equal(got, want)
    tol = compress.collective_tolerance(codec, coll, WORLD,
                                        float(np.abs(x).max()))
    assert np.abs(got - _oracle(coll, x)).max() <= tol


@pytest.mark.parametrize("codec", CODECS)
def test_compressed_reduce_scatter_within_tolerance(comm, codec):
    x = _operands()["wide"]["reduce_scatter"]
    got = _run(comm, "reduce_scatter", "pip_mcoll", "wide", {"codec": codec})
    tol = compress.collective_tolerance(codec, "reduce_scatter", WORLD,
                                        float(np.abs(x).max()))
    assert np.abs(got - x.astype(np.float64).sum(0)).max() <= tol


def test_lossy_codecs_refuse_integer_payloads(comm):
    for coll in NEW:
        x = torch.from_numpy(_operands()["i32"][coll])
        with pytest.raises(ValueError, match="not admissible"):
            comm.invoke(coll, x, algo="pip_mcoll", codec="int8_block")


# ---------------------------------------------------------------------------
# the Communicator surface: persistent ops, message sizes, dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coll", NEW)
def test_persistent_op_matches_blocking(comm, coll):
    x = torch.from_numpy(_operands()["f32"][coll])
    algo = "pip_mcoll"
    op = getattr(comm, f"{coll}_init")(x, algo=algo, depth=2)
    h1 = op.start(x)
    h2 = op.start(x)
    want = comm.invoke(coll, x, algo=algo)
    assert torch.equal(h1.wait(), want) and torch.equal(h2.wait(), want)
    assert tuple(want.shape) == \
        runtime.wiring(coll).result_shape(x.shape, WORLD)
    op.release()
    with pytest.raises(RuntimeError, match="released"):
        op.start(x)


def test_allgather_unstacked_persistent(comm):
    x = torch.from_numpy(_operands()["f32"]["allgather"])
    op = comm.allgather_init(x, algo="ring", stacked=False)
    assert torch.equal(op(x), x)


def test_allgather_shift_fn_hook(comm):
    """pip_mcoll's step-6 shift is the roll by default; a ``shift_fn``
    receives the stacked blocks and the per-rank node index instead."""
    x = torch.from_numpy(_operands()["f32_2d"]["allgather"])
    seen = []

    def shift(V, n):
        seen.append((tuple(V.shape), n.tolist()))
        return comm.grid.roll(V, n)

    got = comm.allgather(x, algo="pip_mcoll", shift_fn=shift)
    assert torch.equal(got, comm.allgather(x, algo="pip_mcoll"))
    assert seen == [((WORLD, N, P * 3, 4, 2), [0] * P + [1] * P)]


def test_message_bytes_match_reference():
    pytest.importorskip("jax")
    from repro.core import runtime as jrt
    from repro.core.topology import Topology as JTopo
    from repro_torch.core.topology import Topology
    for name in OPERANDS:
        for coll, x in _operands()[name].items():
            assert runtime._message_bytes(coll, Topology(N, P),
                                          torch.from_numpy(x)) == \
                jrt._message_bytes(coll, JTopo(N, P), x), (name, coll)


def test_invoke_and_auto_plans(comm):
    x = torch.from_numpy(_operands()["f32"]["alltoall"])
    assert torch.equal(comm.invoke("alltoall", x, algo="xla"),
                       comm.alltoall(x, algo="xla"))
    with pytest.raises(ValueError, match="unknown collective"):
        comm.invoke("barrier", x)
    for coll in NEW:
        y = comm.invoke(coll, torch.from_numpy(_operands()["i32"][coll]))
        np.testing.assert_array_equal(
            y.numpy(), _oracle(coll, _operands()["i32"][coll]))
    with pytest.raises(ValueError, match="does not support chunking"):
        comm.allgather(torch.from_numpy(_operands()["f32"]["allgather"]),
                       algo="bruck", chunks=2)


# ---------------------------------------------------------------------------
# the grid's new primitives against numpy (lax semantics)
# ---------------------------------------------------------------------------


def test_grid_tiled_all_to_all():
    g = RankGrid(N, P, "cpu")
    x = torch.arange(WORLD * WORLD * 2 * 3, dtype=torch.float32) \
        .reshape(WORLD, WORLD * 2, 3)
    got = g.all_to_all(x, ("node", "local"), 0, 0, tiled=True).numpy()
    xs = x.numpy().reshape(WORLD, WORLD, 2, 3)
    np.testing.assert_array_equal(
        got, np.swapaxes(xs, 0, 1).reshape(WORLD, WORLD * 2, 3))
    loc = g.all_to_all(x, "local", 0, 0, tiled=True).numpy()
    for r in range(WORLD):
        n, l = divmod(r, P)
        want = np.concatenate([x.numpy()[n * P + s, 4 * l:4 * l + 4]
                               for s in range(P)])
        np.testing.assert_array_equal(loc[r], want)
    with pytest.raises(ValueError):
        g.all_to_all(x, "local", 0, 1, tiled=True)


def test_grid_row_helpers():
    g = RankGrid(N, P, "cpu")
    x = torch.arange(WORLD * 5 * 2, dtype=torch.float32).reshape(WORLD, 5, 2)
    xs = x.numpy()
    r = torch.arange(WORLD)
    np.testing.assert_array_equal(g.take(x, r % 5).numpy(),
                                  xs[np.arange(WORLD), np.arange(WORLD) % 5])
    idx = torch.stack([(r + k) % 5 for k in range(3)], dim=1)
    np.testing.assert_array_equal(
        g.take(x, idx).numpy(),
        np.stack([xs[i][[(i + k) % 5 for k in range(3)]]
                  for i in range(WORLD)]))
    rolled = g.roll(x, r).numpy()
    for i in range(WORLD):
        np.testing.assert_array_equal(rolled[i], np.roll(xs[i], i, axis=0))
    sl = g.dynamic_slice(x, r - 2, 2).numpy()
    for i in range(WORLD):
        s = min(max(i - 2, 0), 3)  # lax clamps the start into [0, K-size]
        np.testing.assert_array_equal(sl[i], xs[i, s:s + 2])
    neg = torch.full_like(x, -0.0)
    w = g.where(r % 2 == 0, neg, x).numpy()
    assert np.signbit(w[0]).all() and (w[1] == xs[1]).all()


if __name__ == "__main__":
    _reference(sys.argv[1])
