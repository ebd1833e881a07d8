"""The port's allreduce algorithms on a 2x4 CPU rank grid against the
reference on 8 forced host devices.

The reference side runs once per module in a subprocess (this file's
``__main__`` block, with ``--xla_force_host_platform_device_count=8``) and
writes an ``.npz``; both sides take the same numpy-seeded operands.

Parity: every lossless result is bitwise equal to the reference's — for
integer payloads by definition, for float32 because both packages add the
group's rows in rank order — and lies within the float32 summation bound
``8 * 2**-23 * sum|x|`` of the exact sum. The compressed allreduce under
int8_block, int4_block and fp8_sim, with and without error feedback, is
bitwise too: the port's codec lowerings copy the reference's rounding (the
f32 reciprocal scales and the single-rounding residuals of ``core/
compress.py``) and decode-reduce as its fused Pallas kernels do, peer by
peer from 0 with fused multiply-adds. Each case also lies within
``collective_tolerance(codec, "allreduce", 8, A)`` (``A`` the input's
max-abs) of the exact sum.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import compress, mcoll
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid

N, P = 2, 4
WORLD = N * P
LOSSLESS = ("pip_mcoll", "pip_pipeline", "recursive_doubling", "xla")
#: (algo, codec, knobs) compressed plans
COMPRESSED = (("pip_mcoll", "int8_block", {}),
              ("pip_pipeline", "int8_block", {"chunks": 3}),
              ("pip_mcoll", "int4_block", {}),
              ("pip_pipeline", "int4_block", {"chunks": 3}),
              ("pip_mcoll", "fp8_sim", {}),
              ("pip_pipeline", "fp8_sim", {"chunks": 3}))


def _operands():
    rng = np.random.default_rng(2024)
    return {
        "f32": rng.standard_normal((WORLD, 1000)).astype(np.float32),
        "i32": rng.integers(-1000, 1000, (WORLD, 999)).astype(np.int32),
        "f32_2d": rng.standard_normal((WORLD, 12, 7)).astype(np.float32),
        "err": (rng.standard_normal((WORLD, 1000)) * 0.01).astype(np.float32),
    }


def _case(algo, codec, knobs):
    return f"{algo}@{codec}" + "".join(f"#{k}{v}" for k, v in knobs.items())


def _reference(out_path: str) -> None:
    """Run every case through the reference Communicator on 8 devices."""
    import jax
    from repro.core.comm import Communicator as JComm

    comm = JComm(jax.make_mesh((N, P), ("node", "local")))
    ops = _operands()
    res = {}
    for algo in LOSSLESS:
        for name in ("f32", "i32", "f32_2d"):
            res[f"{algo}/{name}"] = np.asarray(
                comm.allreduce(ops[name], algo=algo))
    for algo, codec, knobs in COMPRESSED:
        case = _case(algo, codec, knobs)
        res[f"{case}/plain"] = np.asarray(
            comm.allreduce(ops["f32"], algo=algo, codec=codec, **knobs))
        op = comm.allreduce_init(ops["f32"], algo=algo, codec=codec,
                                 carry=True, **knobs)
        y, e = op.start(ops["f32"], carry=ops["err"]).wait()
        res[f"{case}/ef_out"] = np.asarray(y)
        res[f"{case}/ef_err"] = np.asarray(e)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("mcoll_ref") / "ref.npz"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def comm():
    return Communicator(RankGrid(N, P, device="cpu"))


def _sum_bound(x):
    x = np.asarray(x, np.float64)
    return 8 * 2.0 ** -23 * np.abs(x).sum(axis=0, keepdims=True)


@pytest.mark.parametrize("name", ["f32", "i32", "f32_2d"])
@pytest.mark.parametrize("algo", LOSSLESS)
def test_lossless_allreduce_matches_reference(reference, comm, algo, name):
    x = _operands()[name]
    got = comm.allreduce(torch.from_numpy(x), algo=algo).numpy()
    want = reference[f"{algo}/{name}"]
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if name == "i32":
        np.testing.assert_array_equal(got[0], x.sum(axis=0))
    else:
        assert (np.abs(got - x.astype(np.float64).sum(0)) <= _sum_bound(x)
                ).all()


@pytest.mark.parametrize("algo,codec,knobs", COMPRESSED,
                         ids=[_case(*c) for c in COMPRESSED])
def test_compressed_allreduce_matches_reference(reference, comm, algo, codec,
                                                knobs):
    ops = _operands()
    x = torch.from_numpy(ops["f32"])
    tol = compress.collective_tolerance(codec, "allreduce", WORLD,
                                        float(np.abs(ops["f32"]).max()))
    got = comm.allreduce(x, algo=algo, codec=codec, **knobs).numpy()
    want = reference[f"{_case(algo, codec, knobs)}/plain"]
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - ops["f32"].sum(0)).max() <= tol


@pytest.mark.parametrize("algo,codec,knobs", COMPRESSED,
                         ids=[_case(*c) for c in COMPRESSED])
def test_compressed_allreduce_error_feedback_matches_reference(
        reference, comm, algo, codec, knobs):
    ops = _operands()
    a = float(np.abs(ops["f32"] + ops["err"]).max())
    tol = compress.collective_tolerance(codec, "allreduce", WORLD, a)
    op = comm.allreduce_init(torch.from_numpy(ops["f32"]), algo=algo,
                             codec=codec, carry=True, **knobs)
    err = torch.from_numpy(ops["err"].copy())
    y, e = op.start(torch.from_numpy(ops["f32"]), carry=err).wait()
    case = _case(algo, codec, knobs)
    np.testing.assert_array_equal(y.numpy(), reference[f"{case}/ef_out"])
    np.testing.assert_array_equal(e.numpy(), reference[f"{case}/ef_err"])
    exact = (ops["f32"].astype(np.float64) + ops["err"]).sum(0)
    assert np.abs(y.numpy() - exact).max() <= tol
    # the carried residual is what the wire lost: sum + residuals = exact
    assert np.abs(y.numpy()[0] + e.numpy().sum(0) - exact).max() <= 1e-4


# ---------------------------------------------------------------------------
# the grid primitives against numpy oracles (lax semantics)
# ---------------------------------------------------------------------------


def _x(shape=(WORLD, 8, 3)):
    return torch.arange(int(np.prod(shape)), dtype=torch.float32) \
        .reshape(shape)


def test_grid_axis_index():
    g = RankGrid(N, P, "cpu")
    assert g.axis_index("local").tolist() == [0, 1, 2, 3] * 2
    assert g.axis_index("node").tolist() == [0] * 4 + [1] * 4
    assert g.axis_index(("node", "local")).tolist() == list(range(8))


def test_grid_psum_and_psum_scatter():
    g, x = RankGrid(N, P, "cpu"), _x()
    xs = x.numpy().reshape(N, P, 8, 3)
    np.testing.assert_array_equal(
        g.psum(x, "local").numpy().reshape(N, P, 8, 3),
        np.broadcast_to(xs.sum(1, keepdims=True), xs.shape))
    rs = g.psum_scatter(x, "local").numpy().reshape(N, P, 2, 3)
    for n in range(N):
        for l in range(P):
            np.testing.assert_array_equal(
                rs[n, l], xs[n].sum(0)[2 * l:2 * l + 2])
    rs = g.psum_scatter(x, "node").numpy().reshape(N, P, 4, 3)
    for n in range(N):
        np.testing.assert_array_equal(rs[n], xs.sum(0)[:, 4 * n:4 * n + 4])


def test_grid_all_gather_all_to_all_ppermute():
    g, x = RankGrid(N, P, "cpu"), _x((WORLD, 2, 5))
    xs = x.numpy()
    ag = g.all_gather(x, "node").numpy()
    for r in range(WORLD):
        np.testing.assert_array_equal(ag[r], xs[[r % P, P + r % P]])
    agt = g.all_gather(x, "local", tiled=True).numpy()
    np.testing.assert_array_equal(agt[5], xs[4:8].reshape(8, 5))
    v = _x((WORLD, P, 3))
    a2a = g.all_to_all(v, "local", 0, 0).numpy()
    vn = v.numpy()
    for r in range(WORLD):
        n, l = divmod(r, P)
        np.testing.assert_array_equal(
            a2a[r], np.stack([vn[n * P + s, l] for s in range(P)]))
    perm = g.ppermute(x, ("node", "local"), [(i, (i + 3) % 8)
                                             for i in range(8)]).numpy()
    np.testing.assert_array_equal(perm, np.roll(xs, 3, axis=0))
    part = g.ppermute(x, "local", [(0, 1)]).numpy()
    np.testing.assert_array_equal(part[1], xs[0])
    assert not part[0].any() and not part[2].any()


if __name__ == "__main__":
    _reference(sys.argv[1])
