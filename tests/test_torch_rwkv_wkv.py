"""The port's WKV6 kernel against the reference's.

On the CPU the wrapper ``repro_torch.kernels.rwkv.rwkv6_wkv`` runs its
plain version (``kernels/ref.py``); the reference side — this file's
``__main__``, run once per module in a subprocess — calls both the
reference's plain recurrence ``repro.kernels.ref.rwkv6_wkv`` and its Pallas
kernel ``repro.kernels.rwkv6_wkv.rwkv6_wkv(..., interpret=True)`` on the
same numpy inputs (a nonzero initial state) and writes an ``.npz``. All
three compute in fp32 from the same (bf16-rounded, for bf16) operands and
differ only in the order of their fp32 sums: ``TOL * (1 + |ref|)``. The
chunked form of the prefill kernel, in plain PyTorch
(``ref.rwkv6_wkv_chunked``), is held against the same two, the sequential
plain version and a float64 recurrence at one chunk -1, +0, +1 and 130
steps, hd 20, 32 and 128, zero and random states, and decays with exact
zeros, subnormals and values near 1. It reorders the recurrence's fp32
operations as the kernel does, so it is held to the tolerance this file
states for that, ``CUDA_TOL``: at hd 128 and decays near 1 two fp32 orders
differ by up to 7e-5 (the sequential fp32 recurrence itself is that far
from float64 there), beyond ``TOL``. The tick kernel's order of operations
in plain PyTorch (``ref.rwkv6_wkv_tick_lanes``) is held against the same
four within ``TOL``, at 1 and 7 steps, hd 8, 20, 64 and 128, zero and
random states and the same decays. The ``cuda``-marked tests hold the CUDA kernels against their plain
versions on the card and skip where there is no card.
"""
import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import rwkv as krwkv

#: (B, T, H, hd): the reference's kernel test grid (tests/test_kernels.py),
#: a single step (the decode tick) and a T no power of two divides
GRID = [(1, 32, 2, 8), (2, 64, 4, 16), (1, 128, 1, 32), (3, 1, 4, 16),
        (2, 37, 3, 32)]
DTYPES = ("float32", "bfloat16")
#: plain version against the reference's plain recurrence and Pallas body,
#: all fp32: sum order only
TOL = 1e-5
#: the CUDA kernel against the plain version on the card (fp32 sums in
#: another order, fused multiply-adds: the reference's own kernel-vs-ref
#: tolerance for fp32, tests/test_kernels.py)
CUDA_TOL = 1e-4


def _inputs(B, T, H, hd, seed, zero_state=False):
    """r, k, v, w, u, s0 as float32 numpy arrays (w in (0, 0.98))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = (0.98 / (1 + np.exp(-rng.standard_normal((B, T, H, hd))))).astype(
        np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    if zero_state:
        s0[...] = 0
    return r, k, v, w, u, s0


def _seed(B, T, H, hd):
    return 1000 * B + 10 * T + H + hd


#: (B, T, H, hd) of the chunked form's checks: one chunk (16 steps) -1,
#: +0, +1, and 130 steps, at hd 20, 32 and 128
CHUNK_GRID = [(1, 15, 2, 20), (2, 16, 2, 32), (1, 17, 2, 128),
              (2, 130, 3, 32), (1, 130, 2, 128)]
#: decays: as drawn; a tenth exactly 0; a tenth subnormal; all in
#: (1 - 1e-3, 1)
DECAYS = ("drawn", "zeros", "subnormal", "near1")


def _decayed(w, mode, seed):
    rng = np.random.default_rng(seed + 99)
    w = w.copy()
    pick = rng.random(w.shape) < 0.1
    if mode == "zeros":
        w[pick] = 0.0
    elif mode == "subnormal":
        w[pick] = rng.choice(np.array([1e-39, 1e-42, 1e-45], np.float32),
                             size=int(pick.sum()))
    elif mode == "near1":
        w = (1 - 1e-3 * w).astype(np.float32)
    return w


#: (B, T, H, hd) of the tick kernel's mirror: 1 and 7 steps at hd 8, 20,
#: 64 and 128
TICK_GRID = [(2, 1, 3, 8), (1, 7, 2, 8), (2, 1, 2, 20), (1, 7, 2, 20),
             (2, 1, 2, 64), (1, 7, 2, 64), (1, 1, 2, 128), (1, 7, 1, 128)]


def _chunk_inputs(B, T, H, hd, mode, zero_state):
    seed = _seed(B, T, H, hd)
    r, k, v, w, u, s0 = _inputs(B, T, H, hd, seed, zero_state)
    return r, k, v, _decayed(w, mode, seed), u, s0


def _f64_recurrence(r, k, v, w, u, s0):
    r, k, v, w, u, s0 = (a.astype(np.float64) for a in (r, k, v, w, u, s0))
    S = s0.copy()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(np.einsum("bhi,bhij->bhj", r[:, t], S + u[..., None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return np.stack(ys, 1), S


def _reference(out_path: str) -> None:
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.rwkv6_wkv import rwkv6_wkv

    res = {}
    for B, T, H, hd in GRID:
        r, k, v, w, u, s0 = _inputs(B, T, H, hd, _seed(B, T, H, hd))
        for dt in DTYPES:
            jr, jk, jv = (jnp.asarray(a, getattr(jnp, dt)) for a in (r, k, v))
            jw, ju, js = (jnp.asarray(a) for a in (w, u, s0))
            tag = f"{B}_{T}_{H}_{hd}_{dt}"
            y, sT = jref.rwkv6_wkv(jr, jk, jv, jw, ju, js)
            res[f"{tag}_ref_y"], res[f"{tag}_ref_s"] = (np.asarray(y),
                                                        np.asarray(sT))
            y, sT = rwkv6_wkv(jr, jk, jv, jw, ju, js, interpret=True)
            res[f"{tag}_pallas_y"], res[f"{tag}_pallas_s"] = (np.asarray(y),
                                                              np.asarray(sT))
    for form, grid in (("chunk", CHUNK_GRID), ("tick", TICK_GRID)):
        for (B, T, H, hd), mode, zero_state in itertools.product(
                grid, DECAYS, (False, True)):
            ops = [jnp.asarray(a) for a in _chunk_inputs(
                B, T, H, hd, mode, zero_state)]
            tag = f"{form}_{B}_{T}_{H}_{hd}_{mode}_{int(zero_state)}"
            for against, (y, sT) in (
                    ("ref", jref.rwkv6_wkv(*ops)),
                    ("pallas", rwkv6_wkv(*ops, chunk=T, interpret=True))):
                res[f"{tag}_{against}_y"] = np.asarray(y)
                res[f"{tag}_{against}_s"] = np.asarray(sT)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("rwkv_wkv_ref") / "ref.npz"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def _torch(arrays, dtype, device="cpu"):
    """r, k, v in ``dtype``; w, u, s0 float32."""
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(device) for a in arrays)
    dt = getattr(torch, dtype)
    return r.to(dt), k.to(dt), v.to(dt), w, u, s0


def _assert_close(got, want, tol, what):
    got = got.double().cpu().numpy() if torch.is_tensor(got) else got
    want = want.double().cpu().numpy() if torch.is_tensor(want) else want
    err = np.abs(got - want)
    bad = err > tol * (1 + np.abs(want))
    assert not bad.any(), (f"{what}: {bad.sum()} elements outside {tol} * "
                           f"(1 + |ref|), max error {err.max()}")


@pytest.mark.parametrize("against", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H,hd", GRID)
def test_plain_matches_reference(reference, B, T, H, hd, dtype, against):
    ops = _torch(_inputs(B, T, H, hd, _seed(B, T, H, hd)), dtype)
    y, sT = krwkv.rwkv6_wkv(*ops)
    assert y.shape == (B, T, H, hd) and y.dtype == torch.float32
    assert sT.shape == (B, H, hd, hd) and sT.dtype == torch.float32
    tag = f"{B}_{T}_{H}_{hd}_{dtype}_{against}"
    _assert_close(y, reference[f"{tag}_y"], TOL, f"y against {against}")
    _assert_close(sT, reference[f"{tag}_s"], TOL, f"sT against {against}")


def test_plain_matches_float64_recurrence():
    """The recurrence written out in float64 over numpy."""
    r, k, v, w, u, s0 = (a.astype(np.float64)
                         for a in _inputs(2, 23, 3, 8, 5))
    S = s0.copy()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(np.einsum("bhi,bhij->bhj", r[:, t], S + u[..., None] * kv))
        S = w[:, t, :, :, None] * S + kv
    y, sT = ref.rwkv6_wkv(*(torch.from_numpy(a).float()
                            for a in (r, k, v, w, u, s0)))
    _assert_close(y, np.stack(ys, 1), TOL, "y")
    _assert_close(sT, S, TOL, "sT")


def test_state_out_may_alias_s0_and_t0_keeps_the_state():
    """The final state written over ``s0`` equals a fresh one; ``T = 0``
    gives an empty ``y`` and leaves the state as it was."""
    ops = _torch(_inputs(2, 9, 3, 16, 7), "float32")
    y, sT = krwkv.rwkv6_wkv(*ops)
    s0 = ops[-1].clone()
    y2, sT2 = krwkv.rwkv6_wkv(*ops[:-1], s0, state_out=s0)
    assert sT2 is s0 and torch.equal(s0, sT) and torch.equal(y2, y)
    r, k, v, w = (t[:, :0] for t in ops[:4])
    before = s0.clone()
    y0, s_out = krwkv.rwkv6_wkv(r, k, v, w, ops[4], s0, state_out=s0)
    assert y0.shape == (2, 0, 3, 16) and s_out is s0
    assert torch.equal(s0, before)
    y0, s_new = krwkv.rwkv6_wkv(r, k, v, w, ops[4], s0)
    assert s_new is not s0 and torch.equal(s_new, before)


@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("mode", DECAYS)
@pytest.mark.parametrize("B,T,H,hd", CHUNK_GRID)
def test_chunked_plain_matches_reference(reference, B, T, H, hd, mode,
                                         zero_state):
    """The chunk formulas and their decay handling (products of decays
    only) against the reference's recurrence and Pallas body, the
    sequential plain version and float64; no inf or NaN where decays are
    0 or subnormal."""
    arrays = _chunk_inputs(B, T, H, hd, mode, zero_state)
    ops = _torch(arrays, "float32")
    y, sT = krwkv.rwkv6_wkv_chunked(*ops)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sT).all())
    tag = f"chunk_{B}_{T}_{H}_{hd}_{mode}_{int(zero_state)}"
    want = {against: (reference[f"{tag}_{against}_y"],
                      reference[f"{tag}_{against}_s"])
            for against in ("ref", "pallas")}
    want["plain"] = ref.rwkv6_wkv(*ops)
    exact = _f64_recurrence(*arrays)
    _assert_close(y, exact[0], CUDA_TOL, "y against float64")
    _assert_close(sT, exact[1], CUDA_TOL, "sT against float64")
    for against, (wy, ws) in want.items():
        if mode == "near1":
            # each fp32 order lies up to 7e-5 from float64 here, two of
            # them up to 1.2e-4 apart: each is held to float64 instead
            wy, ws = exact
            y, sT = (torch.as_tensor(want[against][0]),
                     torch.as_tensor(want[against][1]))
        _assert_close(y, wy, CUDA_TOL, f"y against {against}")
        _assert_close(sT, ws, CUDA_TOL, f"sT against {against}")
    y, sT = krwkv.rwkv6_wkv_chunked(*ops)
    # the wrapper's final state written over s0
    s0 = ops[-1].clone()
    y2, s2 = krwkv.rwkv6_wkv_chunked(*ops[:-1], s0, state_out=s0)
    assert s2 is s0 and torch.equal(y2, y) and torch.equal(s0, sT)


@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("mode", DECAYS)
@pytest.mark.parametrize("B,T,H,hd", TICK_GRID)
def test_tick_mirror_matches_reference(reference, B, T, H, hd, mode,
                                       zero_state):
    """The tick kernel's order of operations (sums over lanes and row
    groups joined by butterflies, then over warps in order; fused
    multiply-adds) against the
    reference's recurrence and Pallas body, the sequential plain version
    and float64, within ``TOL`` (over 1 and 7 steps it lies within 4.8e-6
    of each, decays near 1 included); no inf or NaN where decays are 0 or
    subnormal."""
    arrays = _chunk_inputs(B, T, H, hd, mode, zero_state)
    ops = _torch(arrays, "float32")
    y, sT = ref.rwkv6_wkv_tick_lanes(*ops)
    assert y.shape == (B, T, H, hd) and sT.shape == (B, H, hd, hd)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sT).all())
    tag = f"tick_{B}_{T}_{H}_{hd}_{mode}_{int(zero_state)}"
    want = {against: (reference[f"{tag}_{against}_y"],
                      reference[f"{tag}_{against}_s"])
            for against in ("ref", "pallas")}
    want["plain"] = ref.rwkv6_wkv(*ops)
    want["float64"] = _f64_recurrence(*arrays)
    for against, (wy, ws) in want.items():
        _assert_close(y, wy, TOL, f"y against {against}")
        _assert_close(sT, ws, TOL, f"sT against {against}")


def test_chunked_plain_takes_any_chunk():
    """Chunks of 1 step, of 5 (no divisor of T) and longer than T give the
    recurrence."""
    ops = _torch(_inputs(2, 23, 3, 8, 11), "float32")
    want_y, want_s = ref.rwkv6_wkv(*ops)
    for chunk in (1, 5, 64):
        y, sT = ref.rwkv6_wkv_chunked(*ops, chunk=chunk)
        _assert_close(y, want_y, TOL, f"y, chunk {chunk}")
        _assert_close(sT, want_s, TOL, f"sT, chunk {chunk}")


def test_cpu_path_counts_no_launch():
    krwkv.reset_launches()
    krwkv.rwkv6_wkv(*_torch(_inputs(1, 4, 2, 8, 0), "bfloat16"))
    krwkv.rwkv6_wkv(*_torch(_inputs(2, 1, 2, 8, 1), "float32"))
    krwkv.rwkv6_wkv(*_torch(_inputs(1, 40, 2, 8, 2), "float32"))
    krwkv.rwkv6_wkv_chunked(*_torch(_inputs(1, 4, 2, 8, 3), "float32"))
    krwkv.rwkv6_wkv_recurrent(*_torch(_inputs(1, 4, 2, 8, 4), "float32"))
    assert krwkv.launches == {"rwkv6_wkv": 0, "rwkv6_wkv_recurrent": 0,
                              "rwkv6_wkv_chunked": 0}


def test_dispatch_refuses_other_devices_dtypes_and_shapes():
    r, k, v, w, u, s0 = _torch(_inputs(2, 4, 2, 8, 0), "float32")
    meta = [t.to("meta") for t in (r, k, v, w, u, s0)]
    with pytest.raises(ValueError, match="no kernel for device"):
        krwkv.rwkv6_wkv(*meta)
    with pytest.raises(ValueError, match="several devices"):
        krwkv.rwkv6_wkv(r, k.to("meta"), v, w, u, s0)
    with pytest.raises(ValueError, match="several devices"):
        krwkv.rwkv6_wkv(r, k, v, w, u, s0, state_out=s0.to("meta"))
    with pytest.raises(TypeError, match="k: expected torch.float32 as r"):
        krwkv.rwkv6_wkv(r, k.bfloat16(), v, w, u, s0)
    with pytest.raises(TypeError, match="w: expected torch.float32"):
        krwkv.rwkv6_wkv(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(TypeError, match="s0: expected torch.float32"):
        krwkv.rwkv6_wkv(r, k, v, w, u, s0.double())
    with pytest.raises(TypeError, match="r: expected bfloat16 or float32"):
        krwkv.rwkv6_wkv(r.half(), k.half(), v.half(), w, u, s0)
    with pytest.raises(ValueError, match="u: expected"):
        krwkv.rwkv6_wkv(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="takes r"):
        krwkv.rwkv6_wkv(r[0], k, v, w, u, s0)
    big = _torch(_inputs(1, 2, 1, 136, 0), "float32")
    with pytest.raises(ValueError, match="hd <= 128"):
        krwkv.rwkv6_wkv(*big)


def test_state_out_may_alias_s0_but_not_overlap_it_partly():
    r, k, v, w, u, s0 = _torch(_inputs(2, 4, 2, 8, 0), "float32")
    want_y, want_s = ref.rwkv6_wkv(r, k, v, w, u, s0.clone())
    # another view of the same bytes is s0 itself
    y, sT = krwkv.rwkv6_wkv(r, k, v, w, u, s0, state_out=s0.view(s0.shape))
    assert torch.equal(y, want_y) and torch.equal(s0, want_s)
    # a view shifted by one state row shares bytes with s0
    buf = torch.zeros(s0.numel() + 8)
    base = buf[:s0.numel()].view(s0.shape)
    shifted = buf[8:].view(s0.shape)
    with pytest.raises(ValueError, match="overlaps s0"):
        krwkv.rwkv6_wkv(r, k, v, w, u, base, state_out=shifted)
    with pytest.raises(ValueError, match="overlaps s0"):
        krwkv.rwkv6_wkv(r, k, v, w, u, shifted, state_out=base)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


#: the decode tick and a prefill of full-width rwkv6-1.6b (H 32, hd 64),
#: the reduced config (H 4, hd 32), hd 128, one chunk -1, +0 and +1 steps,
#: the reference's grid, and the tick kernel at 1 and 2-15 steps with hd 1
#: (scalar state I/O), 20, 100 (a second 64-column half cut short) and 128
CUDA_SHAPES = [(8, 1, 32, 64), (1, 300, 32, 64), (2, 130, 4, 32),
               (1, 7, 4, 32), (2, 33, 2, 128), (1, 5, 3, 20),
               (1, 15, 4, 64), (2, 16, 4, 32), (1, 17, 2, 128)] + GRID + [
    (2, 1, 3, 1), (1, 3, 2, 1), (8, 1, 4, 20), (2, 11, 3, 20),
    (2, 1, 2, 100), (1, 9, 2, 100), (8, 1, 2, 128), (1, 12, 2, 128),
    (1, 2, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H,hd", CUDA_SHAPES)
def test_cuda_kernel_matches_plain(cuda, B, T, H, hd, dtype, zero_state):
    """Through the dispatch: the chunked kernel from ``CHUNKED_FROM``
    steps, the recurrent one below."""
    ops = _torch(_inputs(B, T, H, hd, B + T + hd, zero_state), dtype, cuda)
    want_y, want_s = ref.rwkv6_wkv(*ops)
    key = "rwkv6_wkv_chunked" if T >= krwkv.CHUNKED_FROM else "rwkv6_wkv"
    before = dict(krwkv.launches)
    y, sT = krwkv.rwkv6_wkv(*ops)
    torch.cuda.synchronize()
    assert krwkv.launches == {**before, key: before[key] + 1}
    _assert_close(y, want_y, CUDA_TOL, "y")
    _assert_close(sT, want_s, CUDA_TOL, "sT")
    # the final state written in place over s0
    s0 = ops[-1]
    y2, s2 = krwkv.rwkv6_wkv(*ops[:-1], s0, state_out=s0)
    torch.cuda.synchronize()
    assert s2 is s0 and torch.equal(y2, y) and torch.equal(s0, sT)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", DECAYS[:3])
@pytest.mark.parametrize("B,T,H,hd", [(1, 1, 4, 64), (1, 15, 4, 64),
                                      (1, 16, 32, 64), (1, 17, 2, 128),
                                      (2, 130, 3, 20), (1, 1000, 32, 64)])
def test_cuda_chunked_kernel_matches_plain(cuda, B, T, H, hd, mode):
    """The chunked kernel at any T (one step and one chunk -1 included),
    decays with exact zeros and subnormals, bf16 and fp32, the final state
    written over s0."""
    arrays = _chunk_inputs(B, T, H, hd, mode, False)
    for dtype in DTYPES:
        ops = _torch(arrays, dtype, cuda)
        want_y, want_s = ref.rwkv6_wkv(*ops)
        before = dict(krwkv.launches)
        y, sT = krwkv.rwkv6_wkv_chunked(*ops)
        torch.cuda.synchronize()
        assert krwkv.launches == {**before, "rwkv6_wkv_chunked":
                                  before["rwkv6_wkv_chunked"] + 1}
        _assert_close(y, want_y, CUDA_TOL, f"y {dtype}")
        _assert_close(sT, want_s, CUDA_TOL, f"sT {dtype}")
        s0 = ops[-1]
        y2, s2 = krwkv.rwkv6_wkv_chunked(*ops[:-1], s0, state_out=s0)
        torch.cuda.synchronize()
        assert s2 is s0 and torch.equal(y2, y) and torch.equal(s0, sT)


#: the tick kernel's own cases: 1 and several steps, hd 1, 20, 64, 100,
#: 128, and a state row of hd floats that leaves s0's rows 16-byte aligned
#: only at hd % 4 == 0 (the vector and the scalar state I/O)
TICK_SHAPES = [(8, 1, 32, 64), (2, 5, 4, 64), (3, 1, 2, 1), (2, 7, 3, 20),
               (2, 1, 2, 100), (1, 15, 2, 128), (4, 1, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", DECAYS)
@pytest.mark.parametrize("B,T,H,hd", TICK_SHAPES)
def test_cuda_tick_kernel_matches_plain_and_its_mirror(cuda, B, T, H, hd,
                                                       mode):
    """The tick kernel through the dispatch (counted under ``rwkv6_wkv``),
    bf16 and fp32, decays with exact zeros, subnormals and near 1, zero
    and random states: within ``CUDA_TOL`` of the plain version, within
    1e-5 of its mirror (the same order of fp32 operations; the mirror's
    fused multiply-add rounds twice, through float64), the final state
    written over s0 equal to the separate one."""
    for dtype, zero_state in itertools.product(DTYPES, (False, True)):
        ops = _torch(_chunk_inputs(B, T, H, hd, mode, zero_state), dtype,
                     cuda)
        want_y, want_s = ref.rwkv6_wkv(*ops)
        mir_y, mir_s = ref.rwkv6_wkv_tick_lanes(*ops)
        before = dict(krwkv.launches)
        y, sT = krwkv.rwkv6_wkv(*ops)
        torch.cuda.synchronize()
        assert krwkv.launches == {**before,
                                  "rwkv6_wkv": before["rwkv6_wkv"] + 1}
        what = f"{dtype} s0 {'zero' if zero_state else 'random'}"
        _assert_close(y, want_y, CUDA_TOL, f"y {what}")
        _assert_close(sT, want_s, CUDA_TOL, f"sT {what}")
        _assert_close(y, mir_y, 1e-5, f"y against the mirror, {what}")
        _assert_close(sT, mir_s, 1e-5, f"sT against the mirror, {what}")
        s0 = ops[-1]
        y2, s2 = krwkv.rwkv6_wkv(*ops[:-1], s0, state_out=s0)
        torch.cuda.synchronize()
        assert s2 is s0 and torch.equal(y2, y) and torch.equal(s0, sT)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd", [(8, 1, 32, 64), (1, 7, 4, 32),
                                      (2, 33, 2, 128), (1, 5, 3, 20)])
def test_cuda_recurrent_kernel_matches_plain(cuda, B, T, H, hd):
    """The recurrent kernel, which only ``rwkv6_wkv_recurrent`` reaches,
    at any T, counted under its own key."""
    for dtype in DTYPES:
        ops = _torch(_inputs(B, T, H, hd, B + T + hd), dtype, cuda)
        want_y, want_s = ref.rwkv6_wkv(*ops)
        before = dict(krwkv.launches)
        y, sT = krwkv.rwkv6_wkv_recurrent(*ops)
        torch.cuda.synchronize()
        assert krwkv.launches == {**before, "rwkv6_wkv_recurrent":
                                  before["rwkv6_wkv_recurrent"] + 1}
        _assert_close(y, want_y, CUDA_TOL, f"y {dtype}")
        _assert_close(sT, want_s, CUDA_TOL, f"sT {dtype}")


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernel_does_not_take(cuda):
    r, k, v, w, u, s0 = _torch(_inputs(2, 4, 2, 8, 0), "float32", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        krwkv.rwkv6_wkv(r.transpose(0, 1).contiguous().transpose(0, 1), k,
                        v, w, u, s0)
    with pytest.raises(ValueError, match="several devices"):
        krwkv.rwkv6_wkv(r, k, v, w, u.cpu(), s0)
    y, s = krwkv.rwkv6_wkv(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    assert y.shape == (2, 0, 2, 8) and torch.equal(s, s0)
    buf = torch.zeros(s0.numel() + 8, device=cuda)
    with pytest.raises(ValueError, match="overlaps s0"):
        krwkv.rwkv6_wkv(r, k, v, w, u, buf[:s0.numel()].view(s0.shape),
                        state_out=buf[8:].view(s0.shape))


if __name__ == "__main__":
    _reference(sys.argv[1])
