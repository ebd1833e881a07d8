"""The port's selective-scan kernel against the reference's.

On the CPU the wrapper ``repro_torch.kernels.mamba.mamba_scan`` runs its
plain version (``kernels/ref.py``); the reference side — this file's
``__main__``, run once per module in a subprocess — calls the reference's
plain scan ``repro.kernels.ref.mamba_scan`` and its Pallas kernel
``repro.kernels.mamba_scan.mamba_scan(..., interpret=True)`` (both from a
zero state, T a multiple of the chunk), and the layer's sequential scan
``repro.layers.mamba._scan_ref`` from a nonzero state at any T, on the same
numpy inputs, and writes an ``.npz``. All compute in fp32 from the same
(bf16-rounded, for bf16) operands and differ only in the order of their
fp32 sums: ``TOL * (1 + |ref|)``. ``ref.mamba_scan_lanes``, the CPU
mirror of the kernel's arithmetic (``exp2`` on a pre-scaled A, a channel's
states over lanes), is held against the same reference outputs within
``CUDA_TOL``. The ``cuda``-marked tests hold the CUDA kernel against its
plain version and against the mirror on the card and skip where there is
no card.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba as kmamba
from repro_torch.kernels import ref

#: (B, T, Di, N, chunk, dblk): the reference's kernel test grid
#: (tests/test_kernels.py), zero initial state
GRID = [(1, 32, 16, 4, 8, 8), (2, 64, 64, 16, 32, 32),
        (1, 128, 32, 8, 128, 16)]
#: (B, T, Di, N) from a nonzero state: reduced jamba's width (Di 256, N
#: 16) at a prefill and a decode step, and a T and Di no chunk divides
STATE_GRID = [(2, 7, 256, 16), (3, 1, 256, 16), (1, 37, 24, 8)]
#: (B, T, Di, N) from a nonzero state at the state counts the kernel pads
#: (N 5 to 8 states over two lanes) or spreads widest (N 32 over 8 lanes)
LANE_GRID = [(2, 9, 40, 5), (1, 13, 24, 32)]
DTYPES = ("float32", "bfloat16")
#: plain version against the reference's plain scans and Pallas body, all
#: fp32: sum order only
TOL = 1e-5
#: the CUDA kernel against the plain version on the card, and the kernel's
#: CPU mirror against the reference (fp32 sums in another order, fused
#: multiply-adds, exp2 of a pre-scaled A for exp)
CUDA_TOL = 1e-4


def _inputs(B, T, Di, N, seed, zero_state=False):
    """dt (softplus of a normal), A (negative), Bm, Cm, x, h0 as float32
    numpy arrays."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, Di)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((Di, N)) * 0.5).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, N)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((B, T, Di)).astype(np.float32)
    h0 = (rng.standard_normal((B, Di, N)) * 0.1).astype(np.float32)
    if zero_state:
        h0[...] = 0
    return dt, A, Bm, Cm, x, h0


def _seed(B, T, Di, N):
    return 1000 * B + 10 * T + Di + N


def _reference(out_path: str) -> None:
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.mamba_scan import mamba_scan
    from repro.layers.mamba import _scan_ref

    res = {}
    for dt_name in DTYPES:
        for B, T, Di, N, chunk, dblk in GRID:
            dt, A, Bm, Cm, x, _ = (jnp.asarray(a) for a in _inputs(
                B, T, Di, N, _seed(B, T, Di, N)))
            x = x.astype(getattr(jnp, dt_name))
            tag = f"{B}_{T}_{Di}_{N}_{dt_name}"
            y, hT = jref.mamba_scan(dt, A, Bm, Cm, x)
            res[f"{tag}_ref_y"], res[f"{tag}_ref_h"] = (np.asarray(y),
                                                        np.asarray(hT))
            y, hT = mamba_scan(dt, A, Bm, Cm, x, chunk=chunk, dblk=dblk,
                               interpret=True)
            res[f"{tag}_pallas_y"], res[f"{tag}_pallas_h"] = (np.asarray(y),
                                                              np.asarray(hT))
        for B, T, Di, N in STATE_GRID + LANE_GRID:
            dt, A, Bm, Cm, x, h0 = (jnp.asarray(a) for a in _inputs(
                B, T, Di, N, _seed(B, T, Di, N)))
            x = x.astype(getattr(jnp, dt_name))
            y, hT = _scan_ref(dt, A, Bm, Cm, x, h0=h0)
            tag = f"{B}_{T}_{Di}_{N}_{dt_name}_state"
            res[f"{tag}_y"], res[f"{tag}_h"] = np.asarray(y), np.asarray(hT)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("mamba_scan_ref") / "ref.npz"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def _torch(arrays, dtype, device="cpu", with_state=True):
    """dt, A, Bm, Cm float32, x in ``dtype``, h0 float32 (or None)."""
    dt, A, Bm, Cm, x, h0 = (torch.from_numpy(a).to(device) for a in arrays)
    return dt, A, Bm, Cm, x.to(getattr(torch, dtype)), \
        (h0 if with_state else None)


def _assert_close(got, want, tol, what):
    got = got.double().cpu().numpy() if torch.is_tensor(got) else got
    want = want.double().cpu().numpy() if torch.is_tensor(want) else want
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    bad = err > tol * (1 + np.abs(want))
    assert not bad.any(), (f"{what}: {bad.sum()} elements outside {tol} * "
                           f"(1 + |ref|), max error {err.max()}")


@pytest.mark.parametrize("against", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,Di,N,chunk,dblk", GRID)
def test_plain_matches_reference_from_zero(reference, B, T, Di, N, chunk,
                                           dblk, dtype, against):
    ops = _torch(_inputs(B, T, Di, N, _seed(B, T, Di, N)), dtype,
                 with_state=False)
    y, hT = kmamba.mamba_scan(*ops)
    assert y.shape == (B, T, Di) and y.dtype == torch.float32
    assert hT.shape == (B, Di, N) and hT.dtype == torch.float32
    tag = f"{B}_{T}_{Di}_{N}_{dtype}_{against}"
    _assert_close(y, reference[f"{tag}_y"], TOL, f"y against {against}")
    _assert_close(hT, reference[f"{tag}_h"], TOL, f"hT against {against}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,Di,N", STATE_GRID)
def test_plain_matches_layer_scan_from_a_state(reference, B, T, Di, N,
                                               dtype):
    """From a nonzero carried state, at any T: the reference's serving
    path (``_scan_ref``)."""
    ops = _torch(_inputs(B, T, Di, N, _seed(B, T, Di, N)), dtype)
    h0 = ops[-1].clone()
    y, hT = kmamba.mamba_scan(*ops)
    assert torch.equal(ops[-1], h0), "h0 was written without state_out"
    tag = f"{B}_{T}_{Di}_{N}_{dtype}_state"
    _assert_close(y, reference[f"{tag}_y"], TOL, "y")
    _assert_close(hT, reference[f"{tag}_h"], TOL, "hT")


@pytest.mark.parametrize("against", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,Di,N,chunk,dblk", GRID)
def test_lanes_mirror_matches_reference_from_zero(reference, B, T, Di, N,
                                                  chunk, dblk, dtype,
                                                  against):
    """The kernel's arithmetic (``ref.mamba_scan_lanes``) against the
    reference's plain scan and its interpret-mode Pallas kernel."""
    ops = _torch(_inputs(B, T, Di, N, _seed(B, T, Di, N)), dtype,
                 with_state=False)
    y, hT = ref.mamba_scan_lanes(*ops)
    assert y.shape == (B, T, Di) and y.dtype == torch.float32
    assert hT.shape == (B, Di, N) and hT.dtype == torch.float32
    tag = f"{B}_{T}_{Di}_{N}_{dtype}_{against}"
    _assert_close(y, reference[f"{tag}_y"], CUDA_TOL, f"y against {against}")
    _assert_close(hT, reference[f"{tag}_h"], CUDA_TOL,
                  f"hT against {against}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,Di,N", STATE_GRID + LANE_GRID)
def test_lanes_mirror_matches_layer_scan_from_a_state(reference, B, T, Di,
                                                      N, dtype):
    """The mirror from a nonzero carried state against ``_scan_ref``, at
    the padded (N 5) and widest (N 32) lane splits too; ``h0`` is left as
    it was."""
    ops = _torch(_inputs(B, T, Di, N, _seed(B, T, Di, N)), dtype)
    h0 = ops[-1].clone()
    y, hT = ref.mamba_scan_lanes(*ops)
    assert torch.equal(ops[-1], h0)
    tag = f"{B}_{T}_{Di}_{N}_{dtype}_state"
    _assert_close(y, reference[f"{tag}_y"], CUDA_TOL, "y")
    _assert_close(hT, reference[f"{tag}_h"], CUDA_TOL, "hT")


@pytest.mark.parametrize("B,T,Di,N", LANE_GRID)
def test_plain_matches_layer_scan_at_lane_splits(reference, B, T, Di, N):
    """The plain version at N 5 and 32 against ``_scan_ref``."""
    ops = _torch(_inputs(B, T, Di, N, _seed(B, T, Di, N)), "float32")
    y, hT = kmamba.mamba_scan(*ops)
    tag = f"{B}_{T}_{Di}_{N}_float32_state"
    _assert_close(y, reference[f"{tag}_y"], TOL, "y")
    _assert_close(hT, reference[f"{tag}_h"], TOL, "hT")


def test_plain_matches_float64_recurrence():
    """The scan written out in float64 over numpy."""
    dt, A, Bm, Cm, x, h0 = (a.astype(np.float64)
                            for a in _inputs(2, 19, 12, 5, 3))
    h = h0.copy()
    ys = []
    for t in range(dt.shape[1]):
        h = np.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(np.einsum("bdn,bn->bd", h, Cm[:, t]))
    y, hT = ref.mamba_scan(*(torch.from_numpy(a).float()
                             for a in (dt, A, Bm, Cm, x, h0)))
    _assert_close(y, np.stack(ys, 1), TOL, "y")
    _assert_close(hT, h, TOL, "hT")


def test_state_out_may_alias_h0_and_t0_keeps_the_state():
    """The final state written over ``h0`` equals a fresh one; ``T = 0``
    gives an empty ``y`` and leaves the state as it was (zeros without
    ``h0``)."""
    ops = _torch(_inputs(2, 9, 40, 16, 7), "float32")
    y, hT = kmamba.mamba_scan(*ops)
    h0 = ops[-1].clone()
    y2, hT2 = kmamba.mamba_scan(*ops[:-1], h0, state_out=h0)
    assert hT2 is h0 and torch.equal(h0, hT) and torch.equal(y2, y)
    dt, A, Bm, Cm, x = (t[:, :0] if t.dim() == 3 else t for t in ops[:-1])
    before = h0.clone()
    y0, h_out = kmamba.mamba_scan(dt, A, Bm, Cm, x, h0, state_out=h0)
    assert y0.shape == (2, 0, 40) and h_out is h0
    assert torch.equal(h0, before)
    y0, h_new = kmamba.mamba_scan(dt, A, Bm, Cm, x, h0)
    assert h_new is not h0 and torch.equal(h_new, before)
    out = torch.ones_like(h0)
    _, h_zero = kmamba.mamba_scan(dt, A, Bm, Cm, x, state_out=out)
    assert h_zero is out and not bool(out.any())


def test_cpu_path_counts_no_launch():
    kmamba.reset_launches()
    kmamba.mamba_scan(*_torch(_inputs(1, 4, 8, 4, 0), "bfloat16"))
    kmamba.mamba_scan(*_torch(_inputs(2, 1, 8, 4, 1), "float32",
                              with_state=False))
    assert kmamba.launches == {"mamba_scan": 0}


def test_dispatch_refuses_other_devices_dtypes_and_shapes():
    dt, A, Bm, Cm, x, h0 = _torch(_inputs(2, 4, 8, 4, 0), "float32")
    meta = [t.to("meta") for t in (dt, A, Bm, Cm, x, h0)]
    with pytest.raises(ValueError, match="no kernel for device"):
        kmamba.mamba_scan(*meta)
    with pytest.raises(ValueError, match="several devices"):
        kmamba.mamba_scan(dt, A, Bm.to("meta"), Cm, x, h0)
    with pytest.raises(ValueError, match="several devices"):
        kmamba.mamba_scan(dt, A, Bm, Cm, x, h0, state_out=h0.to("meta"))
    with pytest.raises(TypeError, match="dt: expected torch.float32"):
        kmamba.mamba_scan(dt.bfloat16(), A, Bm, Cm, x, h0)
    with pytest.raises(TypeError, match="Cm: expected torch.float32"):
        kmamba.mamba_scan(dt, A, Bm, Cm.double(), x, h0)
    with pytest.raises(TypeError, match="h0: expected torch.float32"):
        kmamba.mamba_scan(dt, A, Bm, Cm, x, h0.bfloat16())
    with pytest.raises(TypeError, match="x: expected bfloat16 or float32"):
        kmamba.mamba_scan(dt, A, Bm, Cm, x.half(), h0)
    with pytest.raises(ValueError, match="Bm: expected"):
        kmamba.mamba_scan(dt, A, Bm[:, :1], Cm, x, h0)
    with pytest.raises(ValueError, match="A: expected"):
        kmamba.mamba_scan(dt, A[:3], Bm, Cm, x, h0)
    with pytest.raises(ValueError, match="takes dt"):
        kmamba.mamba_scan(dt[0], A, Bm, Cm, x, h0)
    big = _torch(_inputs(1, 2, 4, 33, 0), "float32")
    with pytest.raises(ValueError, match="N <= 32"):
        kmamba.mamba_scan(*big)


def test_state_out_may_alias_h0_but_not_overlap_it_partly():
    dt, A, Bm, Cm, x, h0 = _torch(_inputs(2, 4, 8, 4, 0), "float32")
    want_y, want_h = ref.mamba_scan(dt, A, Bm, Cm, x, h0.clone())
    # another view of the same bytes is h0 itself
    y, hT = kmamba.mamba_scan(dt, A, Bm, Cm, x, h0,
                              state_out=h0.view(h0.shape))
    assert torch.equal(y, want_y) and torch.equal(h0, want_h)
    # a view shifted by one channel's states shares bytes with h0
    buf = torch.zeros(h0.numel() + 4)
    base = buf[:h0.numel()].view(h0.shape)
    shifted = buf[4:].view(h0.shape)
    with pytest.raises(ValueError, match="overlaps h0"):
        kmamba.mamba_scan(dt, A, Bm, Cm, x, base, state_out=shifted)
    with pytest.raises(ValueError, match="overlaps h0"):
        kmamba.mamba_scan(dt, A, Bm, Cm, x, shifted, state_out=base)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


#: the decode tick and a prefill of full-width jamba (Di 16384, N 16), the
#: reduced config (Di 256), channels no CTA's 32 divide, N 32 and N 5, and
#: the reference's grid; then runs of 32 steps and more at N 5 and 32 and
#: at a Di no CTA width divides
CUDA_SHAPES = [(8, 1, 16384, 16), (1, 77, 16384, 16), (2, 130, 256, 16),
               (1, 7, 256, 16), (2, 33, 40, 32), (3, 5, 20, 5)] + \
    [g[:4] for g in GRID] + \
    [(2, 130, 256, 5), (2, 130, 256, 32), (2, 130, 200, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,Di,N", CUDA_SHAPES)
def test_cuda_kernel_matches_plain(cuda, B, T, Di, N, dtype, zero_state):
    ops = _torch(_inputs(B, T, Di, N, B + T + Di + N), dtype, cuda,
                 with_state=not zero_state)
    want_y, want_h = ref.mamba_scan(*ops)
    before = kmamba.launches["mamba_scan"]
    y, hT = kmamba.mamba_scan(*ops)
    torch.cuda.synchronize()
    assert kmamba.launches["mamba_scan"] == before + 1
    _assert_close(y, want_y, CUDA_TOL, "y")
    _assert_close(hT, want_h, CUDA_TOL, "hT")
    # the final state written in place over h0
    h0 = ops[-1] if not zero_state else torch.zeros_like(hT)
    y2, h2 = kmamba.mamba_scan(*ops[:-1], h0, state_out=h0)
    torch.cuda.synchronize()
    assert h2 is h0 and torch.equal(y2, y) and torch.equal(h0, hT)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,Di,N", CUDA_SHAPES)
def test_cuda_kernel_matches_lanes_mirror(cuda, B, T, Di, N, dtype):
    """The kernel against the mirror of its own arithmetic, run on the
    card, from a random state: within ``TOL``, since only the
    exponential's last bits (the card's 2-ulp MUFU against the mirror's
    ``exp2``) and the mirror's float64 route to a fused multiply-add may
    differ."""
    ops = _torch(_inputs(B, T, Di, N, B + T + Di + N), dtype, cuda)
    want_y, want_h = ref.mamba_scan_lanes(*ops)
    y, hT = kmamba.mamba_scan(*ops)
    torch.cuda.synchronize()
    _assert_close(y, want_y, TOL, "y")
    _assert_close(hT, want_h, TOL, "hT")


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernel_does_not_take(cuda):
    dt, A, Bm, Cm, x, h0 = _torch(_inputs(2, 4, 8, 4, 0), "float32", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kmamba.mamba_scan(dt.transpose(0, 1).contiguous().transpose(0, 1),
                          A, Bm, Cm, x, h0)
    with pytest.raises(ValueError, match="several devices"):
        kmamba.mamba_scan(dt, A.cpu(), Bm, Cm, x, h0)
    y, h = kmamba.mamba_scan(dt[:, :0], A, Bm[:, :0], Cm[:, :0], x[:, :0],
                             h0)
    assert y.shape == (2, 0, 8) and torch.equal(h, h0)
    buf = torch.zeros(h0.numel() + 4, device=cuda)
    with pytest.raises(ValueError, match="overlaps h0"):
        kmamba.mamba_scan(dt, A, Bm, Cm, x, buf[:h0.numel()].view(h0.shape),
                          state_out=buf[4:].view(h0.shape))


if __name__ == "__main__":
    _reference(sys.argv[1])
