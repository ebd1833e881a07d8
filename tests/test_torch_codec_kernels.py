"""The port's int8 codec kernels against the reference's Pallas kernels.

On the CPU the wrappers in ``repro_torch.kernels.codec`` run their plain
versions (``kernels/ref.py``); those are held against
``repro.kernels.codec.int8_*(..., interpret=True)`` on the same numpy
inputs. Wire form, scales and residuals match bitwise (both sides round
``c - q*scale`` once, as XLA contracts it into a fused multiply-add), and
so does decode_reduce (each ``acc + q*scale`` rounded once, peers in order
from 0). The ``cuda``-marked
tests hold each CUDA kernel against its plain version on the card,
bitwise, and skip where there is no card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import codec as tkern
from repro_torch.kernels import ref

SHAPES = [(1, 256), (3, 1000), (4, 64), (2, 2048), (16, 4096)]


def _payload(shape, seed):
    rng = np.random.default_rng(seed)
    # per-row magnitudes spread over four decades, so scales differ widely
    mag = rng.uniform(0.01, 100.0, shape[:-1] + (1,))
    x = (rng.standard_normal(shape) * mag).astype(np.float32)
    err = (rng.standard_normal(shape) * 0.01 * mag).astype(np.float32)
    return x, err


@pytest.fixture(scope="module")
def jkern():
    """The reference kernels; imported here, not at module level, so the
    ``cuda`` tests below also run on a machine without JAX."""
    pytest.importorskip("jax")
    from repro.kernels import codec
    return codec


def _assert_wire(got, want):
    np.testing.assert_array_equal(got[0]["q"].numpy(), np.asarray(want[0]["q"]))
    np.testing.assert_array_equal(got[0]["scale"].numpy(),
                                  np.asarray(want[0]["scale"]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("S,L", SHAPES)
def test_int8_encode_feedback_matches_pallas(jkern, S, L):
    x, err = _payload((S, L), seed=S * 31 + L)
    want = jkern.int8_encode_feedback(x, err, interpret=True)
    got = tkern.int8_encode_feedback(torch.from_numpy(x),
                                     torch.from_numpy(err))
    _assert_wire(got, want)


@pytest.mark.parametrize("S,L", SHAPES)
def test_int8_encode_residual_matches_pallas(jkern, S, L):
    x, _ = _payload((S, L), seed=S + L)
    want = jkern.int8_encode_residual(x, interpret=True)
    got = tkern.int8_encode_residual(torch.from_numpy(x))
    _assert_wire(got, want)


def test_int8_encode_rank_batch_matches_per_rank(jkern):
    """A leading rank dim is the per-rank encodes stacked."""
    x, err = _payload((8, 2, 1000), seed=7)
    comp, res = tkern.int8_encode_feedback(torch.from_numpy(x),
                                           torch.from_numpy(err))
    assert comp["q"].shape == (8, 2, 4, 256) and comp["scale"].shape == (8, 2, 4)
    for r in range(8):
        want = jkern.int8_encode_feedback(x[r], err[r], interpret=True)
        np.testing.assert_array_equal(comp["q"][r].numpy(),
                                      np.asarray(want[0]["q"]))
        np.testing.assert_array_equal(res[r].numpy(), np.asarray(want[1]))


def test_int8_encode_zero_block_and_nan():
    """An all-zero block gets scale 0, q 0 and residual 0 (no NaN); a NaN
    makes its block's scale and residual NaN and leaves the others alone."""
    x = np.zeros((1, 512), np.float32)
    x[0, 300] = 2.0
    comp, res = tkern.int8_encode_residual(torch.from_numpy(x))
    assert float(comp["scale"][0, 0]) == 0.0
    assert not comp["q"][0, 0].any() and not res[0, :256].any()
    x[0, 10] = np.nan
    comp, res = tkern.int8_encode_residual(torch.from_numpy(x))
    assert np.isnan(float(comp["scale"][0, 0]))
    assert np.isnan(res[0, :256].numpy()).all()
    assert float(comp["scale"][0, 1]) == np.float32(2.0) * np.float32(1 / 127)


@pytest.mark.parametrize("W", [1, 2, 3, 5, 8, 9, 17])
def test_int8_decode_reduce_matches_pallas(jkern, W):
    L = 777
    x, _ = _payload((W, L), seed=W)
    comp = jkern.int8_encode_residual(x, interpret=True)[0]
    want = np.asarray(jkern.int8_decode_reduce(comp, L, interpret=True))
    tcomp = {k: torch.from_numpy(np.array(v)) for k, v in comp.items()}
    got = tkern.int8_decode_reduce(tcomp, L)
    assert got.shape == (L,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_decode_reduce_rank_batch(jkern):
    """A leading rank dim reduces each rank's W peers on its own."""
    R, W, L = 8, 2, 1000
    x, _ = _payload((R, W, L), seed=11)
    comp, _ = tkern.int8_encode_residual(torch.from_numpy(x))
    got = tkern.int8_decode_reduce(comp, L)
    assert got.shape == (R, L)
    for r in range(R):
        jc = {k: v[r].numpy() for k, v in comp.items()}
        want = np.asarray(jkern.int8_decode_reduce(jc, L, interpret=True))
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_cpu_path_counts_no_launches():
    tkern.reset_launches()
    x, err = _payload((2, 300), seed=3)
    comp, _ = tkern.int8_encode_feedback(torch.from_numpy(x),
                                         torch.from_numpy(err))
    tkern.int8_decode_reduce(comp, 300)
    for enc, dec in ((tkern.int4_encode_feedback, tkern.int4_decode_reduce),
                     (tkern.fp8_encode_feedback, tkern.fp8_decode_reduce)):
        comp, _ = enc(torch.from_numpy(x), torch.from_numpy(err))
        dec({k: v[None] for k, v in comp.items()}, 300)
    assert set(tkern.launches) == {
        "int8_block_encode", "int8_block_encode_feedback",
        "int8_decode_reduce", "int4_block_encode",
        "int4_block_encode_feedback", "int4_decode_reduce", "fp8_amax",
        "fp8_encode", "fp8_amax_feedback", "fp8_encode_feedback",
        "fp8_decode_reduce"}
    assert not any(tkern.launches.values())


def _misaligned_wire(R, W, nb, offset):
    """A contiguous ``(R, W, nb, 256)`` int8 wire view starting ``offset``
    bytes into its storage, with its scales."""
    buf = torch.zeros(R * W * nb * 256 + offset, dtype=torch.int8)
    q = buf[offset:].view(R, W, nb, 256)
    return {"q": q, "scale": torch.ones((R, W, nb))}


def test_int8_decode_launch_refuses_a_misaligned_wire():
    """The vector kernel reads q in 8-byte vectors: its launch raises on a
    wire address that is not 8-byte aligned (before it builds or launches
    anything), and the plain version takes the same wire."""
    comp = _misaligned_wire(2, 3, 2, 4)
    assert comp["q"].is_contiguous() and comp["q"].data_ptr() % 8 == 4
    with pytest.raises(ValueError, match="8-byte aligned"):
        tkern._block_decode_launch("codec_int8", "int8_decode_reduce",
                                   torch.int8, 256, comp, 300, align=8)
    got = tkern.int8_decode_reduce(comp, 300)
    assert got.shape == (2, 300) and not bool(got.any())


def test_wrappers_reject_unsupported_operands():
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError):
        tkern.int8_encode_feedback(x, torch.zeros(2, 256, device="meta"))
    with pytest.raises(ValueError):
        tkern.int8_encode_residual(torch.zeros(2, 256, device="meta"))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version, bitwise
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,L", [(16, 131072), (3, 1000), (1, 256)])
@pytest.mark.parametrize("with_err", [False, True])
def test_cuda_encode_matches_plain(cuda, S, L, with_err):
    x, err = (torch.from_numpy(a).to(cuda) for a in _payload((S, L), S + L))
    key = "int8_block_encode" + ("_feedback" if with_err else "")
    before = dict(tkern.launches)
    if with_err:
        got, want = tkern.int8_encode_feedback(x, err), \
            ref.int8_encode_feedback(x, err)
    else:
        got, want = tkern.int8_encode_residual(x), ref.int8_encode_residual(x)
    torch.cuda.synchronize()
    assert tkern.launches == {**before, key: before[key] + 1}
    assert torch.equal(got[0]["q"], want[0]["q"])
    assert torch.equal(got[0]["scale"], want[0]["scale"])
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 3, 5, 8])
def test_cuda_decode_reduce_matches_plain(cuda, W):
    x, _ = _payload((8, W, 131072), seed=W)
    comp, _ = ref.int8_encode_residual(torch.from_numpy(x).to(cuda))
    before = tkern.launches["int8_decode_reduce"]
    got = tkern.int8_decode_reduce(comp, 131072 - 5)
    torch.cuda.synchronize()
    assert tkern.launches["int8_decode_reduce"] == before + 1
    assert torch.equal(got, ref.int8_decode_reduce(comp, 131072 - 5))


#: (R, W, encoded length, decoded length): rows whose float4 stores are
#: misaligned (L % 4 != 0), a last vector cut inside (L % 16 != 0), W
#: outside the unrolled 1, 2, 4, 8 (3, 5, 9, 13, 17: groups of 8 and a
#: rest), a decode shorter than the wire, and the last gradient bucket's
#: rows (7800: for fp8 a wire row of 8-byte, not 16-byte multiples)
TAIL_CASES = [(2, 2, 999, 999), (1, 2, 1000, 1000), (3, 4, 4097, 4097),
              (8, 3, 131072, 131072), (8, 5, 131072, 131072),
              (2, 9, 2000, 2000), (2, 13, 515, 515), (1, 1, 1, 1),
              (2, 2, 16, 16), (2, 2, 1024, 1001), (2, 2, 1024, 1020),
              (8, 2, 7800, 7800), (3, 17, 999, 999), (2, 9, 7800, 7795),
              (2, 3, 1001, 1001)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,W,L,length", TAIL_CASES)
def test_cuda_decode_reduce_vector_tails(cuda, R, W, L, length):
    x, _ = _payload((R, W, L), seed=R * 100 + W * 10 + L)
    comp, _ = ref.int8_encode_residual(torch.from_numpy(x).to(cuda))
    got = tkern.int8_decode_reduce(comp, length)
    torch.cuda.synchronize()
    want = ref.int8_decode_reduce(comp, length)
    assert got.shape == (R, length)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3, 8])
@pytest.mark.parametrize("R,W,L,length", TAIL_CASES)
def test_cuda_fp8_decode_reduce_tails(cuda, R, W, L, length, offset):
    """The fp8 kernel on the same tails, with its wire rows of L bytes (the
    vector path where L % 8 == 0, the element path elsewhere) and the wire
    starting ``offset`` bytes into its buffer (odd offsets: the element
    path), bitwise."""
    x, _ = _payload((R, W, L), seed=R * 100 + W * 10 + L)
    comp, _ = ref.fp8_encode_residual(torch.from_numpy(x).to(cuda))
    buf = torch.zeros(comp["q"].numel() + offset, dtype=torch.uint8,
                      device=cuda)
    comp["q"] = buf[offset:].view(comp["q"].shape).copy_(comp["q"])
    assert comp["q"].data_ptr() % 8 == offset % 8
    before = tkern.launches["fp8_decode_reduce"]
    got = tkern.fp8_decode_reduce(comp, length)
    torch.cuda.synchronize()
    assert tkern.launches["fp8_decode_reduce"] == before + 1
    want = ref.fp8_decode_reduce(comp, length)
    assert got.shape == (R, length)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_decode_reduce_refuses_a_misaligned_wire(cuda):
    comp = {k: v.to(cuda) for k, v in _misaligned_wire(2, 3, 2, 0).items()}
    buf = torch.zeros(comp["q"].numel() + 4, dtype=torch.int8, device=cuda)
    comp["q"] = buf[4:].view(comp["q"].shape)
    before = tkern.launches["int8_decode_reduce"]
    with pytest.raises(ValueError, match="8-byte aligned"):
        tkern.int8_decode_reduce(comp, 300)
    assert tkern.launches["int8_decode_reduce"] == before
