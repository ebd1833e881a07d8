"""The port's int4_block and fp8_sim codec kernels against the reference's
Pallas kernels.

On the CPU the wrappers in ``repro_torch.kernels.codec`` run their plain
versions (``kernels/ref.py``); those are held against
``repro.kernels.codec.int4_*`` and ``fp8_*`` with ``interpret=True`` on the
same numpy inputs. Wire bytes, scales, residuals and decode-reduce sums
all match bitwise: both sides use the f32 reciprocal scale, round half to
even, round ``c - q*scale`` and every ``acc + q*scale`` once, and
accumulate the peers in order from 0. Where a slice holds a NaN the wire
byte is not specified; NaN positions are compared instead. The
``cuda``-marked tests hold each CUDA kernel against its plain version on
the card, bitwise, and skip where there is no card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import codec as tkern
from repro_torch.kernels import ref

SHAPES = [(1, 256), (3, 1000), (4, 64), (2, 2048), (16, 4096)]
CODECS = ("int4", "fp8")
#: CUDA kernel names counted by each codec's encode and decode wrappers
ENCODE_KERNELS = {"int4": ("int4_block_encode",),
                  "fp8": ("fp8_amax", "fp8_encode")}
DECODE_KERNEL = {"int4": "int4_decode_reduce", "fp8": "fp8_decode_reduce"}


def _payload(shape, seed):
    rng = np.random.default_rng(seed)
    # per-row magnitudes spread over four decades, so scales differ widely
    mag = rng.uniform(0.01, 100.0, shape[:-1] + (1,))
    x = (rng.standard_normal(shape) * mag).astype(np.float32)
    err = (rng.standard_normal(shape) * 0.01 * mag).astype(np.float32)
    return x, err


def _edge_rows(L=1000):
    """Rows that reach the e4m3 subnormals (one large element, the rest
    down to 2**-10 of the scale), signed zeros, an all-zero row and values
    on rounding ties."""
    rng = np.random.default_rng(5)
    x = np.zeros((4, L), np.float32)
    x[0] = rng.standard_normal(L) * 2.0 ** rng.integers(-12, 0, L)
    x[0, 0] = 448.0
    x[1] = -0.0
    x[1, ::3] = rng.standard_normal(len(x[1, ::3])) * 1e-3
    x[1, 7] = 1.0
    x[2, :] = np.float32(1.5) * 2.0 ** rng.integers(-9, 8, L)
    x[2, 1] = 448.0  # ties: 1.5 * 2**k against scale 1 round to even
    return x


def _fn(codec, what):
    return getattr(tkern, f"{codec}_{what}"), getattr(ref, f"{codec}_{what}")


@pytest.fixture(scope="module")
def jkern():
    """The reference kernels; imported here, not at module level, so the
    ``cuda`` tests below also run on a machine without JAX."""
    pytest.importorskip("jax")
    from repro.kernels import codec
    return codec


def _assert_wire(got, want):
    np.testing.assert_array_equal(got[0]["q"].numpy(),
                                  np.asarray(want[0]["q"]))
    np.testing.assert_array_equal(got[0]["scale"].numpy(),
                                  np.asarray(want[0]["scale"]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("S,L", SHAPES)
@pytest.mark.parametrize("codec", CODECS)
def test_encode_feedback_matches_pallas(jkern, codec, S, L):
    x, err = _payload((S, L), seed=S * 31 + L)
    want = getattr(jkern, f"{codec}_encode_feedback")(x, err, interpret=True)
    got = _fn(codec, "encode_feedback")[0](torch.from_numpy(x),
                                           torch.from_numpy(err))
    _assert_wire(got, want)


@pytest.mark.parametrize("S,L", SHAPES)
@pytest.mark.parametrize("codec", CODECS)
def test_encode_residual_matches_pallas(jkern, codec, S, L):
    x, _ = _payload((S, L), seed=S + L)
    want = getattr(jkern, f"{codec}_encode_residual")(x, interpret=True)
    got = _fn(codec, "encode_residual")[0](torch.from_numpy(x))
    _assert_wire(got, want)


@pytest.mark.parametrize("codec", CODECS)
def test_edge_values_match_pallas(jkern, codec):
    """Subnormal e4m3 outputs, signed zeros, zero slices and ties."""
    x = _edge_rows()
    want = getattr(jkern, f"{codec}_encode_residual")(x, interpret=True)
    got = _fn(codec, "encode_residual")[0](torch.from_numpy(x))
    _assert_wire(got, want)
    if codec == "fp8":
        q = got[0]["q"][0]
        assert bool(((q & 0x78) == 0).logical_and(q & 0x07 != 0).any()), \
            "no subnormal e4m3 byte in the edge rows"
        assert float(got[0]["scale"][3]) == np.float32(1e-30)


@pytest.mark.parametrize("codec", CODECS)
def test_encode_rank_batch_matches_per_rank(jkern, codec):
    """A leading rank dim is the per-rank encodes stacked."""
    x, err = _payload((8, 2, 1000), seed=7)
    comp, res = _fn(codec, "encode_feedback")[0](torch.from_numpy(x),
                                                 torch.from_numpy(err))
    for r in range(8):
        want = getattr(jkern, f"{codec}_encode_feedback")(x[r], err[r],
                                                          interpret=True)
        _assert_wire(({k: v[r] for k, v in comp.items()}, res[r]), want)


@pytest.mark.parametrize("codec", CODECS)
def test_nan_propagates(codec):
    """A NaN makes its block's (int4) or slice's (fp8) scale and residuals
    NaN and leaves the others alone; the wire byte there is unspecified."""
    x = np.ones((2, 512), np.float32)
    x[0, 10] = np.nan
    comp, res = _fn(codec, "encode_residual")[0](torch.from_numpy(x))
    nan_res = np.isnan(res.numpy())
    if codec == "int4":
        assert np.isnan(float(comp["scale"][0, 0]))
        assert nan_res[0, :256].all() and not nan_res[0, 256:].any()
    else:
        assert np.isnan(float(comp["scale"][0]))
        assert nan_res[0].all()
    assert not nan_res[1].any()
    dec = _fn(codec, "decode_reduce")[0]({k: v[None] for k, v in comp.items()},
                                        512)
    np.testing.assert_array_equal(np.isnan(dec.numpy()),
                                  nan_res.any(0, keepdims=True)
                                  if codec == "fp8" else nan_res[:1])


@pytest.mark.parametrize("W", [1, 2, 8])
@pytest.mark.parametrize("codec", CODECS)
def test_decode_reduce_matches_pallas(jkern, codec, W):
    L = 777
    x, _ = _payload((W, L), seed=W)
    comp = getattr(jkern, f"{codec}_encode_residual")(x, interpret=True)[0]
    want = np.asarray(getattr(jkern, f"{codec}_decode_reduce")(
        comp, L, interpret=True))
    tcomp = {k: torch.from_numpy(np.array(v)) for k, v in comp.items()}
    got = _fn(codec, "decode_reduce")[0](tcomp, L)
    assert got.shape == (L,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("codec", CODECS)
def test_decode_reduce_rank_batch(jkern, codec):
    """A leading rank dim reduces each rank's W peers on its own."""
    R, W, L = 8, 2, 1000
    x, _ = _payload((R, W, L), seed=11)
    comp, _ = _fn(codec, "encode_residual")[0](torch.from_numpy(x))
    got = _fn(codec, "decode_reduce")[0](comp, L)
    assert got.shape == (R, L)
    for r in range(R):
        jc = {k: v[r].numpy() for k, v in comp.items()}
        want = np.asarray(getattr(jkern, f"{codec}_decode_reduce")(
            jc, L, interpret=True))
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_lowerings_registered():
    assert tkern.fused_codec_names() == ("fp8_sim", "int4_block",
                                         "int8_block")
    lw = tkern.lowering("int4_block")
    x = torch.from_numpy(_payload((3, 300), 1)[0]).t()  # non-contiguous
    comp, res = lw.encode_residual(x)
    want = ref.int4_encode_residual(x.contiguous())
    assert torch.equal(comp["q"], want[0]["q"]) and torch.equal(res, want[1])


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version, bitwise
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _same(a, b):
    """Bitwise equality: floats compare as bytes, so signed zeros count."""
    return torch.equal(a.view(torch.uint8) if a.is_floating_point() else a,
                       b.view(torch.uint8) if b.is_floating_point() else b)


@pytest.mark.cuda
@pytest.mark.parametrize("S,L", [(16, 131072), (3, 1000), (1, 256)])
@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("codec", CODECS)
def test_cuda_encode_matches_plain(cuda, codec, S, L, with_err):
    x, err = (torch.from_numpy(a).to(cuda) for a in _payload((S, L), S + L))
    keys = [k + ("_feedback" if with_err else "")
            for k in ENCODE_KERNELS[codec]]
    before = dict(tkern.launches)
    if with_err:
        kern, plain = _fn(codec, "encode_feedback")
        got, want = kern(x, err), plain(x, err)
    else:
        kern, plain = _fn(codec, "encode_residual")
        got, want = kern(x), plain(x)
    torch.cuda.synchronize()
    assert tkern.launches == {**before, **{k: before[k] + 1 for k in keys}}
    assert _same(got[0]["q"], want[0]["q"])
    assert _same(got[0]["scale"], want[0]["scale"])
    assert _same(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("codec", CODECS)
def test_cuda_edge_values_match_plain(cuda, codec):
    x = torch.from_numpy(_edge_rows()).to(cuda)
    got = _fn(codec, "encode_residual")[0](x)
    want = _fn(codec, "encode_residual")[1](x)
    torch.cuda.synchronize()
    assert _same(got[0]["q"], want[0]["q"])
    assert _same(got[0]["scale"], want[0]["scale"])
    assert _same(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 8])
@pytest.mark.parametrize("codec", CODECS)
def test_cuda_decode_reduce_matches_plain(cuda, codec, W):
    x, _ = _payload((8, W, 131072), seed=W)
    comp, _ = _fn(codec, "encode_residual")[1](torch.from_numpy(x).to(cuda))
    kern, plain = _fn(codec, "decode_reduce")
    before = tkern.launches[DECODE_KERNEL[codec]]
    got = kern(comp, 131072 - 5)
    torch.cuda.synchronize()
    assert tkern.launches[DECODE_KERNEL[codec]] == before + 1
    assert _same(got, plain(comp, 131072 - 5))
