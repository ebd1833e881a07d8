"""The port's int4_block and fp8_sim codec kernels against the reference's
Pallas kernels.

On the CPU the wrappers in ``repro_torch.kernels.codec`` run their plain
versions (``kernels/ref.py``); those are held against
``repro.kernels.codec.int4_*`` and ``fp8_*`` with ``interpret=True`` on the
same numpy inputs. Wire bytes, scales, residuals and decode-reduce sums
all match bitwise: both sides use the f32 reciprocal scale, round half to
even, round ``c - q*scale`` and every ``acc + q*scale`` once, and
accumulate the peers in order from 0. Where c / scale is NaN (a NaN in the
block, or +-inf against an infinite scale) int4 stores nibble 8 and a NaN
residual, as the reference does; NaN residuals compare by position. The
``cuda``-marked tests hold each CUDA kernel against its plain version on
the card, bitwise, and skip where there is no card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import codec as tkern
from repro_torch.kernels import ref

SHAPES = [(1, 256), (3, 1000), (4, 64), (2, 2048), (16, 4096)]
CODECS = ("int4", "fp8")
#: CUDA kernel names counted by each codec's encode and decode wrappers
ENCODE_KERNELS = {"int4": ("int4_block_encode",), "fp8": ("fp8_encode",)}
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


#: the fp8 and int4 encode kernels' edges at sizes the reference's
#: interpret mode takes on the CPU (S, L, offset, special): L % 4 != 0, a
#: slice shorter than a warp's vector, a view one float past a 16-byte
#: boundary, and slices holding a NaN, +-inf and zeros
FP8_CPU_EDGES = [(4, 1001, 0, False), (2, 255, 0, False),
                 (3, 1000, 1, False), (4, 1000, 0, True),
                 (4, 1001, 1, True)]
#: the fp8 and int4 encode kernels' cases on the card: the main path's
#: (16, 131072) and (8, 131072) (fp8: clusters of 8 CTAs, rows in
#: registers), rows fp8 walks twice ((16, 524288), one slice of 1 << 22;
#: int4: more blocks than its grid's warps), short rows, the edges above,
#: and a misaligned (16, 131072) (the scalar paths)
FP8_CUDA_CASES = [(16, 131072, 0, False), (8, 131072, 0, False),
                  (16, 524288, 0, False), (1, 1 << 22, 0, False),
                  (3, 1000, 0, False), (1, 256, 0, False),
                  (4, 1001, 0, False), (2, 131070, 0, False),
                  (16, 131072, 1, False), (3, 1000, 1, False),
                  (8, 131072, 0, True), (4, 1001, 1, True)]


def _encode_operands(S, L, offset, special, device="cpu"):
    """x and err of one encode case as contiguous views starting
    ``offset`` floats into their buffers. ``special``: slice 0 holds a NaN,
    slice 1 +inf and -inf, slice 2 zeros (x and err)."""
    x, err = _payload((S, L), seed=S + L + offset)
    if special:
        x[0, L // 3] = np.nan
        x[1, 5], x[1, L - 2] = np.inf, -np.inf
        x[2], err[2] = 0.0, 0.0

    def put(a):
        buf = torch.zeros(a.size + offset, dtype=torch.float32,
                          device=device)
        return buf[offset:].view(a.shape).copy_(torch.from_numpy(a))
    return put(x), put(err)


@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("S,L,offset,special", FP8_CPU_EDGES)
def test_fp8_encode_edges_match_pallas(jkern, S, L, offset, special,
                                       with_err):
    """The plain fp8 encode against the reference's kernel at the
    kernel's edges: q and scale bitwise, residual bitwise up to the sign
    of a NaN (which the CPU's arithmetic and XLA's give otherwise)."""
    x, err = _encode_operands(S, L, offset, special)
    assert x.is_contiguous() and x.storage_offset() == offset
    if with_err:
        want = jkern.fp8_encode_feedback(x.numpy(), err.numpy(),
                                         interpret=True)
        got = tkern.fp8_encode_feedback(x, err)
    else:
        want = jkern.fp8_encode_residual(x.numpy(), interpret=True)
        got = tkern.fp8_encode_residual(x)
    _assert_wire(got, want)
    if special:
        scale = got[0]["scale"]
        assert np.isnan(float(scale[0])) and float(scale[1]) == np.inf
        assert float(scale[2]) == np.float32(1e-30)
        assert np.isnan(got[1][:2].numpy()).all() and not got[1][2].any()


@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("S,L,offset,special", FP8_CPU_EDGES)
def test_int4_encode_edges_match_pallas(jkern, S, L, offset, special,
                                        with_err):
    """The plain int4 encode against the reference's kernel at the same
    edges: q and scale bitwise, residual NaNs by position. Where c / scale
    is NaN both store nibble 8: byte 136 throughout slice 0's NaN block;
    slice 1's first block (+inf) has an infinite scale and every residual
    NaN (0 * inf); slice 2's scales are 0."""
    x, err = _encode_operands(S, L, offset, special)
    assert x.is_contiguous() and x.storage_offset() == offset
    if with_err:
        want = jkern.int4_encode_feedback(x.numpy(), err.numpy(),
                                          interpret=True)
        got = tkern.int4_encode_feedback(x, err)
    else:
        want = jkern.int4_encode_residual(x.numpy(), interpret=True)
        got = tkern.int4_encode_residual(x)
    _assert_wire(got, want)
    if special:
        q, scale = got[0]["q"].numpy(), got[0]["scale"].numpy()
        assert (q[0, (L // 3) // 256] == 136).all()
        assert scale[1, 0] == np.inf
        assert np.isnan(got[1][1, :256].numpy()).all()
        assert not scale[2].any()


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
    NaN and leaves the others alone; int4 stores byte 136 (nibble 8 twice)
    throughout the NaN block, fp8's wire byte there is unspecified."""
    x = np.ones((2, 512), np.float32)
    x[0, 10] = np.nan
    comp, res = _fn(codec, "encode_residual")[0](torch.from_numpy(x))
    nan_res = np.isnan(res.numpy())
    if codec == "int4":
        assert np.isnan(float(comp["scale"][0, 0]))
        assert (comp["q"][0, 0] == 136).all()
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


#: fp8 wires (W, Lq, decoded length): the last gradient bucket's rows
#: (Lq 7800: 8-byte but not 16-byte multiples), an odd Lq and a one-byte
#: row, each decoded shorter than the wire, and W 9 and 17 (a group of 8
#: peers and a rest)
FP8_WIRES = [(2, 7800, 7799), (2, 999, 990), (2, 1, 0), (9, 7800, 7800),
             (17, 999, 999), (9, 1, 1), (17, 7800, 4000)]


def _offset_view(a, offset, device="cpu"):
    """A contiguous copy of the uint8 array ``a`` starting ``offset`` bytes
    into a larger buffer."""
    buf = torch.zeros(a.size + offset, dtype=torch.uint8, device=device)
    q = buf[offset:].view(a.shape)
    q.copy_(torch.from_numpy(np.array(a)))
    return q


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("W,Lq,length", FP8_WIRES)
def test_fp8_decode_reduce_wires_match_pallas(jkern, W, Lq, length, offset):
    """Any Lq and decoded length, any W, and a wire starting at an odd
    byte of its buffer (a contiguous view): bitwise."""
    x, _ = _payload((W, Lq), seed=W * 7 + Lq)
    comp = jkern.fp8_encode_residual(x, interpret=True)[0]
    want = np.asarray(jkern.fp8_decode_reduce(comp, length, interpret=True))
    q = _offset_view(np.asarray(comp["q"]), offset)
    assert q.is_contiguous() and q.storage_offset() == offset
    got = tkern.fp8_decode_reduce(
        {"q": q, "scale": torch.from_numpy(np.array(comp["scale"]))}, length)
    assert got.shape == (length,)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(np.int32))


def _main_path_wires(monkeypatch, codec, collective, n):
    """``(q shape, q storage offset, length)`` of each wire that
    ``collective`` over ``n`` floats per rank on the 2x4 grid, through
    pip_mcoll under ``codec``, hands that codec's decode-reduce."""
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid

    seen = []
    lw = tkern.lowering(codec)

    def spy(comp, length):
        seen.append((tuple(comp["q"].shape), comp["q"].storage_offset(),
                     length))
        return lw.decode_reduce(comp, length)

    monkeypatch.setitem(tkern.LOWERINGS, codec,
                        dataclasses.replace(lw, decode_reduce=spy))
    comm = Communicator(RankGrid(2, 4, "cpu"))
    x = torch.from_numpy(_payload((8, n), seed=n)[0])
    getattr(comm, collective)(x, algo="pip_mcoll", codec=codec)
    return seen


@pytest.mark.parametrize("n", [1 << 20, 62400])
@pytest.mark.parametrize("collective", ["allreduce", "reduce_scatter"])
def test_fp8_wire_rows_on_the_main_path(monkeypatch, collective, n):
    """The wires the main path hands the fp8 decode-reduce: smollm-360m's
    4 MiB gradient buckets (2**20 floats per rank) and its last one (62,400)
    on the 2x4 grid. The compressed allreduce decodes (8, 2, Lq) rows of
    131072 and 7800 bytes (7800 % 16 == 8), the compressed reduce_scatter
    rows of 524288 and 31200, each wire a fresh contiguous tensor."""
    Lq = {"allreduce": n // 8, "reduce_scatter": n // 2}[collective]
    assert _main_path_wires(monkeypatch, "fp8_sim", collective, n) == \
        [((8, 2, Lq), 0, Lq)]


@pytest.mark.parametrize("collective,n,nb,length", [
    ("allreduce", 1 << 20, 512, 131072), ("allreduce", 62400, 31, 7800),
    ("reduce_scatter", 1 << 20, 2048, 524288),
    ("reduce_scatter", 62400, 122, 31200)])
def test_int4_wire_rows_on_the_main_path(monkeypatch, collective, n, nb,
                                         length):
    """The same buckets under int4_block: the wire is (8, 2, nb, 128)
    nibble pairs, nb = ceil(length / 256), each a fresh contiguous tensor
    (storage offset 0), so the kernel reads it in 4-byte words."""
    assert _main_path_wires(monkeypatch, "int4_block", collective, n) == \
        [((8, 2, nb, 128), 0, length)]


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
@pytest.mark.parametrize("codec,S,L,offset,special", [
    (codec,) + case for codec in CODECS for case in FP8_CUDA_CASES])
@pytest.mark.parametrize("with_err", [False, True])
def test_cuda_encode_matches_plain(cuda, codec, S, L, offset, special,
                                   with_err):
    x, err = _encode_operands(S, L, offset, special, cuda)
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
    if special:  # the residual's NaNs by position (the plain version
        # rounds a float64 NaN, the kernel's fused multiply-add a float32)
        nan = got[1].isnan()
        assert torch.equal(nan, want[1].isnan())
        assert _same(got[1][~nan], want[1][~nan])
    else:
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


#: (W, L, offset): the unrolled W, W 9 and 17 (groups of 8 and a rest), L
#: 7800 (the last gradient bucket's fp8 rows: 8-byte, not 16-byte
#: multiples), an odd L, and the wire starting 1, 2, 3 or 4 bytes into its
#: buffer (at 4, int4's 4-byte reads at an address no multiple of 8; at 2,
#: its byte reads), also at W 3 and 5 (outside the unrolled peer counts)
DECODE_CASES = [(1, 131072, 0), (2, 131072, 0), (8, 131072, 0),
                (9, 131072, 0), (17, 7800, 0), (2, 7800, 0), (2, 999, 0),
                (2, 131072, 1), (9, 7800, 3), (17, 999, 1),
                (3, 131072, 4), (5, 131072, 2), (3, 7800, 2), (5, 7800, 4),
                (3, 999, 4), (5, 1001, 2), (2, 131072, 4), (8, 999, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("W,L,offset", DECODE_CASES)
@pytest.mark.parametrize("codec", CODECS)
def test_cuda_decode_reduce_matches_plain(cuda, codec, W, L, offset):
    x, _ = _payload((8, W, L), seed=W)
    comp, _ = _fn(codec, "encode_residual")[1](torch.from_numpy(x).to(cuda))
    comp["q"] = _offset_view(comp["q"].cpu().numpy(), offset, cuda)
    kern, plain = _fn(codec, "decode_reduce")
    before = tkern.launches[DECODE_KERNEL[codec]]
    got = kern(comp, L - 5)
    torch.cuda.synchronize()
    assert tkern.launches[DECODE_KERNEL[codec]] == before + 1
    assert _same(got, plain(comp, L - 5))
