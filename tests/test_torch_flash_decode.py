"""The port's flash-decode kernel against the reference's Pallas kernel.

On the CPU the wrapper ``repro_torch.kernels.attention.flash_decode`` runs
its plain version (``kernels/ref.py``); the reference side — this file's
``__main__``, run once per module in a subprocess — calls
``repro.kernels.flash_decode.flash_decode(..., interpret=True)`` on the
same numpy inputs and writes an ``.npz``. Both upcast bf16 operands to
fp32 and keep the probabilities in fp32, so bf16 and f32 share one
tolerance: ``TOL`` relative and absolute, for the order of the fp32 sums
(the Pallas body rescales chunk by chunk, the plain version takes one
softmax). A ``(B,)`` length vector is held against per-row scalar calls
of the reference kernel. The split-S algorithm of the CUDA kernel, in
plain PyTorch (``ref.flash_decode_split``), is held against the same
Pallas kernel and the one-softmax plain version at S 1000 and 2048, for
every length class the splits make (0, 1, S, each split boundary +-1,
per-row vectors). The ``cuda``-marked tests hold the CUDA kernel against
its plain version on the card and skip where there is no card.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention as kattn
from repro_torch.kernels import ref

#: the reference's flash-decode test grid (tests/test_kernels.py)
GRID = [(1, 64, 4, 2, 16), (2, 128, 8, 8, 32), (3, 256, 6, 2, 64),
        (2, 512, 16, 4, 8)]
#: groups past the kernel's 8 heads a CTA: G 9 (3 groups of 3), 11 (11 of
#: 1), 12 (2 of 6) and 16 (2 of 8: qwen3-moe's group, at its head dim 64)
WIDE_GROUPS = [(2, 128, 18, 2, 16), (1, 128, 22, 2, 32),
               (1, 256, 24, 2, 32), (2, 128, 64, 4, 64)]
DTYPES = ("float32", "bfloat16")
CHUNK = 64
#: plain version against the Pallas body, both in fp32: sum order only
TOL = 2e-5
#: the CUDA kernel against the plain version on the card (fp32 sums in
#: another order; measured on the card by chip_smoke.py)
CUDA_TOL = 2e-5


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _lengths(B, S, seed):
    """Per-row lengths: one full row, one of 1, the rest drawn."""
    rng = np.random.default_rng(seed + 7)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    lens[0] = S
    if B > 1:
        lens[1] = 1
    return lens


def _curs(S):
    return (0, 1, S // 3, S)


#: (B, S, H, KV, hd) of the split-S checks: no chunk divides 1000; the
#: splits per row, 40 giving spans shorter than one 64-row tile
SPLIT_SHAPES = [(3, 1000, 6, 2, 16), (2, 2048, 8, 2, 32)]
SPLITS = (1, 2, 7, 40)
#: Pallas chunk per S (the reference kernel wants S % chunk == 0)
SPLIT_CHUNK = {1000: 200, 2048: 512}


def _split_lengths(S):
    """Scalar lengths: 0, 1, S, and both sides of the first and the last
    split boundary of each of ``SPLITS`` (span = ceil(S / n_split))."""
    lens = {0, 1, S}
    for n in SPLITS:
        span = -(-S // n)
        for edge in {span, (S - 1) // span * span}:
            lens.update((edge - 1, edge, edge + 1))
    return sorted(lens)


def _split_rows(B, S):
    """A (B,) vector of per-row lengths: 0, a boundary + 1, S."""
    return np.array([0, -(-S // 7) + 1, S][:B], np.int32)


def _reference(out_path: str) -> None:
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode

    res = {}
    for B, S, H, KV, hd in GRID + WIDE_GROUPS:
        q, k, v = _inputs(B, S, H, KV, hd, B * S + hd)
        for dt in DTYPES:
            jq, jk, jv = (jnp.asarray(a, getattr(jnp, dt)) for a in (q, k, v))
            tag = f"{B}_{S}_{H}_{KV}_{hd}_{dt}"
            for cur in _curs(S):
                res[f"{tag}_cur{cur}"] = np.asarray(flash_decode(
                    jq, jk, jv, jnp.int32(cur), chunk=CHUNK, interpret=True))
            lens = _lengths(B, S, B * S + hd)
            res[f"{tag}_rows"] = np.concatenate([np.asarray(flash_decode(
                jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], jnp.int32(lens[b]),
                chunk=CHUNK, interpret=True)) for b in range(B)])
    for B, S, H, KV, hd in SPLIT_SHAPES:
        q, k, v = _inputs(B, S, H, KV, hd, B * S + hd)
        for dt in DTYPES:
            jq, jk, jv = (jnp.asarray(a, getattr(jnp, dt)) for a in (q, k, v))
            tag = f"split_{B}_{S}_{H}_{KV}_{hd}_{dt}"
            for cur in _split_lengths(S):
                res[f"{tag}_cur{cur}"] = np.asarray(flash_decode(
                    jq, jk, jv, jnp.int32(cur), chunk=SPLIT_CHUNK[S],
                    interpret=True))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("flash_decode_ref") / "ref.npz"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def _torch(arrays, dtype, device="cpu"):
    return tuple(torch.from_numpy(a).to(device=device,
                                        dtype=getattr(torch, dtype))
                 for a in arrays)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd", GRID + WIDE_GROUPS)
def test_plain_matches_pallas(reference, B, S, H, KV, hd, dtype):
    """Scalar lengths 0 (every position masked), 1, S/3 and S."""
    q, k, v = _torch(_inputs(B, S, H, KV, hd, B * S + hd), dtype)
    tag = f"{B}_{S}_{H}_{KV}_{hd}_{dtype}"
    for cur in _curs(S):
        got = kattn.flash_decode(q, k, v, cur)
        assert got.shape == (B, 1, H * hd) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), reference[f"{tag}_cur{cur}"],
                                   rtol=TOL, atol=TOL, err_msg=f"cur={cur}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd", GRID + WIDE_GROUPS)
def test_vector_lengths_match_per_row_pallas(reference, B, S, H, KV, hd,
                                             dtype):
    q, k, v = _torch(_inputs(B, S, H, KV, hd, B * S + hd), dtype)
    lens = torch.from_numpy(_lengths(B, S, B * S + hd))
    got = kattn.flash_decode(q, k, v, lens)
    np.testing.assert_allclose(
        got.numpy(), reference[f"{B}_{S}_{H}_{KV}_{hd}_{dtype}_rows"],
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [1, 100, 1000])
def test_plain_any_length_matches_float64(S):
    """No chunk divides S: the plain version against a float64 softmax."""
    B, H, KV, hd = 3, 6, 2, 16
    q, k, v = _inputs(B, S, H, KV, hd, S)
    lens = np.array([S, 1, max(1, S // 2)], np.int32)
    got = kattn.flash_decode(*_torch((q, k, v), "float32"),
                             torch.from_numpy(lens))
    qg = q.reshape(B, KV, H // KV, hd).astype(np.float64)
    s = np.einsum("bkgd,bskd->bkgs", qg, k.astype(np.float64)) / hd ** 0.5
    s = np.where(np.arange(S)[None, None, None, :]
                 < lens[:, None, None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bkgs,bskd->bkgd", p, v.astype(np.float64))
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd", SPLIT_SHAPES)
def test_split_plain_matches_pallas(reference, B, S, H, KV, hd, dtype,
                                    n_split):
    """The split-S partials and their combine against the Pallas kernel
    and the one-softmax plain version: lengths 0 (every split scores
    NEG_INF, equal weights), 1, S, each boundary +-1 (splits wholly past
    the length add nothing), and per-row (B,) lengths."""
    q, k, v = _torch(_inputs(B, S, H, KV, hd, B * S + hd), dtype)
    tag = f"split_{B}_{S}_{H}_{KV}_{hd}_{dtype}"
    for cur in _split_lengths(S):
        got = ref.flash_decode_split(q, k, v, cur, n_split)
        assert got.shape == (B, 1, H * hd) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), reference[f"{tag}_cur{cur}"],
                                   rtol=TOL, atol=TOL, err_msg=f"cur={cur}")
        torch.testing.assert_close(got, ref.flash_decode(q, k, v, cur),
                                   rtol=TOL, atol=TOL)
    lens = _split_rows(B, S)
    got = ref.flash_decode_split(q, k, v, torch.from_numpy(lens), n_split)
    want = np.concatenate([reference[f"{tag}_cur{n}"][b:b + 1]
                           for b, n in enumerate(lens)])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_split_count_fills_the_card_at_the_serving_shapes():
    """Two CTAs per SM or more at smollm's and jamba's decode shapes on
    132 SMs, no span under one tile, and the most splits at B 1."""
    for B, KV, hd in ((8, 5, 64), (8, 8, 128)):
        n = kattn.split_count(B, KV, 2048, hd, 2, 132)
        assert B * KV * n >= 2 * 132
        assert -(-2048 // n) >= kattn.tile_rows(hd, 2)
    assert kattn.split_count(1, 5, 2048, 64, 2, 132) == 2048 // 64
    assert kattn.split_count(8, 5, 40, 64, 2, 132) == 1
    # qwen3-moe's G 16: two head groups of 8 a (b, kv) pair, counted;
    # groups are equal, of at most 8 heads
    assert [kattn.head_groups(g) for g in (1, 8, 9, 11, 12, 16, 17, 24)] \
        == [1, 1, 3, 11, 2, 2, 17, 3]
    n = kattn.split_count(8, 4, 2048, 64, 2, 132, G=16)
    assert 8 * 4 * 2 * n >= 2 * 132 > 8 * 4 * 2 * (n - 1)
    assert n == kattn.split_count(8, 8, 2048, 64, 2, 132, G=8)
    assert [kattn.tile_rows(hd, e) for hd, e in ((64, 2), (128, 2), (128, 4),
                                                (20, 4), (8, 2))] \
        == [64, 32, 16, 96, 128]


def test_cpu_path_counts_no_launch():
    kattn.reset_launches()
    q, k, v = _torch(_inputs(2, 64, 4, 2, 16, 0), "bfloat16")
    kattn.flash_decode(q, k, v, torch.tensor([3, 64]))
    kattn.flash_decode(q, k, v, 5)
    assert kattn.launches == {"flash_decode": 0}


def test_dispatch_refuses_other_devices_and_shapes():
    q, k, v = _torch(_inputs(2, 64, 4, 2, 16, 0), "float32")
    with pytest.raises(ValueError, match="no kernel for device"):
        kattn.flash_decode(q.to("meta"), k.to("meta"), v.to("meta"), 3)
    with pytest.raises(ValueError, match="several devices"):
        kattn.flash_decode(q, k.to("meta"), v, 3)
    with pytest.raises(ValueError, match="several devices"):
        kattn.flash_decode(q, k, v, torch.tensor([3, 4], device="meta"))
    with pytest.raises(ValueError, match="neither a scalar"):
        kattn.flash_decode(q, k, v, torch.tensor([3, 4, 5]))
    with pytest.raises(TypeError, match="integer"):
        kattn.flash_decode(q, k, v, torch.tensor([3.0, 4.0]))
    with pytest.raises(ValueError, match="takes q"):
        kattn.flash_decode(q.expand(2, 2, 4, 16), k, v, 3)
    with pytest.raises(ValueError, match="takes q"):
        kattn.flash_decode(q[:, :, :3], k, v, 3)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


#: full width (smollm-360m serving: B=max_batch, S=max_len), jamba's (G 8,
#: hd 128), qwen3-moe's (G 16, hd 64), one row (the most splits), the
#: reduced config (G 2, hd 32) at an S no chunk divides, the reference's
#: grid and the groups past 8 heads; seamless's self-attention (G 1, hd
#: 64), qwen1.5's (G 1, hd 128) and phi3's (G 4, hd 128)
CUDA_SHAPES = [(8, 2048, 15, 5, 64), (8, 2048, 64, 8, 128),
               (8, 2048, 64, 4, 64), (1, 2048, 15, 5, 64),
               (8, 1000, 4, 2, 32)] + GRID + WIDE_GROUPS + [
                   (8, 2048, 16, 16, 64), (8, 2048, 20, 20, 128),
                   (8, 2048, 40, 10, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd", CUDA_SHAPES)
def test_cuda_kernel_matches_plain(cuda, B, S, H, KV, hd, dtype):
    """Mixed, scalar, all-masked (0 and negative) and past-the-end lengths,
    and every split boundary +-1 of the kernel's own split count; the
    combine tickets are back at zero after each call."""
    q, k, v = _torch(_inputs(B, S, H, KV, hd, B + S), dtype, cuda)
    lens = torch.from_numpy(_lengths(B, S, S)).to(cuda)
    n = kattn.split_count(B, KV, S, hd, q.element_size(),
                          torch.cuda.get_device_properties(
                              cuda).multi_processor_count, H // KV)
    span = -(-S // n)
    edges = [e + d for e in range(span, S, span) for d in (-1, 0, 1)]
    for lengths in (lens, 1, S, S // 3, 0, -3, S + 5, lens.to(torch.int64),
                    *edges):
        before = kattn.launches["flash_decode"]
        got = kattn.flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
        assert kattn.launches["flash_decode"] == before + 1
        want = ref.flash_decode(q, k, v, lengths)
        torch.testing.assert_close(got, want, rtol=CUDA_TOL, atol=CUDA_TOL)
    assert not any(bool(t.any()) for t in kattn._tickets.values())


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _torch(_inputs(1, 64, 4, 2, 136, 0), "float32", cuda)
    with pytest.raises(ValueError, match="hd <= 128"):
        kattn.flash_decode(q, k, v, 3)
    q, k, v = _torch(_inputs(1, 64, 4, 2, 6, 0), "bfloat16", cuda)
    with pytest.raises(ValueError, match="16-byte rows"):
        kattn.flash_decode(q, k, v, 3)
    q, k, v = _torch(_inputs(1, 64, 4, 2, 16, 0), "float16", cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        kattn.flash_decode(q, k, v, 3)
    q, k, v = _torch(_inputs(1, 64, 4, 2, 16, 0), "float32", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kattn.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                           v, 3)


if __name__ == "__main__":
    _reference(sys.argv[1])
