"""The port's codec registry against the reference's jitted jnp codecs.

Same numpy inputs on both sides. Wire forms match bitwise (``topk`` on
tie-free payloads: ``torch.topk`` and ``lax.top_k`` may order equal
magnitudes differently); residuals of ``encode_residual`` and
``encode_with_feedback`` match bitwise too, because the port rounds
``c - q*scale`` once, as XLA's fused multiply-add does; so does the fused
codecs' ``decode_reduce``. ``admissible``,
``for_budget``, ``collective_tolerance`` and the metadata agree.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.core import compress as tc

jax = pytest.importorskip("jax")
from repro.core import compress as jc  # noqa: E402

FLOAT_CODECS = ("none", "int8_block", "int4_block", "fp8_sim", "topk")
SHAPES = [(1, 256), (3, 1000), (4, 64), (2, 2048)]


def _payload(S, L, seed):
    rng = np.random.default_rng(seed)
    mag = rng.uniform(0.01, 100.0, (S, 1))
    # tie-free magnitudes: a permutation of distinct values, random signs
    x = (rng.permutation(S * L).reshape(S, L) + 1.0) / (S * L)
    x = x * rng.choice([-1.0, 1.0], (S, L)) * mag
    err = rng.standard_normal((S, L)) * 0.01 * mag
    return x.astype(np.float32), err.astype(np.float32)


def _assert_comp(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if got[k].dtype != torch.uint16 \
            else got[k].to(torch.int32).numpy()
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("S,L", SHAPES)
@pytest.mark.parametrize("name", FLOAT_CODECS)
def test_encode_decode_match_jitted_reference(name, S, L):
    x, _ = _payload(S, L, seed=S * 7 + L)
    want = jax.jit(jc.codec(name).encode)(x)
    got = tc.codec(name).encode(torch.from_numpy(x))
    _assert_comp(got, want)
    dec_want = jax.jit(lambda c: jc.codec(name).decode(c, L))(want)
    np.testing.assert_array_equal(tc.codec(name).decode(got, L).numpy(),
                                  np.asarray(dec_want))


@pytest.mark.parametrize("S,L", SHAPES)
@pytest.mark.parametrize("name", FLOAT_CODECS)
def test_encode_residual_matches_jitted_reference(name, S, L):
    x, _ = _payload(S, L, seed=S + L)
    with jc.jnp_reference_paths():
        comp_w, res_w = jax.jit(jc.codec(name).encode_residual)(x)
    comp_g, res_g = tc.codec(name).encode_residual(torch.from_numpy(x))
    _assert_comp(comp_g, comp_w)
    np.testing.assert_array_equal(res_g.numpy(), np.asarray(res_w))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", FLOAT_CODECS)
def test_encode_with_feedback_matches_jitted_reference(name, fused):
    x, err = _payload(3, 1000, seed=5)
    with jc.jnp_reference_paths():
        comp_w, res_w = jax.jit(jc.codec(name).encode_with_feedback)(x, err)
    prev = tc.set_fused(fused)
    try:
        comp_g, res_g = tc.codec(name).encode_with_feedback(
            torch.from_numpy(x), torch.from_numpy(err))
    finally:
        tc.set_fused(prev)
    _assert_comp(comp_g, comp_w)
    np.testing.assert_array_equal(res_g.numpy(), np.asarray(res_w))


@pytest.mark.parametrize("name", FLOAT_CODECS)
def test_decode_reduce_matches_reference(name):
    W, L = 4, 777
    x, _ = _payload(W, L, seed=W)
    comp = jc.codec(name).encode(x)
    want = np.asarray(jc.codec(name).decode_reduce(comp, L))
    tcomp = {k: torch.from_numpy(np.array(v)) for k, v in comp.items()}
    got = tc.codec(name).decode_reduce(tcomp, L)
    if tc.meta(name).fused:
        # both sides run their fused decode-reduce: peer by peer from 0,
        # one rounding per multiply-add
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        # decode, then a sum whose order each framework picks
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-5 * W)
    # a leading rank dim reduces each rank's peers on its own
    batched = tc.codec(name).decode_reduce(
        {k: torch.stack([v, v]) for k, v in tcomp.items()}, L)
    np.testing.assert_array_equal(batched[1].numpy(), got.numpy())


def test_zlib_sim_matches_reference():
    rng = np.random.default_rng(3)
    v = rng.integers(1000, 50000, (3, 500)).astype(np.int32)
    want = jax.jit(jc.codec("zlib_sim").encode)(v)
    got = tc.codec("zlib_sim").encode(torch.from_numpy(v))
    _assert_comp(got, want)
    np.testing.assert_array_equal(
        tc.codec("zlib_sim").decode(got, 500).numpy(), v)
    assert tc.codec("zlib_sim").wire_bytes(got) == \
        jc.codec("zlib_sim").wire_bytes(want)
    assert asdict(tc.meta("zlib_sim")) == asdict(jc.meta("zlib_sim"))


def test_registry_and_meta_agree():
    assert tc.codecs() == jc.codecs()
    assert tc.lossy() == jc.lossy()
    assert tc.fused_codecs() == jc.fused_codecs()
    for n in tc.codecs():
        assert asdict(tc.meta(n)) == asdict(jc.meta(n)), n
        assert tc.effective_flops_per_elem(n) == jc.effective_flops_per_elem(n)
    with tc.reference_paths(), jc.jnp_reference_paths():
        for n in tc.codecs():
            assert tc.effective_flops_per_elem(n) == \
                jc.effective_flops_per_elem(n)
    assert tc.fused_enabled()


@pytest.mark.parametrize("budget", [0.0, 0.5 / 127, 0.5 / 7, 2.0 ** -4,
                                    0.1, 1.0])
def test_admissible_for_budget_tolerance_agree(budget):
    for coll in (None, "allreduce", "reduce_scatter", "allgather",
                 "alltoall", "broadcast", "scatter"):
        for integer in (False, True):
            assert tc.for_budget(budget, coll, integer) == \
                jc.for_budget(budget, coll, integer)
            for n in tc.codecs():
                assert tc.admissible(n, coll, budget, integer) == \
                    jc.admissible(n, coll, budget, integer)
    for n in tc.codecs():
        for coll in ("allreduce", "reduce_scatter", "allgather", "scatter"):
            assert tc.collective_tolerance(n, coll, 8, 3.5) == \
                jc.collective_tolerance(n, coll, 8, 3.5)
    with pytest.raises(ValueError):
        tc.collective_tolerance("int8_block", "barrier", 8, 1.0)
    with pytest.raises(ValueError):
        tc.codec("nope")
