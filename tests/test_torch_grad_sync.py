"""The port's bucketed DP gradient sync against the reference's, on a
reduced smollm config (2 layers, width 128, vocab 512).

The reference side (``OverlappedGradSync`` over 8 forced host devices)
runs once per module in a subprocess — this file's ``__main__`` block —
and writes an ``.npz``. Both sides draw the same numpy gradients from the
reference's parameter tree; the port receives them through
``interop.from_reference``. Three steps of int8 sync with error feedback,
and two of int4, agree bitwise in output and in error state (both packages
add ranks in the same order, and the port's codecs copy XLA's rounding and
the reference kernels' decode-reduce); the tests also state the codec's
own bound, ``collective_tolerance(codec, "allreduce", 8, A)`` with ``A``
the step's input max-abs.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs.smollm_360m import CONFIG
from repro_torch.core import compress
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid
from repro_torch.models import params
from repro_torch.train import manual_step as ms

WORLD = 8
STEPS = 3
BUCKET_BYTES = 64 << 10  # 16384 elements: 27 buckets, a ragged last one
METRIC_LEN = 3
CODEC = "int8_block"
EPS = 0.5 / 127
#: the second codec synced against the reference, with its own bound
INT4, INT4_EPS, INT4_STEPS = "int4_block", 0.5 / 7, 2


def _reduced():
    import dataclasses
    return dataclasses.replace(CONFIG, n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, head_dim=32, d_ff=256,
                               vocab=512)


def _shape_tree():
    """The reference decoder's parameter shapes (jax.eval_shape of init)."""
    import jax
    from repro.configs import reduced_config
    from repro.models import decoder
    cfg = reduced_config("smollm-360m")
    return jax.eval_shape(lambda k: decoder.init(k, cfg),
                          jax.random.PRNGKey(0))


def _grad_tree(shape_tree, step: int):
    """Per-rank numpy gradients ``(WORLD, *shape)`` for every leaf."""
    import jax
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(
        lambda s: (rng.standard_normal((WORLD,) + tuple(s.shape))
                   * 0.01).astype(np.float32), shape_tree)


def _mvec():
    return np.arange(WORLD * METRIC_LEN, dtype=np.float32).reshape(
        WORLD, METRIC_LEN)


def _reference(out_path: str) -> None:
    import jax
    from repro.core.comm import Communicator as JComm
    from repro.train.manual_step import OverlappedGradSync, bucket_slices

    comm = JComm(jax.make_mesh((2, 4), ("node", "local")))
    shapes = _shape_tree()
    total = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(shapes))
    slices = bucket_slices(total, BUCKET_BYTES // 4)
    res = {}
    for codec, eps, steps, tag in ((CODEC, EPS, STEPS, ""),
                                   (INT4, INT4_EPS, INT4_STEPS, "int4_")):
        gs = OverlappedGradSync(comm, slices, METRIC_LEN, algo="pip_mcoll",
                                codec=codec, error_budget=eps)
        for step in range(steps):
            gs.ensure_ops(step)
            tree = _grad_tree(shapes, step)
            flat = np.concatenate([l.reshape(WORLD, -1)
                                   for l in jax.tree.leaves(tree)], axis=1)
            synced, mv = gs.sync([flat[:, s:s + n] for s, n in slices],
                                 _mvec())
            res[f"{tag}out{step}"] = np.concatenate(
                [np.asarray(y) for y in synced], 1)
            res[f"{tag}err{step}"] = np.concatenate(
                [np.asarray(e) for e in gs.errs], 1)
            res[f"{tag}metric{step}"] = np.asarray(mv)
        res[f"{tag}plans"] = np.array(gs.plans())
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("grad_sync_ref") / "ref.npz"
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


@pytest.fixture
def comm():
    return Communicator(RankGrid(2, 4, device="cpu"))


def _slices():
    return ms.bucket_slices(params.n_params(_reduced()), BUCKET_BYTES // 4)


def test_param_shapes_follow_reference_flatten_order():
    jax = pytest.importorskip("jax")
    flat, _ = jax.tree_util.tree_flatten_with_path(_shape_tree())
    want = [("/".join(str(k.key) for k in path), tuple(leaf.shape))
            for path, leaf in flat]
    assert params.param_shapes(_reduced()) == want
    full = params.param_shapes(CONFIG)
    assert params.n_params(CONFIG) == CONFIG.n_params() == 409_007_040
    assert full[0] == ("embed", (49152, 960))
    assert len(ms.bucket_slices(CONFIG.n_params(),
                                ms.DEFAULT_BUCKET_BYTES // 4)) == 391


def test_interop_flat_buffer_and_leaf_views():
    pytest.importorskip("jax")
    tree = _grad_tree(_shape_tree(), 0)
    flat = interop.from_reference(tree, device="cpu")
    shapes = params.param_shapes(_reduced())
    views = params.leaf_views(flat, shapes)
    for path, arr in interop.flatten_reference(tree):
        np.testing.assert_array_equal(views[path].numpy(), arr)
        assert views[path].data_ptr() >= flat.data_ptr()  # a view, no copy
    one = interop.from_reference({"b": np.ones((2, 3)), "a": np.zeros(4)},
                                 device="cpu", ranked=False)
    np.testing.assert_array_equal(one.numpy(), [[0] * 4 + [1] * 6])


def _port_run(comm, steps, errs_from=None, codec=CODEC, eps=EPS):
    shapes = _shape_tree()
    gs = ms.OverlappedGradSync(comm, _slices(), METRIC_LEN,
                               algo="pip_mcoll", codec=codec,
                               error_budget=eps)
    outs = []
    for step in steps:
        gs.ensure_ops(step)
        if errs_from is not None and step == steps[0]:
            gs.errs = list(interop.error_state_from_reference(
                np.split(errs_from, np.cumsum([n for _, n in _slices()])[:-1],
                         axis=1), device="cpu"))
        flat = interop.from_reference(_grad_tree(shapes, step), device="cpu")
        before = torch.cat(gs.errs, dim=1).clone()
        synced, mv = gs.sync([flat[:, s:s + n] for s, n in _slices()],
                             torch.from_numpy(_mvec()))
        amax = float((flat + before).abs().max())
        outs.append((torch.cat(synced, 1).numpy(),
                     torch.cat(gs.errs, 1).numpy(), mv.numpy(), amax,
                     (flat.double() + before).sum(0).numpy()))
    return gs, outs


def test_compressed_sync_with_error_feedback_matches_reference(reference,
                                                               comm):
    gs, outs = _port_run(comm, list(range(STEPS)))
    assert gs.plans() == list(reference["plans"])
    assert all(p == "pip_mcoll@int8_block" for p in gs.plans())
    for step, (out, err, mv, amax, _) in enumerate(outs):
        tol = compress.collective_tolerance(CODEC, "allreduce", WORLD, amax)
        assert np.abs(out - reference[f"out{step}"]).max() <= tol
        assert np.abs(err - reference[f"err{step}"]).max() <= tol
        np.testing.assert_array_equal(out, reference[f"out{step}"])
        np.testing.assert_array_equal(err, reference[f"err{step}"])
        np.testing.assert_array_equal(mv, reference[f"metric{step}"])
        assert err.any()


def test_int4_sync_with_error_feedback_matches_reference(reference, comm):
    """The same sync under int4_block: its lowering decode-reduces as the
    reference's Pallas kernel does, so output and error state are
    bitwise."""
    gs, outs = _port_run(comm, list(range(INT4_STEPS)), codec=INT4,
                         eps=INT4_EPS)
    assert gs.plans() == list(reference["int4_plans"])
    assert all(p == "pip_mcoll@int4_block" for p in gs.plans())
    for step, (out, err, mv, amax, exact) in enumerate(outs):
        tol = compress.collective_tolerance(INT4, "allreduce", WORLD, amax)
        np.testing.assert_array_equal(out, reference[f"int4_out{step}"])
        np.testing.assert_array_equal(err, reference[f"int4_err{step}"])
        np.testing.assert_array_equal(mv, reference[f"int4_metric{step}"])
        assert np.abs(out - exact).max() <= tol
        assert err.any()


def test_error_state_from_reference_resumes_the_reference(reference, comm):
    """The reference's step-0 error state, carried across, reproduces the
    reference's step 1."""
    _, outs = _port_run(comm, [1], errs_from=reference["err0"])
    out, err, _, amax, _ = outs[0]
    tol = compress.collective_tolerance(CODEC, "allreduce", WORLD, amax)
    assert np.abs(out - reference["out1"]).max() <= tol
    assert np.abs(err - reference["err1"]).max() <= tol
    np.testing.assert_array_equal(out, reference["out1"])


@pytest.mark.parametrize("algo", ["pip_mcoll", "pip_pipeline",
                                  "recursive_doubling", "xla"])
def test_bucketed_equals_per_tensor_lossless(comm, algo):
    pytest.importorskip("jax")
    tree = _grad_tree(_shape_tree(), 0)
    flat = interop.from_reference(tree, device="cpu")
    sync = ms._make_grad_sync(comm, algo, None, None, 0.0)
    bucketed, state = ms.sync_tree_bucketed(flat, sync, BUCKET_BYTES)
    assert state == ()
    shapes = params.param_shapes(_reduced())
    got = params.leaf_views(bucketed, shapes)
    for path, view in params.leaf_views(flat, shapes).items():
        per_tensor, _ = sync(view.reshape(WORLD, -1), None)
        assert torch.equal(got[path].reshape(WORLD, -1), per_tensor), path
    mean = flat.double().mean(0)
    assert float((bucketed[3].double() - mean).abs().max()) < 1e-6


def test_bucketed_compressed_threads_error_state(comm):
    n = params.n_params(_reduced())
    state = ms.init_error_state(n, comm, EPS, BUCKET_BYTES)
    assert len(state) == len(_slices())
    assert state[1].data_ptr() == state[0].data_ptr() + 4 * state[0].shape[1]
    flat = torch.randn((WORLD, n), generator=torch.Generator().manual_seed(1))
    sync = ms._make_grad_sync(comm, "pip_mcoll", None, CODEC, EPS)
    out, new = ms.sync_tree_bucketed(flat, sync, BUCKET_BYTES, state)
    assert len(new) == len(state) and any(bool(e.any()) for e in new)
    tol = compress.collective_tolerance(CODEC, "allreduce", WORLD,
                                        float(flat.abs().max())) / WORLD
    assert float((out.double() - flat.double().mean(0)).abs().max()) <= tol
    assert ms.init_error_state(n, comm, 0.0) == ()


def test_communicator_misuse_raises(comm):
    x = torch.ones(WORLD, 16)
    op = comm.allreduce_init(x, algo="pip_mcoll")
    h = op.start(x)
    with pytest.raises(RuntimeError, match="outstanding"):
        op.start(x)
    np.testing.assert_array_equal(h.wait().numpy(), np.full((WORLD, 16), 8.0))
    with pytest.raises(RuntimeError, match="double wait"):
        h.wait()
    with pytest.raises(ValueError, match="built for"):
        op.start(torch.ones(WORLD, 17))
    with pytest.raises(ValueError, match="built for"):
        op.start(torch.ones(WORLD, 16, dtype=torch.float64))
    with pytest.raises(ValueError, match="carry"):
        op.start(x, carry=x)
    op2 = comm.allreduce_init(x, algo="pip_mcoll", depth=2)
    h1, h2 = op2.start(x), op2.start(2 * x)
    assert h1.wait(block=False) is not h2.wait()
    op.release()
    with pytest.raises(RuntimeError, match="released"):
        op.start(x)
    with pytest.raises(ValueError, match="does not support chunking"):
        comm.allreduce(x, algo="xla", chunks=2)
    with pytest.raises(ValueError, match="not admissible"):
        comm.allreduce(torch.ones(WORLD, 4, dtype=torch.int32),
                       algo="pip_mcoll", codec=CODEC)
    with pytest.raises(KeyError):  # as the reference's selector raises
        comm.plan("barrier", 1024)


def test_release_frees_ops_and_error_state(comm):
    from repro_torch.core.comm import live_persistent_ops
    base = live_persistent_ops()
    gs = ms.OverlappedGradSync(comm, _slices(), METRIC_LEN,
                               algo="pip_mcoll", codec=INT4,
                               error_budget=INT4_EPS)
    gs.ensure_ops(0)
    assert live_persistent_ops() == base + len(_slices()) + 1
    assert all(e is not None for e in gs.errs)
    gs.release()
    assert live_persistent_ops() == base and gs.errs == []
    gs.ensure_ops(1)  # builds anew after a release
    assert live_persistent_ops() == base + len(_slices()) + 1
    assert gs.plans()[0] == "pip_mcoll@int4_block"
    gs.release()


def test_plan_spec_normalization_shares_cache_entries(comm):
    from repro_torch.core import runtime
    x = torch.ones(WORLD, 64)
    runtime.clear_cache()
    comm.allreduce(x, algo="pip_pipeline")
    comm.allreduce(x, algo="pip_pipeline", chunks=1)
    comm.allreduce(x, algo="pip_pipeline", chunks=None, codec="none")
    stats = comm.cache_stats()
    assert (stats.exec_misses, stats.exec_hits) == (1, 2)
    # the free runtime entry resolves "auto" through the same selector
    y = runtime.run(comm.grid, comm.topo, "allreduce", "auto", x)
    assert torch.equal(y, comm.allreduce(x))
    with pytest.raises(ValueError, match="move it explicitly"):
        runtime.run(comm.grid, comm.topo, "allreduce", "xla",
                    torch.ones(WORLD, 4, device="meta"))


if __name__ == "__main__":
    _reference(sys.argv[1])
