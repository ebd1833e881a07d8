"""The sharded train step, ``train_step(..., rules=, grid=)``, against the
reference's ``train_step(..., rules=, mesh=)``.

Reduced qwen3-moe (2 layers, 8 experts top-2, its own capacity factor
1.25 and aux weight) on ``RankGrid(2, 2)`` with ``Rules(batch=("node",),
tp="local")``: both MoE blocks run expert parallel, forward and backward.
Two steps, float32 weights and logits, the weights drawn by numpy
(``torch_family.draw_params``), a batch of 4 x 32 tokens a step.

The reference side — this file's ``__main__``, run once per module in a
subprocess with 4 forced host devices — builds an Auto-typed ``Mesh`` of
``("node", "local")`` over (2, 2) and runs its step jitted at XLA's
lowest backend level under ``jax.set_mesh`` (the Explicit-typed mesh
``jax.make_mesh`` builds fails in this JAX: ROADMAP.md, queue 3). It also
runs reduced yi-34b (a dense config, the reference check's) sharded and
on one device.

Bars (``tests/test_torch_train.py``'s): each step's loss within
``rtol=1e-5``, the weights after the first step within ``2 * lr`` (the
first AdamW step's ``m / sqrt(v)`` may take either sign where a gradient
is about as small as the order of float32 sums), ``m`` and ``v`` within
``1e-4`` of each leaf's largest entry. The dense config's sharded step is
the port's single-device step bit for bit; the reference's sharded loss is
within ``rtol=2e-2`` of its single-device loss (its check's bar).
"""
import sys

import numpy as np
import pytest
import torch

import torch_family as tf
from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.core.grid import RankGrid
from repro_torch.models.decoder import RunFlags
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.sharding.rules import Rules
from repro_torch.train.step import TrainConfig, train_step

MOE, DENSE = "qwen3-moe-235b-a22b", "yi-34b"
GRID = (2, 2)
B, T = 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0,
           weight_decay=0.1)
STEPS = 2


def _batch(step):
    rng = np.random.default_rng(30 + step)
    toks = rng.integers(0, 512, size=(B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import reduced_config as jreduced
    from repro.models import decoder
    from repro.optim import adamw as jadamw
    from repro.sharding.rules import Rules as JRules
    from repro.train import step as jstep

    res = {}
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(GRID), ("node", "local"))
    rules = JRules(batch=("node",), tp="local")
    ocfg = jadamw.AdamWConfig(**OPT)
    tcfg = jstep.TrainConfig(optimizer=ocfg, flags=decoder.RunFlags(
        remat="none", logits_dtype="float32"))
    for arch in (MOE, DENSE):
        cfg = jreduced(arch)
        drawn = tf.draw_params(jax.eval_shape(
            lambda k: decoder.init(k, cfg), jax.random.PRNGKey(0)))
        for path, leaf in tf.flatten(drawn):
            res[f"{arch}/param/{path}"] = np.asarray(leaf, np.float32)
        p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                         drawn)
        o = jax.jit(lambda p_: jadamw.init(p_, ocfg))(p)
        batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
        with jax.set_mesh(mesh):
            step = tf.fast_compile(lambda p_, o_, b_: jstep.train_step(
                p_, o_, b_, cfg, tcfg, rules=rules, mesh=mesh), p, o, batch)
            if arch == DENSE:
                _, _, m = step(p, o, batch)
                res[f"{arch}/sharded/loss"] = np.asarray(m["loss"])
            else:
                for s in range(STEPS):
                    b = {k: jnp.asarray(v) for k, v in _batch(s).items()}
                    p, o, m = step(p, o, b)
                    res[f"{arch}/loss{s}"] = np.asarray(m["loss"])
                    if s == 0:
                        for name, tree in (("param", p), ("m", o["m"]),
                                           ("v", o["v"])):
                            for path, a in tf.flatten(jax.device_get(tree)):
                                res[f"{arch}/step0/{name}/{path}"] = \
                                    np.asarray(a, np.float32)
        if arch == DENSE:
            single = tf.fast_compile(lambda p_, o_, b_: jstep.train_step(
                p_, o_, b_, cfg, tcfg), p, o, batch)
            res[f"{arch}/single/loss"] = np.asarray(single(p, o, batch)[2][
                "loss"])
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tf.reference_npz(__file__, tmp_path_factory, "sharded_train_ref",
                            devices=4)


def _tcfg():
    return TrainConfig(optimizer=adamw.AdamWConfig(**OPT),
                       flags=RunFlags(remat="none", logits_dtype="float32"))


def _model(reference, arch):
    tree = tf.tree({k[len(arch) + 1:]: v for k, v in reference.items()
                    if k.startswith(f"{arch}/param/")}, "float32", ())
    model = interop.params_from_reference(tree, reduced_config(arch),
                                          device="cpu")
    flat = FlatParams.of(model)
    return model, flat, adamw.init(flat, adamw.AdamWConfig(**OPT))


def _torch_batch(step):
    return {k: torch.from_numpy(v).long() for k, v in _batch(step).items()}


def _sharded(**kw):
    return dict(rules=Rules(batch=("node",), tp="local"),
                grid=RankGrid(*GRID, "cpu"), **kw)


@pytest.fixture(scope="module")
def moe_run(reference):
    """Two sharded steps of reduced qwen3-moe: the losses, and the weights,
    ``m`` and ``v`` after the first, leaf by leaf."""
    model, flat, opt = _model(reference, MOE)
    losses, first = [], None
    for s in range(STEPS):
        mets = train_step(model, opt, _torch_batch(s), _tcfg(), flat,
                          **_sharded())
        losses.append(float(mets["loss"]))
        if s == 0:
            first = {name: {p: buf[a:b].clone() for p, a, b, _ in
                            flat.spans}
                     for name, buf in (("param", flat.read()),
                                       ("m", opt["m"]), ("v", opt["v"]))}
    return losses, first, model


def test_moe_blocks_run_expert_parallel(moe_run):
    """The sharded step went through the expert-parallel path: every MoE
    block recorded its routing over the grid's ranks."""
    _, _, model = moe_run
    for blk in model.blocks:
        assert blk.moe.ep_routing["ids"].shape[0] == GRID[0] * GRID[1]


@pytest.mark.parametrize("step", range(STEPS))
def test_sharded_losses_match_reference(reference, moe_run, step):
    losses, _, _ = moe_run
    np.testing.assert_allclose(losses[step], reference[f"{MOE}/loss{step}"],
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["param", "m", "v"])
def test_sharded_state_after_one_step_matches_reference(reference, moe_run,
                                                        name):
    _, first, _ = moe_run
    prefix = f"{MOE}/step0/{name}/"
    want = {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}
    assert set(want) == set(first[name])
    for path, w in want.items():
        got = first[name][path].reshape(w.shape)
        if name == "param":
            err = float(np.abs(got.numpy() - w).max())
            assert err <= 2 * OPT["lr"], f"{path}: {err}"
        else:
            tf.relative(got, w, 1e-4, f"{name} {path}")


def test_dense_sharded_step_is_the_single_device_step(reference):
    """Dense blocks ignore the grid: the sharded step's loss, weights and
    AdamW state are the single-device step's, bit for bit. The
    reference's own sharded loss is within its check's bar of its
    single-device loss, and the port's within ``rtol=1e-5`` of both."""
    runs = []
    for kw in ({}, _sharded()):
        model, flat, opt = _model(reference, DENSE)
        mets = train_step(model, opt, _torch_batch(0), _tcfg(), flat, **kw)
        runs.append((mets["loss"], flat.read(), opt["m"], opt["v"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    single = reference[f"{DENSE}/single/loss"]
    sharded = reference[f"{DENSE}/sharded/loss"]
    np.testing.assert_allclose(sharded, single, rtol=2e-2)
    np.testing.assert_allclose(float(runs[0][0]), single, rtol=1e-5)
    np.testing.assert_allclose(float(runs[0][0]), sharded, rtol=1e-5)


if __name__ == "__main__":
    _reference(sys.argv[1])
