"""The expert-parallel MoE's backward against the reference's ``jax.grad``
through its ``shard_map`` (``moe.apply`` with ``rules`` and a mesh), on
the reduced qwen3-moe config (8 experts top-2 of d_ff 64, d_model 128),
float32 weights and tokens ``(2 * dp, 8, 128)`` from one numpy seed.

The reference side — this file's ``__main__``, run once per module in a
subprocess with 8 forced host devices — builds an Auto-typed
``Mesh(devices[:dp * tp], ("node", "local"))`` for each layout, enters it
with ``jax.set_mesh`` and takes, jitted at XLA's lowest backend level,
the gradients of ``sum(y * r)`` (``r`` seeded) with respect to the
router, the three expert weights and ``x``, and of ``aux.mean()`` (the
value its decoder reads) with respect to the router and ``x``. The port
takes ``torch.autograd.grad`` of the same through ``MoE.forward(x,
rules=Rules(batch=("node",), tp="local"), grid=RankGrid(dp, tp, "cpu"))``.

Capacities: ``capacity_factor`` 8 (no routing drops at any of these TP
sizes) and the default 1.25 (routings drop). The aux's gradient is the
reference's: the mean over every rank's routing slice, while its value is
TP rank 0's (``layers/moe.py``).

Tolerances, each leaf against its own largest ``|g|``: ``REF_TOL``
against the reference (float32 sums in another order: the routed rows
are summed per expert group, then over the TP group's reduce-scatter;
7.6e-7 at most measured), ``LOCAL_TOL`` against the port's own
single-device path.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import torch_family as tf
from repro_torch.configs import reduced_config
from repro_torch.core import autotune
from repro_torch.core import comm as tcomm
from repro_torch.core import mcoll
from repro_torch.core.grid import RankGrid
from repro_torch.layers import moe as tmoe
from repro_torch.sharding.rules import Rules

ARCH = "qwen3-moe-235b-a22b"
#: (dp, tp): the batch over "node", the experts over "local"
LAYOUTS = [(1, 2), (2, 2), (1, 4), (2, 4)]
#: name -> capacity factor
CAPS = {"nodrop": 8.0, "default": 1.25}
S, D = 8, 128
LEAVES = ("router", "w_gate", "w_up", "w_down", "x")
REF_TOL = 1e-5
LOCAL_TOL = 1e-5


def _cfg(cap):
    cfg = reduced_config(ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPS[cap]))


def _inputs(dp):
    """Weights ``{name: array}``, tokens and the output weighting ``r``,
    float32 from numpy seed 5 (the weights the same for every layout)."""
    moe = reduced_config(ARCH).moe
    E, F = moe.n_experts, moe.d_ff_expert
    rng = np.random.default_rng(5)
    f = lambda shape, scale: (rng.standard_normal(shape) * scale).astype(
        np.float32)
    p = {"router": f((D, E), D ** -0.5), "w_gate": f((E, D, F), D ** -0.5),
         "w_up": f((E, D, F), D ** -0.5), "w_down": f((E, F, D), F ** -0.5)}
    rng = np.random.default_rng(6 + dp)
    x = rng.standard_normal((2 * dp, S, D)).astype(np.float32)
    r = rng.standard_normal((2 * dp, S, D)).astype(np.float32)
    return p, x, r


def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import reduced_config as jreduced
    from repro.layers import moe as jmoe
    from repro.sharding.rules import Rules as JRules

    res = {}
    rules = JRules(batch=("node",), tp="local")
    for dp, tp in LAYOUTS:
        mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                    ("node", "local"))
        p, x, r = (jax.tree.map(jnp.asarray, a) for a in _inputs(dp))
        for cap, factor in CAPS.items():
            base = jreduced(ARCH)
            cfg = dataclasses.replace(base, moe=dataclasses.replace(
                base.moe, capacity_factor=factor))

            def fy(p, x, cfg=cfg):
                y, _ = jmoe.apply(p, x, cfg, rules=rules, mesh=mesh)
                return (y * r).sum()

            def fa(p, x, cfg=cfg):
                return jmoe.apply(p, x, cfg, rules=rules, mesh=mesh)[1].mean()

            def both(p, x):
                return (jax.grad(fy, argnums=(0, 1))(p, x),
                        jax.grad(fa, argnums=(0, 1))(p, x))
            with jax.set_mesh(mesh):
                (gp, gx), (ap, ax) = tf.fast_compile(both, p, x)(p, x)
            key = f"{dp}x{tp}/{cap}"
            for name in LEAVES[:-1]:
                res[f"{key}/y/{name}"] = np.asarray(gp[name])
            res[f"{key}/y/x"] = np.asarray(gx)
            res[f"{key}/aux/router"] = np.asarray(ap["router"])
            res[f"{key}/aux/x"] = np.asarray(ax)
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tf.reference_npz(__file__, tmp_path_factory, "moe_bwd_ref",
                            devices=8)


def _layer(cap):
    layer = tmoe.MoE(_cfg(cap), device="cpu").float()
    p, _, _ = _inputs(1)
    with torch.no_grad():
        for name, w in layer.named_parameters():
            w.copy_(torch.from_numpy(p[name]))
    return layer.requires_grad_(True)


def _grads(layer, dp, grid=None):
    """``{leaf: gradient}`` of ``sum(y * r)`` and ``{leaf: gradient}`` of
    the aux (router and x), and the layer's EP routing (None without a
    grid)."""
    _, x, r = _inputs(dp)
    x = torch.from_numpy(x).requires_grad_()
    kw = {} if grid is None else dict(rules=Rules(batch=("node",),
                                                  tp="local"), grid=grid)
    y, aux = layer(x, **kw)
    weights = [layer.router, layer.w_gate, layer.w_up, layer.w_down, x]
    gy = torch.autograd.grad((y * torch.from_numpy(r)).sum(), weights,
                             retain_graph=True)
    ga = torch.autograd.grad(aux, [layer.router, x])
    routing = getattr(layer, "ep_routing", None) if grid is not None else None
    return dict(zip(LEAVES, gy)), dict(zip(("router", "x"), ga)), routing


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for cap in CAPS:
        layer = _layer(cap)
        for dp, tp in LAYOUTS:
            gy, ga, routing = _grads(layer, dp, RankGrid(dp, tp, "cpu"))
            out[dp, tp, cap] = gy, ga, {k: v.clone()
                                        for k, v in routing.items()}
    return out


CASES = [(dp, tp, cap) for dp, tp in LAYOUTS for cap in CAPS]


@pytest.mark.parametrize("dp,tp,cap", CASES)
def test_expert_parallel_gradients_match_reference(reference, port_runs, dp,
                                                   tp, cap):
    gy, _, routing = port_runs[dp, tp, cap]
    dropped = int((~routing["kept"]).sum())
    assert (dropped == 0) == (cap == "nodrop"), dropped
    for name in LEAVES:
        tf.relative(gy[name], reference[f"{dp}x{tp}/{cap}/y/{name}"],
                    REF_TOL, f"{dp}x{tp} {cap} d{name}")


@pytest.mark.parametrize("dp,tp,cap", CASES)
def test_aux_gradient_is_the_references(reference, port_runs, dp, tp, cap):
    """The aux's gradient is the reference's: the mean over every rank's
    slice (its value stays TP rank 0's, ``test_torch_moe.py``)."""
    _, ga, _ = port_runs[dp, tp, cap]
    for name in ("router", "x"):
        tf.relative(ga[name], reference[f"{dp}x{tp}/{cap}/aux/{name}"],
                    REF_TOL, f"{dp}x{tp} {cap} aux d{name}")


@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_expert_parallel_gradients_match_the_local_path(port_runs, dp, tp):
    """Without drops every routing is computed as on the local path, so
    the gradients of ``sum(y * r)`` agree to float32 reordering."""
    gy, _, _ = port_runs[dp, tp, "nodrop"]
    local, _, _ = _grads(_layer("nodrop"), dp)
    for name in LEAVES:
        tf.relative(gy[name], local[name].numpy(), LOCAL_TOL, name)


def _forced_codec_plan(self, collective, nbytes, dtype="float32",
                       error_budget=0.0):
    if error_budget > 0.0:
        return autotune.Selection(collective, "pip_mcoll", 0.0, "prior", "",
                                  codec="int8_block")
    return autotune.Selection(collective, "pip_mcoll", 0.0, "prior", "")


@pytest.mark.parametrize("what", ["weights", "tokens"])
def test_compressed_combine_under_grad_raises(monkeypatch, what):
    """A combine whose plan carries a codec raises under grad mode before
    any all-to-all runs (the reference's gradient there is far from the
    lossless one); under no_grad it runs."""
    monkeypatch.setattr(tcomm.Communicator, "plan", _forced_codec_plan)
    calls = []
    algorithm = mcoll.algorithm
    monkeypatch.setattr(mcoll, "algorithm", lambda *a: (
        calls.append(a), algorithm(*a))[1])
    layer = _layer("nodrop").requires_grad_(what == "weights")
    x = torch.from_numpy(_inputs(1)[1])
    if what == "tokens":
        x.requires_grad_()
    kw = dict(rules=Rules(batch=("node",), tp="local"),
              grid=RankGrid(1, 2, "cpu"), error_budget=0.07)
    with pytest.raises(ValueError, match="compressed combine"):
        layer(x, **kw)
    assert calls == []
    with torch.no_grad():
        y, _ = layer(x, **kw)
    assert calls and torch.isfinite(y).all()


if __name__ == "__main__":
    _reference(sys.argv[1])
