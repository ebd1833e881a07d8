"""The port's expert-parallel MoE against the reference's ``moe.apply``
with ``rules`` and a mesh, on the reduced qwen3-moe config (8 experts
top-2 of d_ff 64, d_model 128) and bf16 tokens ``(2 * dp, S, 128)``.

The reference side — this file's ``__main__``, run once per module in a
subprocess with 8 forced host devices — calls ``moe.apply(p, x, cfg,
rules=Rules(...), mesh=Mesh(devices, ("node", "local")))`` for every
layout, plan and capacity below, jitted and compiled at XLA's lowest
backend level (``torch_family.fast_compile``), and writes the outputs, each
rank's routing (the reference's own ``_route`` on the rank's slice) and
the plan requests to an ``.npz``. The port runs ``MoE.forward(x,
rules=..., grid=RankGrid(N, P, "cpu"))`` on the same weights and tokens.

Plans are forced in both packages by patching ``Communicator.plan``: the
lossless ``pip_mcoll``, ``pip_pipeline`` at 2 chunks and ``xla``, and two
compressed combines under ``error_budget=0.07`` (``pip_mcoll`` with
``int8_block``, ``pip_pipeline`` at 2 chunks with ``fp8_sim``; the
dispatch stays ``pip_mcoll``). Capacities: ``capacity_factor = tp``
(nothing can drop: ``cap = t * k``) and the default 1.25 (routings
drop). Checks: the routings and the drop counts equal, ``y`` within
``Y_TOL`` of the largest ``|y|`` (bf16 products in another order; one
quantization step more under a codec), the
lossless plans bitwise each other, ``aux`` within ``AUX_TOL`` of the
reference's value as its decoder reads it (``aux.mean()``: the mean over
the batch shards of TP rank 0's slice, pinned below), and the plan
requests (collective, bytes, dtype string, budget) equal.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import torch_family as tf
from repro_torch.configs import reduced_config
from repro_torch.core import autotune, compress
from repro_torch.core import comm as tcomm
from repro_torch.core.grid import RankGrid
from repro_torch.layers import moe as tmoe
from repro_torch.sharding.rules import Rules

ARCH = "qwen3-moe-235b-a22b"
#: name -> ((nodes, local), batch axes, tp axis, sequence length); the
#: last one pads the TP slices (T = 30 over 4 ranks: two zero rows route)
LAYOUTS = {
    "2x4_tp_local": ((2, 4), ("node",), "local", 16),
    "2x4_tp_node": ((2, 4), ("local",), "node", 16),
    "1x4": ((1, 4), ("node",), "local", 16),
    "1x2": ((1, 2), ("node",), "local", 16),
    "1x4_padded": ((1, 4), ("node",), "local", 15),
}
#: name -> (dispatch algo, chunks, combine codec); a codec runs the
#: combine under ERROR_BUDGET
PLANS = {
    "pip_mcoll": ("pip_mcoll", 1, "none"),
    "pip_pipeline_c2": ("pip_pipeline", 2, "none"),
    "xla": ("xla", 1, "none"),
    "int8_combine": ("pip_mcoll", 1, "int8_block"),
    "fp8_combine_c2": ("pip_pipeline", 2, "fp8_sim"),
}
LOSSLESS = ("pip_mcoll", "pip_pipeline_c2", "xla")
CAPS = ("tp", "default")
ERROR_BUDGET = 0.07
#: y against the reference, times the largest |y|: both compute in bf16
#: (products and SwiGLU rounded to bf16), in another order. A compressed
#: combine adds one quantization step of its codec, twice the codec's
#: stated bound: the two packages' expert outputs differ in their last
#: bits, so a value at a step's edge may encode to the neighbouring step
Y_TOL = 2.0 ** -6
#: aux against the reference (float32 sums in another order)
AUX_TOL = 1e-5


def _cfg(layout, cap, reduced):
    (N, P), _, tp, _ = LAYOUTS[layout]
    tp_size = {"node": N, "local": P}[tp]
    moe = dataclasses.replace(reduced.moe, n_experts=max(8, tp_size))
    if cap == "tp":
        moe = dataclasses.replace(moe, capacity_factor=float(tp_size))
    return dataclasses.replace(reduced, moe=moe)


def _x(layout):
    (N, P), batch, _, S = LAYOUTS[layout]
    dp = {"node": N, "local": P}[batch[0]]
    rng = np.random.default_rng(11 + len(layout) + S)
    return rng.standard_normal((2 * dp, S, 128)).astype(np.float32)


def _rank_slices(layout, x):
    """Each flat rank's routing slice of the tokens (the reference's
    ``mine``): its batch shard's tokens, padded, cut ``tp`` ways."""
    (N, P), batch, tp, S = LAYOUTS[layout]
    sizes = {"node": N, "local": P}
    bshard, tp_size = sizes[batch[0]], sizes[tp]
    B, D = x.shape[0], x.shape[2]
    T = B // bshard * S
    t = -(-T // tp_size)
    out = []
    for r in range(N * P):
        idx = dict(zip(("node", "local"), divmod(r, P)))
        toks = x[idx[batch[0]] * (B // bshard):][:B // bshard].reshape(T, D)
        toks = np.concatenate([toks, np.zeros((t * tp_size - T, D),
                                              x.dtype)])
        out.append(toks[idx[tp] * t:(idx[tp] + 1) * t])
    return out


def _dropped(ids, n_local_experts, tp_size, cap):
    """Routings past ``cap`` in their destination peer, counted in the
    flat order (token-major, k-minor) over every rank's ``ids``."""
    n = 0
    for r in ids:
        dest = r.reshape(-1) // n_local_experts
        for peer in range(tp_size):
            n += max(0, int((dest == peer).sum()) - cap)
    return n


def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from jax.sharding import Mesh
    from repro.configs import reduced_config as jreduced
    from repro.core import autotune as jautotune
    from repro.core import comm as jcomm
    from repro.layers import moe as jmoe
    from repro.sharding.rules import Rules as JRules

    reduced = jreduced(ARCH)
    res = {}
    params = jmoe.init(jax.random.PRNGKey(0), _cfg("1x4", "tp", reduced))
    for name, a in params.items():
        res[f"param/{name}"] = np.asarray(a, np.float32)
    requests = []
    forced = {}

    def plan(self, collective, nbytes, dtype="float32", error_budget=0.0):
        requests.append((collective, int(nbytes), dtype, float(error_budget)))
        algo, chunks, codec = forced["plan"]
        if error_budget > 0.0:
            return jautotune.Selection(collective, algo, 0.0, "prior", "",
                                       chunks=chunks, codec=codec)
        if codec != "none":  # a compressed combine: the dispatch pip_mcoll
            algo, chunks = "pip_mcoll", 1
        return jautotune.Selection(collective, algo, 0.0, "prior", "",
                                   chunks=chunks)

    jcomm.Communicator.plan = plan
    for layout, ((N, P), batch, tp, S) in LAYOUTS.items():
        mesh = Mesh(np.array(jax.devices()[:N * P]).reshape(N, P),
                    ("node", "local"))
        rules = JRules(batch=batch, tp=tp)
        xb = _x(layout).astype(ml_dtypes.bfloat16)
        x = jnp.asarray(xb)
        ids = [np.asarray(jmoe._route(params["router"], jnp.asarray(m),
                                      reduced.moe)[1])
               for m in _rank_slices(layout, xb)]
        res[f"{layout}/ids"] = np.stack(ids)
        for cap in CAPS:
            cfg = _cfg(layout, cap, reduced)
            for pname, spec in PLANS.items():
                forced["plan"] = spec
                budget = ERROR_BUDGET if spec[2] != "none" else 0.0
                del requests[:]
                fn = jax.jit(lambda p, x, cfg=cfg, rules=rules, mesh=mesh,
                             budget=budget: jmoe.apply(
                                 p, x, cfg, rules=rules, mesh=mesh,
                                 error_budget=budget))
                y, aux = tf.fast_compile(fn, params, x)(params, x)
                key = f"{layout}/{cap}/{pname}"
                res[f"{key}/y"] = np.asarray(y, np.float32)
                res[f"{key}/aux_mean"] = np.asarray(aux.mean())
                res[f"{key}/aux_shards"] = np.stack(
                    [np.asarray(s.data).reshape(-1)[0]
                     for s in aux.addressable_shards])
                res[f"{key}/requests"] = np.array(
                    [f"{c}|{n}|{d}|{b}" for c, n, d, b in requests])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tf.reference_npz(__file__, tmp_path_factory, "moe_ref", devices=8)


@pytest.fixture(scope="module")
def layers(reference):
    """Port layers with the reference's weights, per (layout, capacity)."""
    reduced = reduced_config(ARCH)
    out = {}
    for layout in LAYOUTS:
        for cap in CAPS:
            layer = tmoe.MoE(_cfg(layout, cap, reduced), device="cpu")
            with torch.no_grad():
                for name, p in layer.named_parameters():
                    p.copy_(torch.from_numpy(reference[f"param/{name}"]))
            out[layout, cap] = layer
    return out


@pytest.fixture(scope="module")
def port_runs(layers):
    """Every (layout, capacity, plan) through the port with the plan forced
    as the reference's was: y, aux, the routing and the plan requests."""
    requests, forced = [], {}

    def plan(self, collective, nbytes, dtype="float32", error_budget=0.0):
        requests.append((collective, int(nbytes), dtype, float(error_budget)))
        algo, chunks, codec = forced["plan"]
        if error_budget > 0.0:
            return autotune.Selection(collective, algo, 0.0, "prior", "",
                                      chunks=chunks, codec=codec)
        if codec != "none":
            algo, chunks = "pip_mcoll", 1
        return autotune.Selection(collective, algo, 0.0, "prior", "",
                                  chunks=chunks)

    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(tcomm.Communicator, "plan", plan)
    try:
        for (layout, cap), layer in layers.items():
            (N, P), batch, tp, _ = LAYOUTS[layout]
            x = torch.from_numpy(_x(layout)).bfloat16()
            for pname, spec in PLANS.items():
                forced["plan"] = spec
                del requests[:]
                y, aux = layer(x, rules=Rules(batch=batch, tp=tp),
                               grid=RankGrid(N, P, "cpu"),
                               error_budget=ERROR_BUDGET
                               if spec[2] != "none" else 0.0)
                out[layout, cap, pname] = dict(
                    y=y, aux=aux, requests=[f"{c}|{n}|{d}|{b}"
                                            for c, n, d, b in requests],
                    **{k: v.clone() for k, v in layer.ep_routing.items()})
    finally:
        mp.undo()
    return out


CASES = [(layout, cap, plan) for layout in LAYOUTS for cap in CAPS
         for plan in PLANS]


@pytest.mark.parametrize("layout,cap,plan", CASES)
def test_expert_parallel_matches_reference(reference, port_runs, layout,
                                           cap, plan):
    key = f"{layout}/{cap}/{plan}"
    run = port_runs[layout, cap, plan]
    want = reference[f"{key}/y"]
    assert run["y"].dtype == torch.bfloat16
    bound = compress.codec(PLANS[plan][2]).meta.error_bound
    tf.relative(run["y"], want, Y_TOL + 2 * bound, key)
    np.testing.assert_array_equal(run["ids"].numpy(),
                                  reference[f"{layout}/ids"])
    assert run["requests"] == list(reference[f"{key}/requests"])
    assert run["aux"].dtype == torch.float32 and run["aux"].dim() == 0
    tf.close(run["aux"], reference[f"{key}/aux_mean"], AUX_TOL, "aux")


@pytest.mark.parametrize("layout,cap", [(lo, c) for lo in LAYOUTS
                                        for c in CAPS])
def test_drops_and_lossless_plans(reference, port_runs, layers, layout, cap):
    """The drop count equals the reference routing's (none at capacity
    tp); the lossless plans give the same bits."""
    (N, P), _, tp, S = LAYOUTS[layout]
    tp_size = {"node": N, "local": P}[tp]
    moe = layers[layout, cap].cfg.moe
    runs = [port_runs[layout, cap, p] for p in LOSSLESS]
    capacity = tmoe.ep_capacity(2 * S, tp_size, moe)
    want = _dropped(reference[f"{layout}/ids"], moe.n_experts // tp_size,
                    tp_size, capacity)
    dropped = int((~runs[0]["kept"]).sum())
    assert dropped == want
    if cap == "tp":
        assert dropped == 0
    for other in runs[1:]:
        assert torch.equal(other["y"], runs[0]["y"])
        assert torch.equal(other["aux"], runs[0]["aux"])


def test_default_capacity_drops_routings(port_runs):
    """The default capacity factor drops routings in some layouts, so the
    drop path (the spare slot, the clamped gather, the zero weight) runs."""
    assert sum(int((~port_runs[lo, "default", "pip_mcoll"]["kept"]).sum())
               for lo in LAYOUTS) > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_aux_is_the_mean_of_tp_rank_zeros_slices(reference, layout):
    """Pins the reference's aux semantics: ``shard_map`` (check off) hands
    back the TP-unmapped aux of the first device of each TP group, so
    ``aux.mean()`` averages, over the batch shards, the loss of TP rank
    0's routing slice; the other TP ranks' losses differ."""
    (N, P), batch, tp, _ = LAYOUTS[layout]
    key = f"{layout}/default/pip_mcoll"
    shards = reference[f"{key}/aux_shards"].reshape(N, P)
    lead = shards[:, 0] if tp == "local" else shards[0, :]
    np.testing.assert_allclose(reference[f"{key}/aux_mean"], lead.mean(),
                               rtol=1e-6)
    others = shards[:, 1:] if tp == "local" else shards[1:, :]
    assert not np.allclose(others.mean(), lead.mean(), rtol=1e-3)


def test_expert_parallel_equals_the_local_path_at_capacity_tp(layers):
    """With nothing dropped the expert-parallel path computes each routing
    as the local path does: the same bits."""
    layer = layers["2x4_tp_local", "tp"]
    x = torch.from_numpy(_x("2x4_tp_local")).bfloat16()
    y, _ = layer(x, rules=Rules(batch=("node",), tp="local"),
                 grid=RankGrid(2, 4, "cpu"))
    assert torch.equal(y, layer(x)[0])


def test_expert_parallel_refuses_grad_and_process_grids(layers):
    layer = layers["1x4", "tp"]
    x = torch.from_numpy(_x("1x4")).bfloat16()
    rules = Rules(batch=("node",), tp="local")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        layer(x.clone().requires_grad_(), rules=rules,
              grid=RankGrid(1, 4, "cpu"))
    from repro_torch.core.grid import ProcessGrid
    fake = object.__new__(ProcessGrid)
    fake.n_nodes, fake.n_local = 1, 4
    with pytest.raises(NotImplementedError, match="item 5b"):
        layer(x, rules=rules, grid=fake)
    # the reference's local-path condition: no TP axis of size > 1
    y, _ = layer(x, rules=Rules(batch=("node",), tp="node"),
                 grid=RankGrid(1, 4, "cpu"))
    assert torch.equal(y, layer(x)[0])


if __name__ == "__main__":
    _reference(sys.argv[1])
