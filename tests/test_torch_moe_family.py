"""The port's MoE family against the reference's, on the reduced
qwen3-moe-235b-a22b (2 layers, MoE of 8 experts top-2 of d_ff 64 on every
block, d_model 128, 4 heads of 32 over 2 KV heads) and the reduced
arctic-480b (the same, plus a dense residual MLP of d_ff 256 beside each
MoE, and its 4 heads padded to 16: G 8 with 12 zero heads a group).

The reference side — this file's ``__main__``, run once per module in a
subprocess with 8 forced host devices — draws each model's weights from
numpy (``torch_family.draw_params``, the router float32 as the
reference's ``init`` keeps it), compiles its model programs at XLA's
lowest backend level (``torch_family.fast_compile``) and writes every
output to an ``.npz``; the port receives the same weights through
``interop.params_from_reference``.

  * the configs: ``get_config`` and ``reduced_config`` field by field,
    ``first_layers`` and the parameter counts;
  * float32 (the tree cast in both packages): logits through the caches
    (a prefill, then decode ticks) within ``F32_TOL`` times the largest
    logit, the load-balance loss within ``F32_TOL``;
  * float32 through the expert-parallel path: ``decoder.forward(...,
    rules=Rules(batch=("node",), tp="local"), mesh=<2x4>)`` against the
    port's ``forward(..., rules=..., grid=RankGrid(2, 4, "cpu"))`` at
    capacity 4 (nothing drops) and at the default 1.25, the same bars, the plans each package's selector resolves (lossless
    plans move the same bits);
  * float32 ``loss_fn`` and its gradients (the local MoE): the loss
    within ``rtol=1e-6``, each leaf's gradient within ``GRAD_TOL`` of
    that leaf's largest ``|g|``;
  * bfloat16 (the reference's own dtypes): the ``Engine``'s greedy tokens
    against the reference ``Engine``'s solo runs under the top-2 margin
    guard of ``tests/torch_family.py``, with and without the flash-decode
    wrapper (its plain version on the CPU).
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import torch_family as tf
from repro_torch import interop
from repro_torch.configs import first_layers, get_config, reduced_config
from repro_torch.core.grid import RankGrid
from repro_torch.models import params as tparams
from repro_torch.models.decoder import RunFlags
from repro_torch.models.params import FlatParams
from repro_torch.serve.engine import Engine, Request
from repro_torch.sharding.rules import Rules
from repro_torch.train.step import TrainConfig, value_and_grad

ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
B, T, STEPS = 2, 8, 4
#: the expert-parallel forward's batch: one row a node, 16 tokens each
EP_B, EP_T = 4, 16
F32_TOL = 1e-4
GRAD_TOL = 1e-4
BF16_TOL = 2.0 ** -6
MAX_LEN, NEW = 64, 6
PROMPT_LENS = (11, 6)
F32_LEAVES = ("router",)
CAPS = {"tp": 4.0, "default": 1.25}


def _tokens(step, batch=B, n=T):
    rng = np.random.default_rng(40 + step)
    return rng.integers(0, 512, size=(batch, n if step < 0 else 1),
                        dtype=np.int32)


def _batch():
    rng = np.random.default_rng(50)
    return {"tokens": rng.integers(0, 512, (B, T)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, T)).astype(np.int32)}


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, size=(n,), dtype=np.int32)
            for n in PROMPT_LENS]


def _with_cap(cfg, cap):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPS[cap]))


def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import decoder
    from repro.sharding.rules import Rules as JRules
    from repro.train import step as jstep

    res = {}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("node", "local"))
    rules = JRules(batch=("node",), tp="local")
    for arch in ARCHS:
        full, cfg = jget(arch), jreduced(arch)
        res[f"{arch}/config/full"] = json.dumps(dataclasses.asdict(full))
        res[f"{arch}/config/reduced"] = json.dumps(dataclasses.asdict(cfg))
        res[f"{arch}/n_params/full"] = np.int64(full.n_params())
        res[f"{arch}/n_params/reduced"] = np.int64(cfg.n_params())
        drawn = tf.draw_params(jax.eval_shape(
            lambda k: decoder.init(k, cfg), jax.random.PRNGKey(0)))
        for path, leaf in tf.flatten(drawn):
            res[f"{arch}/param/{path}"] = np.asarray(leaf, np.float32)
        bf16 = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(np.asarray(a, np.float32)
                                     if p[-1].key in F32_LEAVES else a),
            drawn)
        f32 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                           drawn)
        flags = decoder.RunFlags(logits_dtype="float32", remat="none")

        # through the caches: a prefill, then decode ticks
        def prefill(p, t, c):
            return decoder.forward(p, t, cfg, flags=flags, caches=c)

        def tick(p, t, c, i):
            return decoder.forward(p, t, cfg, flags=flags, caches=c,
                                   cache_index=i)
        caches = jax.tree.map(lambda a: a.astype(jnp.float32),
                              decoder.init_cache(cfg, B, MAX_LEN))
        toks = jnp.asarray(_tokens(-1))
        logits, aux, caches = tf.fast_compile(prefill, f32, toks, caches)(
            f32, toks, caches)
        res[f"{arch}/prefill"], res[f"{arch}/prefill_aux"] = (
            np.asarray(logits), np.asarray(aux))
        step_fn = None
        for step in range(STEPS):
            toks, idx = jnp.asarray(_tokens(step)), jnp.int32(T + step)
            if step_fn is None:
                step_fn = tf.fast_compile(tick, f32, toks, caches, idx)
            logits, aux, caches = step_fn(f32, toks, caches, idx)
            res[f"{arch}/step{step}"] = np.asarray(logits)
            res[f"{arch}/step{step}_aux"] = np.asarray(aux)

        # the expert-parallel forward on the 2x4 mesh
        toks = jnp.asarray(_tokens(-2, EP_B, EP_T))
        for cap in CAPS:
            ccfg = _with_cap(cfg, cap)
            fn = tf.fast_compile(lambda p, t, ccfg=ccfg: decoder.forward(
                p, t, ccfg, rules=rules, mesh=mesh, flags=flags)[:2],
                f32, toks)
            logits, aux = fn(f32, toks)
            res[f"{arch}/ep/{cap}"] = np.asarray(logits)
            res[f"{arch}/ep/{cap}_aux"] = np.asarray(aux)
            fn = tf.fast_compile(lambda p, t, ccfg=ccfg: decoder.forward(
                p, t, ccfg, flags=flags)[:2], f32, toks)
            res[f"{arch}/local/{cap}"] = np.asarray(fn(f32, toks)[0])

        # loss and gradients, one device (the local MoE)
        tcfg = jstep.TrainConfig(flags=flags)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        (loss, mets), grads = tf.fast_compile(
            jax.value_and_grad(lambda p, b: jstep.loss_fn(p, b, cfg, tcfg),
                               has_aux=True), f32, batch)(f32, batch)
        res[f"{arch}/loss"], res[f"{arch}/loss_aux"] = (np.asarray(loss),
                                                       np.asarray(mets["aux"]))
        for path, g in tf.flatten(jax.device_get(grads)):
            res[f"{arch}/grad/{path}"] = np.asarray(g, np.float32)

        # the Engine: each request alone on a fresh engine
        for i, p in enumerate(_prompts()):
            (res[f"{arch}/solo{i}/tokens"], res[f"{arch}/solo{i}/margins"]), \
                = tf.ref_serve(bf16, cfg, [p], 1, MAX_LEN, NEW)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tf.reference_npz(__file__, tmp_path_factory, "moe_family_ref",
                            devices=8)


def _of(reference, arch):
    return {k[len(arch) + 1:]: v for k, v in reference.items()
            if k.startswith(arch + "/")}


@pytest.fixture(scope="module")
def models(reference):
    return {(arch, dt): interop.params_from_reference(
                tf.tree(_of(reference, arch), dt, F32_LEAVES),
                reduced_config(arch), device="cpu")
            for arch in ARCHS for dt in ("float32", "bfloat16")}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(reference, arch):
    ref = _of(reference, arch)
    for kind, cfg in (("full", get_config(arch)),
                      ("reduced", reduced_config(arch))):
        want = json.loads(str(ref[f"config/{kind}"]))
        got = json.loads(json.dumps(dataclasses.asdict(cfg)))
        assert got == want, kind
        assert cfg.n_params() == int(ref[f"n_params/{kind}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_follow_the_reference_tree(reference, arch, models):
    """``params.n_params`` counts the reference tree's leaves. The
    config's formula counts ``n_heads``, not the padded heads: arctic's
    ``wq`` and ``wo`` each carry ``(Hp - H) * hd * D`` more a layer."""
    ref = _of(reference, arch)
    for cfg in (reduced_config(arch), get_config(arch)):
        pad = cfg.n_layers * 2 * cfg.d_model * cfg.head_dim * \
            (cfg.padded_heads - cfg.n_heads)
        assert tparams.n_params(cfg) == cfg.n_params() + pad
    cfg = reduced_config(arch)
    assert tparams.n_params(cfg) == sum(
        a.size for k, a in ref.items() if k.startswith("param/"))
    assert [(k[len("param/"):], a.shape) for k, a in ref.items()
            if k.startswith("param/")] == tparams.param_shapes(cfg)
    model = models[arch, "bfloat16"]
    assert sum(p.numel() for p in model.parameters()) == \
        tparams.n_params(cfg)
    arctic = cfg.moe.dense_residual
    assert all(hasattr(b, "moe") and hasattr(b, "ffn") == arctic
               for b in model.blocks)
    assert model.blocks[0].moe.router.dtype == torch.float32


def test_first_layers_cuts_whole_cycles_at_published_widths():
    """qwen3-moe cut to its first 4 layers and arctic to 1, every width
    the published one; a cut past ``n_layers`` or of no cycle raises."""
    q = first_layers(get_config("qwen3-moe-235b-a22b"), 4)
    assert (q.n_layers, q.block_pattern, q.d_model, q.n_heads,
            q.n_kv_heads, q.head_dim, q.moe.n_experts, q.moe.top_k,
            q.moe.d_ff_expert, q.vocab) == (4, ("attn",), 4096, 64, 4, 64,
                                            128, 8, 1536, 151936)
    assert tparams.n_params(q) == 11_053_076_480
    a = first_layers(get_config("arctic-480b"), 1)
    assert (a.n_layers, a.d_model, a.padded_heads, a.n_kv_heads,
            a.moe.n_experts, a.moe.top_k, a.moe.d_ff_expert, a.d_ff) == \
        (1, 7168, 64, 8, 128, 2, 4864, 4864)
    assert tparams.n_params(a) == 14_084_625_408
    for n in (0, 95):
        with pytest.raises(ValueError, match="whole number of cycles"):
            first_layers(get_config("qwen3-moe-235b-a22b"), n)
    assert first_layers(get_config("qwen3-moe-235b-a22b"), 94) == \
        get_config("qwen3-moe-235b-a22b")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(reference, models, arch,
                                            use_flash_decode):
    ref = _of(reference, arch)
    model = models[arch, "float32"]
    flags = RunFlags(logits_dtype="float32",
                     use_flash_decode=use_flash_decode)
    caches = model.init_cache(B, MAX_LEN, dtype=torch.float32)
    logits, aux, _ = model(torch.from_numpy(_tokens(-1)).long(), caches,
                           flags=flags)
    tf.relative(logits, ref["prefill"], F32_TOL, "prefill")
    tf.close(aux, ref["prefill_aux"], F32_TOL, "prefill aux")
    for step in range(STEPS):
        logits, aux, _ = model(torch.from_numpy(_tokens(step)).long(),
                               caches, torch.tensor(T + step), flags=flags)
        tf.relative(logits, ref[f"step{step}"], F32_TOL, f"step {step}")
        tf.close(aux, ref[f"step{step}_aux"], F32_TOL, f"step {step} aux")


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_forward_matches_reference(reference, models, arch,
                                                   cap):
    """The decoder through the expert-parallel MoE on a 2x4 grid (experts
    over the local axis, batch over the nodes) against the reference's
    ``decoder.forward(..., rules=, mesh=)``: logits and the load-balance
    loss as the reference's decoder sums it (TP rank 0's slice a shard,
    ``tests/test_torch_moe.py``). At capacity 4 they also equal the
    local path's logits."""
    ref = _of(reference, arch)
    model = models[arch, "float32"]
    cfg = _with_cap(reduced_config(arch), cap)
    for blk in model.blocks:
        blk.moe.cfg = cfg
    try:
        toks = torch.from_numpy(_tokens(-2, EP_B, EP_T)).long()
        flags = RunFlags(logits_dtype="float32", remat="none")
        with torch.no_grad():
            logits, aux, _ = model(toks, flags=flags,
                                   rules=Rules(batch=("node",), tp="local"),
                                   grid=RankGrid(2, 4, "cpu"))
            local, _, _ = model(toks, flags=flags)
    finally:
        for blk in model.blocks:
            blk.moe.cfg = reduced_config(arch)
    tf.relative(logits, ref[f"ep/{cap}"], F32_TOL, "logits")
    tf.close(aux, ref[f"ep/{cap}_aux"], F32_TOL, "aux")
    tf.relative(local, ref[f"local/{cap}"], F32_TOL, "local logits")
    if cap == "tp":
        tf.relative(logits, ref[f"local/{cap}"], F32_TOL, "EP = local")


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_loss_and_gradients_match_reference(reference, models, arch):
    ref = _of(reference, arch)
    cfg = reduced_config(arch)
    model = interop.params_from_reference(
        tf.tree(ref, "float32", F32_LEAVES), cfg, device="cpu").trainable()
    flat = FlatParams.of(model)
    batch = {k: torch.from_numpy(v).long() for k, v in _batch().items()}
    tcfg = TrainConfig(flags=RunFlags(logits_dtype="float32",
                                      remat="none"))
    loss, mets, grads = value_and_grad(model, flat, batch, tcfg)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)
    np.testing.assert_allclose(float(mets["aux"]), ref["loss_aux"],
                               rtol=1e-6)
    buf = flat.gather(grads)
    for path, start, end, _ in flat.spans:
        want = ref[f"grad/{path}"]
        tf.relative(buf[start:end].reshape(want.shape), want, GRAD_TOL, path)


def _serve(model, cfg, prompts, max_batch, **kw):
    eng = Engine(model, cfg, max_batch=max_batch, max_len=MAX_LEN, **kw)
    done = eng.run([Request(prompt=p.copy(), max_new_tokens=NEW)
                    for p in prompts])
    return {tuple(r.prompt.tolist()): r.out_tokens for r in done}


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_solo_runs(reference, models, arch,
                                            use_flash_decode):
    """Both requests through two slots give, request by request, the
    reference engine's tokens for that request alone, up to the bf16
    guard; the slot-batched run equals the port's own solo runs."""
    ref = _of(reference, arch)
    cfg = reduced_config(arch)
    flags = RunFlags(use_flash_decode=use_flash_decode)
    got = _serve(models[arch, "bfloat16"], cfg, _prompts(), 2, flags=flags)
    same = 0
    for i, p in enumerate(_prompts()):
        toks = got[tuple(p.tolist())]
        want = ref[f"solo{i}/tokens"].tolist()
        assert len(toks) == len(want) == NEW
        same += tf.guard(toks, want, ref[f"solo{i}/margins"], BF16_TOL,
                         f"request {i}")
    assert same >= len(PROMPT_LENS) - 1, f"only {same} requests agree"


def test_dense_residual_adds_the_mlp_to_the_moe(models):
    """Arctic's block: ``h + moe(x) + ffn(x)`` on the same normed input
    ``x``, in the reference's order (``f = moe + mlp``)."""
    blk = models["arctic-480b", "float32"].blocks[0]
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, T, 128)).astype(np.float32))
    out, aux = blk._ffn(h, None, None)
    x = blk.ln2(h, blk.eps)
    f, want_aux = blk.moe(x)
    assert torch.equal(out, h + (f + blk.ffn(x)))
    assert torch.equal(aux, want_aux)


if __name__ == "__main__":
    _reference(sys.argv[1])
