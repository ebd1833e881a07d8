"""The port's hybrid family (jamba) against the reference's, on the reduced
jamba config (8 layers: mamba blocks and one attention block, MoE of 8
experts top-2 of d_ff 64 on every other block, d_model 128, Di 256, vocab
512): the mamba and MoE layers, the ``DecoderLM`` through its caches, and
the serving ``Engine``.

The reference side — this file's ``__main__``, run once per module in a
subprocess — initialises ``repro.models.decoder`` from ``PRNGKey(0)`` and
writes the parameters and every output to an ``.npz``; the port receives
the same parameters through ``interop.params_from_reference``.

  * float32 (the tree cast in both packages): layer outputs and states
    within ``F32_TOL``, logits within ``F32_TOL`` times the largest logit
    (the order of fp32 sums);
  * bfloat16 (the reference's own dtypes): the Engine's greedy tokens
    under the top-2 margin guard of ``tests/torch_family.py``.

The reference takes its mamba kernel only without a carried state
(``repro/layers/mamba.py:121``), so only the cache-free forward reaches it
(in interpret mode); with a state it runs its plain scan. The port takes
its kernel wrapper whenever ``use_mamba_kernel`` is set, which on the CPU
runs the plain version.

The reference ``Engine`` carries a finished request's mamba state into the
next request in the same slot; the port's zeroes it on admission. A
request's correct answer is its run alone on a fresh engine, so the port
is held against the reference's solo runs.
"""
import copy
import dataclasses
import sys

import numpy as np
import pytest
import torch

import torch_family as tf
from repro_torch import interop
from repro_torch.configs import first_layers, get_config, reduced_config
from repro_torch.core import runtime
from repro_torch.core.grid import RankGrid
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import mamba as kmamba
from repro_torch.layers import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models.decoder import DecoderLM, MambaBlock, RunFlags
from repro_torch.serve.engine import Engine, Request
from repro_torch.sharding.rules import Rules

ARCH = "jamba-1.5-large-398b"
B, T, STEPS, LAYER_STEPS = 2, 8, 6, 3
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6
MAX_BATCH, MAX_LEN, NEW = 2, 64, 8
#: prompts from numpy seed 0: A (12 tokens), B (9), C (5)
PROMPT_LENS = (12, 9, 5)
#: the reference engine serving A, then B, in one slot, and B's tokens
#: there and alone (the reference's behaviour, not the port's)
STALE = (0, 1)
STALE_TOKENS = [422, 416, 173, 338, 440, 305, 212, 243]
SOLO_B_TOKENS = [422, 302, 368, 242, 169, 487, 47, 243]
#: the reduced config's parameters: the reference tree's leaves, and the
#: config's formula, which omits each mamba layer's conv_b and dt_bias
N_PARAMS, N_PARAMS_FORMULA = 2_181_504, 2_177_920
#: the reference keeps these leaves float32 in its bf16 tree
F32_LEAVES = ("A_log", "D_skip", "router")


def _tokens(step):
    rng = np.random.default_rng(30 + step)
    return rng.integers(0, 512, size=(B, T if step < 0 else 1),
                        dtype=np.int32)


def _layer_inputs():
    """x (B, T, D), LAYER_STEPS decode inputs (B, 1, D) and a carried mamba
    state (conv (B, K-1, Di), ssm (B, Di, N))."""
    rng = np.random.default_rng(5)
    return (rng.standard_normal((B, T, 128)).astype(np.float32),
            rng.standard_normal((LAYER_STEPS, B, 1, 128)).astype(np.float32),
            rng.standard_normal((B, 3, 256)).astype(np.float32),
            (rng.standard_normal((B, 256, 16)) * 0.1).astype(np.float32))


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, size=(n,), dtype=np.int32)
            for n in PROMPT_LENS]






def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.layers import mamba as jmamba
    from repro.layers import moe as jmoe
    from repro.models import decoder

    cfg = jreduced(ARCH)
    params = decoder.init(jax.random.PRNGKey(0), cfg)
    res = {f"param/{'/'.join(str(k.key) for k in path)}":
           np.asarray(leaf, np.float32)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)

    # the mamba layer (cycle 0, block 0): without a state, with the Pallas
    # kernel, and from a carried state through a prefill and decode steps
    x, steps, conv, ssm = (jnp.asarray(a) for a in _layer_inputs())
    pm = jax.tree.map(lambda a: a[0], f32["groups"]["blk0"]["mamba"])
    res["mamba/fresh"] = np.asarray(jmamba.apply(pm, x, cfg)[0])
    res["mamba/kernel"] = np.asarray(jmamba.apply(pm, x, cfg,
                                                  use_kernel=True)[0])
    state = {"conv": conv, "ssm": ssm}
    out, state = jmamba.apply(pm, x, cfg, state=state)
    res["mamba/prefill"] = np.asarray(out)
    for i in range(LAYER_STEPS):
        out, state = jmamba.apply(pm, steps[i], cfg, state=state)
        res[f"mamba/step{i}"] = np.asarray(out)
    res["mamba/conv"], res["mamba/ssm"] = (np.asarray(state["conv"]),
                                           np.asarray(state["ssm"]))

    # the MoE layer (cycle 0, block 1), single-device path
    pe = jax.tree.map(lambda a: a[0], f32["groups"]["blk1"]["moe"])
    y, aux = jmoe.apply(pe, x, cfg, mesh=None)
    res["moe/y"], res["moe/aux"] = np.asarray(y), np.asarray(aux)

    # the model in float32: prefill, then teacher-forced decode steps
    caches = jax.tree.map(lambda a: a.astype(jnp.float32),
                          decoder.init_cache(cfg, B, MAX_LEN))
    flags = decoder.RunFlags(logits_dtype="float32")
    logits, aux, caches = decoder.forward(f32, jnp.asarray(_tokens(-1)), cfg,
                                          flags=flags, caches=caches)
    res["f32/prefill"], res["f32/prefill_aux"] = (np.asarray(logits),
                                                  np.asarray(aux))
    for step in range(STEPS):
        logits, aux, caches = decoder.forward(
            f32, jnp.asarray(_tokens(step)), cfg, flags=flags, caches=caches,
            cache_index=jnp.int32(T + step))
        res[f"f32/step{step}"] = np.asarray(logits)
        res[f"f32/step{step}_aux"] = np.asarray(aux)
    # without caches the reference reaches its Pallas kernel
    kflags = decoder.RunFlags(logits_dtype="float32", use_mamba_kernel=True)
    logits, aux, _ = decoder.forward(f32, jnp.asarray(_tokens(-1)), cfg,
                                     flags=kflags)
    res["f32/nocache_kernel"] = np.asarray(logits)
    res["f32/nocache_kernel_aux"] = np.asarray(aux)

    # the Engine: each request alone on a fresh engine, then two requests
    # one after the other through one slot
    prompts = _prompts()
    for i, p in enumerate(prompts):
        (res[f"solo{i}/tokens"], res[f"solo{i}/margins"]), = tf.ref_serve(
            params, cfg, [p], 1, MAX_LEN, NEW)
    stale = tf.ref_serve(params, cfg, [prompts[i] for i in STALE], 1,
                         MAX_LEN, NEW)
    res["stale/tokens"] = stale[1][0]
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tf.reference_npz(__file__, tmp_path_factory, "jamba_ref")


@pytest.fixture(scope="module")
def cfg():
    return reduced_config(ARCH)




@pytest.fixture(scope="module")
def models(reference, cfg):
    return {dt: interop.params_from_reference(
                tf.tree(reference, dt, F32_LEAVES), cfg, device="cpu")
            for dt in ("float32", "bfloat16")}








# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_without_state_matches_reference(reference, models,
                                               use_kernel):
    """The reference's plain scan and its Pallas kernel (interpret mode)
    give the same layer output; the port's plain and kernel paths match
    both."""
    layer = models["float32"].blocks[0].mamba
    x = torch.from_numpy(_layer_inputs()[0])
    out = layer(x, use_kernel=use_kernel)
    tf.close(out, reference["mamba/fresh"], F32_TOL, "against the plain scan")
    tf.close(out, reference["mamba/kernel"], F32_TOL, "against the kernel")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_prefill_and_decode_from_a_state_match_reference(
        reference, models, use_kernel):
    """A prefill from a carried state, then decode steps: outputs, and the
    conv history and scan state written in place."""
    layer = models["float32"].blocks[0].mamba
    x, steps, conv, ssm = (torch.from_numpy(a) for a in _layer_inputs())
    state = {"conv": conv.clone(), "ssm": ssm.clone()}
    ptrs = {n: t.data_ptr() for n, t in state.items()}
    tf.close(layer(x, state, use_kernel=use_kernel),
             reference["mamba/prefill"], F32_TOL, "prefill")
    for i in range(LAYER_STEPS):
        tf.close(layer(steps[i], state, use_kernel=use_kernel),
                 reference[f"mamba/step{i}"], F32_TOL, f"step {i}")
    assert {n: t.data_ptr() for n, t in state.items()} == ptrs
    tf.close(state["conv"], reference["mamba/conv"], F32_TOL, "conv")
    tf.close(state["ssm"], reference["mamba/ssm"], F32_TOL, "ssm")


def test_moe_matches_reference(reference, models):
    layer = models["float32"].blocks[1].moe
    y, aux = layer(torch.from_numpy(_layer_inputs()[0]))
    tf.close(y, reference["moe/y"], F32_TOL, "y")
    assert aux.dtype == torch.float32 and aux.dim() == 0
    tf.close(aux, reference["moe/aux"].mean(), F32_TOL, "aux")


def test_moe_refuses_the_expert_parallel_path(models, cfg):
    """The expert-parallel path (it used to be refused) on a 2x4 grid, the
    experts split over the local axis and the batch over the nodes: at
    capacity tp nothing drops, and each routing is computed as the local
    path computes it."""
    layer = copy.copy(models["float32"].blocks[1].moe)
    layer.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    x = torch.from_numpy(_layer_inputs()[0])
    y, aux = layer(x, rules=Rules(batch=("node",), tp="local"),
                   grid=RankGrid(2, 4, device="cpu"))
    assert not bool((~layer.ep_routing["kept"]).any())
    want, _ = layer(x)
    torch.testing.assert_close(y, want, rtol=F32_TOL, atol=F32_TOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0


def test_moe_draws_its_experts_one_by_one(cfg):
    """Each expert's matrix is its own N(0, 1/fan_in) draw, cast to bf16."""
    layer = tmoe.MoE(cfg, torch.Generator("cpu").manual_seed(1),
                     device="cpu")
    E, D, F = 8, 128, 64
    assert layer.router.dtype == torch.float32
    for name, shape, fan_in in (("w_gate", (E, D, F), D),
                                ("w_up", (E, D, F), D),
                                ("w_down", (E, F, D), F)):
        w = getattr(layer, name)
        assert tuple(w.shape) == shape and w.dtype == torch.bfloat16
        std = w.float().std(dim=(1, 2)) * fan_in ** 0.5
        assert bool(((std - 1).abs() < 0.05).all()), (name, std)
    assert not torch.equal(layer.w_gate[0], layer.w_gate[1])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_jamba_builds_with_its_block_kinds(cfg):
    model = DecoderLM(cfg, device="meta")
    kinds = [(type(b).__name__, "moe" if hasattr(b, "moe") else "ffn")
             for b in model.blocks]
    assert kinds == [("MambaBlock", "ffn"), ("MambaBlock", "moe")] * 2 + \
        [("AttnBlock", "ffn"), ("MambaBlock", "moe"), ("MambaBlock", "ffn"),
         ("MambaBlock", "moe")]
    caches = model.init_cache(3, 16)
    assert [sorted(c) for c in caches] == [["conv", "ssm"]] * 4 + \
        [["k", "v"]] + [["conv", "ssm"]] * 3
    assert tuple(caches[0]["conv"].shape) == (3, 3, 256)
    assert tuple(caches[0]["ssm"].shape) == (3, 256, 16)
    assert caches[0]["ssm"].dtype == torch.float32


def test_params_from_reference_carries_the_jamba_tree(reference, models,
                                                      cfg):
    model = models["bfloat16"]
    n = sum(p.numel() for p in model.parameters())
    ref_n = sum(a.size for k, a in reference.items()
                if k.startswith("param/"))
    assert n == ref_n == tparams.n_params(cfg) == N_PARAMS
    assert cfg.n_params() == N_PARAMS_FORMULA
    w_up = reference["param/groups/blk3/moe/w_up"]
    a_log = reference["param/groups/blk2/mamba/A_log"]
    assert torch.equal(model.blocks[3].moe.w_up.float(),
                       torch.from_numpy(w_up[0]))
    layer = model.blocks[2].mamba
    assert torch.equal(layer.A_log, torch.from_numpy(a_log[0]))
    assert layer.A_log.dtype == layer.D_skip.dtype == torch.float32
    assert model.blocks[3].moe.router.dtype == torch.float32
    assert layer.in_proj.dtype == layer.conv_w.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in model.parameters())


def test_param_shapes_follow_the_reference_tree(reference, cfg):
    want = [(k[len("param/"):], reference[k].shape)
            for k in reference if k.startswith("param/")]
    assert tparams.param_shapes(cfg) == want


def test_seeded_init_has_the_reference_layout(cfg):
    """A model drawn by the port's own generator has every leaf of the
    reference's layout, with the reference's dtypes."""
    model = DecoderLM(cfg, torch.Generator("cpu").manual_seed(0),
                      device="cpu")
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS
    layer = model.blocks[0].mamba
    assert torch.equal(layer.A_log[3], torch.log(torch.arange(1.0, 17.0)))
    assert bool((layer.dt_bias == -4.6).all())
    assert not bool(layer.conv_b.any())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_reference(reference, models, use_kernel):
    """Prefill logits and aux, then decode steps through the caches, in
    float32."""
    model = models["float32"]
    caches = model.init_cache(B, MAX_LEN, dtype=torch.float32)
    flags = RunFlags(use_mamba_kernel=use_kernel, logits_dtype="float32")
    logits, aux, caches = model(torch.from_numpy(_tokens(-1)), caches,
                                flags=flags)
    tf.relative(logits, reference["f32/prefill"], F32_TOL, "prefill")
    tf.close(aux, reference["f32/prefill_aux"], F32_TOL, "prefill aux")
    for step in range(STEPS):
        logits, aux, caches = model(torch.from_numpy(_tokens(step)), caches,
                                    T + step, flags=flags)
        assert logits.shape == (B, 1, 512)
        tf.relative(logits, reference[f"f32/step{step}"], F32_TOL,
                    f"step {step}")
        tf.close(aux, reference[f"f32/step{step}_aux"], F32_TOL,
                 f"step {step} aux")


def test_forward_without_caches_matches_reference_kernel(reference, models):
    """Without caches the reference runs its Pallas kernel (interpret
    mode)."""
    flags = RunFlags(use_mamba_kernel=True, logits_dtype="float32")
    logits, aux, caches = models["float32"](torch.from_numpy(_tokens(-1)),
                                            flags=flags)
    assert caches is None
    tf.relative(logits, reference["f32/nocache_kernel"], F32_TOL, "forward")
    tf.close(aux, reference["f32/nocache_kernel_aux"], F32_TOL, "aux")


def test_reset_state_zeroes_mamba_state_only(models):
    model = models["float32"]
    caches = model.init_cache(2, 8)
    for c in caches:
        for t in c.values():
            t.fill_(1.0)
    model.reset_state([{n: t[1:] for n, t in c.items()} for c in caches])
    for blk, c in zip(model.blocks, caches):
        for t in c.values():
            assert bool((t[0] == 1).all())
            assert bool((t[1] == 0).all()) == isinstance(blk, MambaBlock)


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------


def _serve(model, cfg, prompts, max_batch, **kw):
    eng = Engine(model, cfg, max_batch=max_batch, max_len=MAX_LEN, **kw)
    done = eng.run([Request(prompt=p.copy(), max_new_tokens=NEW)
                    for p in prompts])
    return {tuple(r.prompt.tolist()): r.out_tokens for r in done}, eng


def _solo(model, cfg, prompts, **kw):
    out = {}
    for p in prompts:
        out.update(_serve(model, cfg, [p], 1, **kw)[0])
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_matches_reference_solo_runs(reference, models, cfg,
                                            use_kernel):
    """Three requests through two slots (the third reuses one) give,
    request by request, the reference engine's tokens for that request
    alone on a fresh engine, up to the bf16 guard."""
    flags = RunFlags(use_mamba_kernel=use_kernel)
    got, _ = _serve(models["bfloat16"], cfg, _prompts(), MAX_BATCH,
                    flags=flags)
    same = 0
    for i, p in enumerate(_prompts()):
        toks = got[tuple(p.tolist())]
        want = reference[f"solo{i}/tokens"].tolist()
        assert len(toks) == len(want) == NEW
        same += tf.guard(toks, want, reference[f"solo{i}/margins"],
                         BF16_TOL, f"request {i}")
    assert same >= len(PROMPT_LENS) - 1, f"only {same} requests agree"


@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_reused_slots_match_solo_runs(models, cfg, use_kernel):
    """Continuous batching through reused slots gives each request its
    solo tokens, bitwise: the slot's mamba state is zeroed on admission."""
    flags = RunFlags(use_mamba_kernel=use_kernel)
    model = models["bfloat16"]
    solo = _solo(model, cfg, _prompts(), flags=flags)
    for max_batch in (1, MAX_BATCH):
        batched, _ = _serve(model, cfg, _prompts(), max_batch, flags=flags)
        assert batched == solo, {k: (batched[k], solo[k]) for k in solo
                                 if batched[k] != solo[k]}


def test_engine_without_the_reset_carries_stale_state(models, cfg,
                                                      monkeypatch):
    """The reused-slot test has teeth: with the reset on admission
    disabled, a request admitted into a used slot decodes from the last
    request's state and its tokens change."""
    model = models["bfloat16"]
    solo = _solo(model, cfg, _prompts())
    monkeypatch.setattr(model, "reset_state", lambda rows: None)
    batched, _ = _serve(model, cfg, _prompts(), 1)
    assert batched != solo


def test_reference_engine_carries_a_finished_requests_state(reference):
    """The reference fault the port does not copy: its engine prefills B
    in A's slot from the mamba state A left, and B's tokens change."""
    solo = reference[f"solo{STALE[1]}/tokens"].tolist()
    assert solo == SOLO_B_TOKENS
    assert reference["stale/tokens"].tolist() == STALE_TOKENS != solo


def test_engine_token_sync_on_a_2x4_grid(models, cfg):
    """The tick sync changes no token: one plan, a start per tick."""
    model = models["bfloat16"]
    flags = RunFlags(use_mamba_kernel=True, use_flash_decode=True)
    want, _ = _serve(model, cfg, _prompts(), MAX_BATCH, flags=flags)
    runtime.clear_cache()
    runtime.selection_stats().reset()
    got, eng = _serve(model, cfg, _prompts(), MAX_BATCH, flags=flags,
                      mesh=RankGrid(2, 4, device="cpu"))
    assert got == want
    assert runtime.selection_stats().total == 1
    m = eng.metrics()
    assert m["sync_starts"] == m["ticks"] >= NEW - 1
    assert m["plan_rebinds"] == 0


def test_first_five_layers_of_the_full_config():
    """The serving cut of the full config: its first five blocks (mamba
    with FFN, mamba with MoE, twice, then attention with FFN) at the
    published widths."""
    full = get_config(ARCH)
    cut = first_layers(full, 5)
    assert cut.block_pattern == ("mamba",) * 4 + ("attn",)
    assert [tparams.block_is_moe(cut, j) for j in range(5)] == \
        [False, True, False, True, False]
    assert (cut.d_model, cut.n_heads, cut.n_kv_heads, cut.d_ff,
            cut.moe.d_ff_expert, cut.vocab) == (8192, 64, 8, 24576, 24576,
                                                65536)
    assert tparams.n_params(cut) == 24_045_707_264
    assert cut.n_params() == 24_045_707_264 - 4 * 2 * 16384
    with pytest.raises(ValueError, match="not within one cycle"):
        first_layers(full, 9)


@pytest.mark.cuda
def test_engine_on_the_card_launches_the_kernels_per_layer_and_pass(cfg):
    """Reduced width on the card: every prefill and every decode tick runs
    the scan kernel once per mamba layer, every tick the flash kernel once
    per attention layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    model = DecoderLM(cfg, torch.Generator("cuda").manual_seed(0))
    kmamba.reset_launches()
    kattn.reset_launches()
    _, eng = _serve(model, cfg, _prompts(), MAX_BATCH,
                    flags=RunFlags(use_mamba_kernel=True,
                                   use_flash_decode=True),
                    mesh=RankGrid(2, 4))
    m = eng.metrics()
    assert kmamba.launches["mamba_scan"] == 7 * (m["ticks"]
                                                 + len(PROMPT_LENS))
    assert kattn.launches["flash_decode"] == m["ticks"]


if __name__ == "__main__":
    _reference(sys.argv[1])
