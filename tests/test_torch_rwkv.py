"""The port's rwkv family against the reference's, on the reduced rwkv6
config (2 layers, d_model 128, 4 heads of 32, d_ff 256, vocab 512): the
time- and channel-mixing layers, the ``DecoderLM`` through its caches, and
the serving ``Engine``.

The reference side — this file's ``__main__``, run once per module in a
subprocess — initialises ``repro.models.decoder`` from ``PRNGKey(0)`` and
writes the parameters and every output to an ``.npz``; the port receives
the same parameters through ``interop.params_from_reference``.

  * float32 (the tree cast in both packages): layer outputs and states
    within ``F32_TOL``, logits within ``F32_TOL`` times the largest logit
    (the order of fp32 sums);
  * bfloat16 (the reference's own dtypes): greedy tokens under the top-2
    margin guard of ``tests/test_torch_serve.py`` — at a sequence's first
    differing token the reference's top-2 margin must be under ``2 *
    BF16_TOL * max|logit|``.

The reference takes its WKV kernel only without a carried state
(``repro/layers/rwkv.py:122``), so only the cache-free forward reaches it
(in interpret mode); with a state it runs its plain recurrence. The port
takes its kernel wrapper whenever ``use_rwkv_kernel`` is set, which on the
CPU runs the plain version.

The reference ``Engine`` carries a finished request's recurrent state into
the next request in the same slot; the port's zeroes it on admission. A
request's correct answer is its run alone on a fresh engine, so the port
is held against the reference's solo runs.
"""
import sys

import numpy as np
import pytest
import torch

import torch_family as tf
from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.core import runtime
from repro_torch.core.grid import RankGrid
from repro_torch.kernels import rwkv as krwkv
from repro_torch.models import params as tparams
from repro_torch.models.decoder import DecoderLM, RunFlags
from repro_torch.serve.engine import Engine, Request

ARCH = "rwkv6-1.6b"
B, T, STEPS = 2, 8, 8
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6
MAX_BATCH, MAX_LEN, NEW = 2, 64, 6
PROMPT_LENS = (12, 3, 7, 9, 5)
#: the reference engine serving request 0, then request 3, in one slot
STALE = (0, 3)
#: the reference keeps these leaves float32 in its bf16 tree
F32_LEAVES = ("w0", "w1", "w2", "u")


def _tokens(step):
    rng = np.random.default_rng(20 + step)
    return rng.integers(0, 512, size=(B, T if step < 0 else 1),
                        dtype=np.int32)


def _layer_inputs():
    """x (B, T, D) and a carried state (tm_shift, wkv, cm_shift)."""
    rng = np.random.default_rng(4)
    return (rng.standard_normal((B, T, 128)).astype(np.float32),
            rng.standard_normal((B, 128)).astype(np.float32),
            (rng.standard_normal((B, 4, 32, 32)) * 0.1).astype(np.float32),
            rng.standard_normal((B, 128)).astype(np.float32))


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, size=(n,), dtype=np.int32)
            for n in PROMPT_LENS]






def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.layers import rwkv as jrwkv
    from repro.models import decoder

    cfg = jreduced(ARCH)
    params = decoder.init(jax.random.PRNGKey(0), cfg)
    res = {f"param/{'/'.join(str(k.key) for k in path)}":
           np.asarray(leaf, np.float32)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)

    # layers: cycle 0's time and channel mixing, fresh and carried state
    x, tm_shift, wkv, cm_shift = (jnp.asarray(a) for a in _layer_inputs())
    blk = jax.tree.map(lambda a: a[0], f32["groups"]["blk0"]["tm_cm"])
    for name, st in (("fresh", (None, None, None)),
                     ("carried", (tm_shift, wkv, cm_shift))):
        out, shift, sT = jrwkv.time_mix(blk["tm"], x, cfg, state_shift=st[0],
                                        state_wkv=st[1])
        res[f"tm_{name}/out"], res[f"tm_{name}/shift"] = (np.asarray(out),
                                                          np.asarray(shift))
        res[f"tm_{name}/wkv"] = np.asarray(sT)
        out, shift = jrwkv.channel_mix(blk["cm"], x, cfg, state_shift=st[2])
        res[f"cm_{name}/out"], res[f"cm_{name}/shift"] = (np.asarray(out),
                                                          np.asarray(shift))

    # the model in float32: prefill, then teacher-forced decode steps
    caches = jax.tree.map(lambda a: a.astype(jnp.float32),
                          decoder.init_cache(cfg, B, MAX_LEN))
    flags = decoder.RunFlags(logits_dtype="float32")
    logits, _, caches = decoder.forward(f32, jnp.asarray(_tokens(-1)), cfg,
                                        flags=flags, caches=caches)
    res["f32/prefill"] = np.asarray(logits)
    for step in range(STEPS):
        logits, _, caches = decoder.forward(
            f32, jnp.asarray(_tokens(step)), cfg, flags=flags, caches=caches,
            cache_index=jnp.int32(T + step))
        res[f"f32/step{step}"] = np.asarray(logits)
    # without caches the reference reaches its Pallas kernel
    kflags = decoder.RunFlags(logits_dtype="float32", use_rwkv_kernel=True)
    res["f32/nocache_kernel"] = np.asarray(decoder.forward(
        f32, jnp.asarray(_tokens(-1)), cfg, flags=kflags)[0])

    # bfloat16: greedy decoding with the top-2 margins of every pick
    caches = decoder.init_cache(cfg, B, MAX_LEN)
    logits, _, caches = decoder.forward(params, jnp.asarray(_tokens(-1)),
                                        cfg, caches=caches)
    last = np.asarray(logits[:, -1].astype(jnp.float32))
    toks, margins = [last.argmax(-1)], [[tf.top2(row) for row in last]]
    for step in range(STEPS):
        logits, _, caches = decoder.forward(
            params, jnp.asarray(toks[-1][:, None].astype(np.int32)), cfg,
            caches=caches, cache_index=jnp.int32(T + step))
        last = np.asarray(logits[:, 0].astype(jnp.float32))
        toks.append(last.argmax(-1))
        margins.append([tf.top2(row) for row in last])
    res["bf16/greedy"] = np.stack(toks, 1)
    res["bf16/margins"] = np.array(margins, np.float64).transpose(1, 0, 2)

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
    return tf.reference_npz(__file__, tmp_path_factory, "rwkv_ref")


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
@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_matches_reference(reference, models, carried, use_kernel):
    tm = models["float32"].blocks[0].tm_cm["tm"]
    x, tm_shift, wkv, cm_shift = (torch.from_numpy(a)
                                  for a in _layer_inputs())
    state = {"tm_shift": tm_shift, "wkv": wkv, "cm_shift": cm_shift} \
        if carried else None
    name = "carried" if carried else "fresh"
    out = tm(x, state, use_kernel=use_kernel)
    tf.close(out, reference[f"tm_{name}/out"], F32_TOL, "out")
    if carried:
        tf.close(state["tm_shift"], reference[f"tm_{name}/shift"], 0, "shift")
        tf.close(state["wkv"], reference[f"tm_{name}/wkv"], F32_TOL, "wkv")
        assert torch.equal(state["cm_shift"],
                           torch.from_numpy(_layer_inputs()[3]))


@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches_reference(reference, models, carried):
    cm = models["float32"].blocks[0].tm_cm["cm"]
    x, _, _, cm_shift = (torch.from_numpy(a) for a in _layer_inputs())
    state = {"cm_shift": cm_shift} if carried else None
    name = "carried" if carried else "fresh"
    tf.close(cm(x, state), reference[f"cm_{name}/out"], F32_TOL, "out")
    if carried:
        tf.close(state["cm_shift"], reference[f"cm_{name}/shift"], 0, "shift")


def test_time_mix_refuses_tf32_on_the_card(models, monkeypatch):
    """The decay's projection is a float32 product: a CUDA input under
    TF32 matmuls raises before any work (the card is stood in for by a
    tensor reporting CUDA; nothing runs there)."""
    tm = models["float32"].blocks[0].tm_cm["tm"]

    class OnTheCard(torch.Tensor):
        is_cuda = True

    x = torch.zeros((1, 2, 128)).as_subclass(OnTheCard)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32 must be False"):
        tm(x)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_params_from_reference_carries_the_rwkv_tree(reference, models,
                                                     cfg):
    model = models["bfloat16"]
    n = sum(p.numel() for p in model.parameters())
    ref_n = sum(a.size for k, a in reference.items()
                if k.startswith("param/"))
    assert n == ref_n == tparams.n_params(cfg)
    u = reference["param/groups/blk0/tm_cm/tm/u"]
    for layer in range(cfg.n_layers):
        tm = model.blocks[layer].tm_cm["tm"]
        assert torch.equal(tm.u, torch.from_numpy(u[layer]))
        assert tm.w1.dtype == tm.u.dtype == torch.float32
        assert tm.wr.dtype == tm.ln_x.scale.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in model.parameters())


def test_param_shapes_follow_the_reference_tree(reference, cfg):
    want = [(k[len("param/"):], reference[k].shape)
            for k in reference if k.startswith("param/")]
    assert tparams.param_shapes(cfg) == want


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_reference(reference, models, use_kernel):
    """Prefill logits, then eight decode steps through the caches, in
    float32."""
    model = models["float32"]
    caches = model.init_cache(B, MAX_LEN, dtype=torch.float32)
    assert [sorted(c) for c in caches] == [["cm_shift", "tm_shift", "wkv"]] \
        * 2
    flags = RunFlags(use_rwkv_kernel=use_kernel, logits_dtype="float32")
    logits, aux, caches = model(torch.from_numpy(_tokens(-1)), caches,
                                flags=flags)
    assert float(aux) == 0.0
    tf.relative(logits, reference["f32/prefill"], F32_TOL, "prefill")
    for step in range(STEPS):
        logits, _, caches = model(torch.from_numpy(_tokens(step)), caches,
                                  T + step, flags=flags)
        assert logits.shape == (B, 1, 512)
        tf.relative(logits, reference[f"f32/step{step}"], F32_TOL,
                    f"step {step}")


def test_forward_without_caches_matches_reference_kernel(reference, models):
    """Without caches the reference runs its Pallas kernel (interpret
    mode)."""
    flags = RunFlags(use_rwkv_kernel=True, logits_dtype="float32")
    logits, _, caches = models["float32"](torch.from_numpy(_tokens(-1)),
                                          flags=flags)
    assert caches is None
    tf.relative(logits, reference["f32/nocache_kernel"], F32_TOL, "forward")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_bf16_greedy_tokens_match_reference(reference, models, use_kernel):
    model = models["bfloat16"]
    caches = model.init_cache(B, MAX_LEN)
    flags = RunFlags(use_rwkv_kernel=use_kernel)
    logits, _, caches = model(torch.from_numpy(_tokens(-1)), caches,
                              flags=flags)
    toks = [logits[:, -1].argmax(-1)]
    for step in range(STEPS):
        logits, _, caches = model(toks[-1][:, None], caches, T + step,
                                  flags=flags)
        toks.append(logits[:, 0].argmax(-1))
    got = torch.stack(toks, 1).tolist()
    want = reference["bf16/greedy"].tolist()
    same = sum(tf.guard(g, w, m, BF16_TOL, f"row {b}")
               for b, (g, w, m) in enumerate(
                   zip(got, want, reference["bf16/margins"])))
    assert same >= B - 1, f"only {same} rows agree"


def test_reset_state_zeroes_recurrent_state_only(models, cfg):
    model = models["float32"]
    caches = model.init_cache(2, 8)
    for c in caches:
        for t in c.values():
            t.fill_(1.0)
    model.reset_state([{n: t[1:] for n, t in c.items()} for c in caches])
    for c in caches:
        for t in c.values():
            assert bool((t[0] == 1).all()) and bool((t[1] == 0).all())


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
    """Five requests through two reused slots give, request by request,
    the reference engine's tokens for that request alone on a fresh
    engine, up to the bf16 guard."""
    flags = RunFlags(use_rwkv_kernel=use_kernel)
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
    solo tokens, bitwise: the slot's recurrent state is zeroed on
    admission."""
    flags = RunFlags(use_rwkv_kernel=use_kernel)
    model = models["bfloat16"]
    solo = _solo(model, cfg, _prompts(), flags=flags)
    batched, _ = _serve(model, cfg, _prompts(), MAX_BATCH, flags=flags)
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
    batched, _ = _serve(model, cfg, _prompts(), MAX_BATCH)
    assert batched != solo


def test_reference_engine_carries_a_finished_requests_state(reference):
    """The reference fault the port does not copy: its engine prefills a
    slot from the state the slot's last request left."""
    solo = reference[f"solo{STALE[1]}/tokens"].tolist()
    assert reference["stale/tokens"].tolist() != solo


def test_engine_token_sync_on_a_2x4_grid(models, cfg):
    """The tick sync changes no token: one plan, a start per tick."""
    model = models["bfloat16"]
    flags = RunFlags(use_rwkv_kernel=True)
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


@pytest.mark.cuda
def test_engine_on_the_card_launches_the_kernel_per_layer_and_pass(cfg):
    """Reduced width on the card: every prefill and every decode tick runs
    the kernel once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    model = DecoderLM(cfg, torch.Generator("cuda").manual_seed(0))
    krwkv.reset_launches()
    _, eng = _serve(model, cfg, _prompts(), MAX_BATCH,
                    flags=RunFlags(use_rwkv_kernel=True),
                    mesh=RankGrid(2, 4))
    m = eng.metrics()
    assert krwkv.launches["rwkv6_wkv"] == cfg.n_layers * (
        m["ticks"] + len(PROMPT_LENS))


if __name__ == "__main__":
    _reference(sys.argv[1])
