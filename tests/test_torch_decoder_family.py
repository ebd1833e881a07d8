"""The decoder configs the last slice registers, against the reference:
the reduced qwen2-vl-72b (M-RoPE, stub patch embeddings put before the
tokens; 4 heads of 32 over 2 KV heads) and the reduced dense configs
yi-34b (4 heads padded to 16 over 2 KV heads: G 8, of which 6 zero
heads a group), qwen1.5-4b (MHA with QKV biases) and phi3-medium-14b
(GQA); each 2 layers, d_model 128, d_ff 256, vocab 512.

The reference side — this file's ``__main__``, run once per module in a
subprocess — draws each model's weights from numpy
(``torch_family.draw_params``; yi's pad heads zeroed as the reference's
``init`` zeroes them), compiles its programs at XLA's lowest backend
level (``torch_family.fast_compile``) and writes every output to an
``.npz``; the port receives the same weights through
``interop.params_from_reference``.

  * ``mrope_cos_sin`` at random ``positions3`` whose three streams differ
    (head dims 32 and 128) within ``TRIG_TOL`` of the reference (the two
    libraries' float32 cosines differ in the last bit), each frequency
    slot bitwise ``rope_cos_sin`` of its section's stream; with equal
    streams it is ``rope_cos_sin``, bitwise (text positions alone cannot
    tell a wrong section map);
  * float32 (the tree cast in both packages), within ``F32_TOL`` times the
    largest logit: qwen2-vl's ``forward(tokens, embeds=, positions3=)``
    with 16 patch embeddings on a (1, 4, 4) (t, h, w) grid before 16 text
    tokens, without caches, then as a prefill with caches followed by 6
    decode ticks at a per-row ``(B,)`` index; the dense configs' logits
    through their caches (a prefill, then ticks); with and without the
    flash-decode wrapper (its plain version on the CPU);
  * qwen2-vl's ``loss_fn`` with ``embeds`` (the loss over the token tail)
    and its gradients (each leaf within ``GRAD_TOL`` of its largest
    ``|g|``);
  * bfloat16 (the reference's own dtypes): qwen2-vl's ``Engine`` greedy
    tokens against the reference ``Engine``'s solo runs under the top-2
    margin guard of ``tests/torch_family.py``;
  * the configs field by field, the parameter counts, and every one of
    the reference's ten configs built at reduced size on ``"meta"``.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import torch_family as tf
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.layers import common
from repro_torch.models import params as tparams
from repro_torch.models.decoder import DecoderLM, RunFlags
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.params import FlatParams
from repro_torch.serve.engine import Engine, Request
from repro_torch.train.step import TrainConfig, value_and_grad

VL = "qwen2-vl-72b"
DENSE = ("yi-34b", "qwen1.5-4b", "phi3-medium-14b")
ARCHS = (VL,) + DENSE
B, T = 2, 8
#: qwen2-vl: 16 patches on a (1, 4, 4) grid, then 16 text tokens
GRID_THW = (1, 4, 4)
N_PATCH, N_TEXT = 16, 16
VL_TICKS = 6
#: per-row decode offsets of the VL ticks, after the 32-position prefill
VL_INDEX = (32, 29)
STEPS = 4
MAX_LEN, NEW = 64, 6
PROMPT_LENS = (11, 6)
F32_TOL = 1e-4
GRAD_TOL = 1e-4
BF16_TOL = 2.0 ** -6
TRIG_TOL = 1e-6
#: (head_dim, theta) of the M-RoPE checks: reduced and full qwen2-vl
MROPE_CASES = ((32, 10000.0), (128, 1e6))


def _mrope_positions(seed, b=2, t=10):
    return np.random.default_rng(seed).integers(0, 64, (b, 3, t)).astype(
        np.int32)


def _vl_positions3():
    """The patches' (t, h, w) on the grid, then the text at the next
    position on all three streams (Qwen2-VL's layout), for every row."""
    nt, nh, nw = GRID_THW
    t, h, w = np.meshgrid(np.arange(nt), np.arange(nh), np.arange(nw),
                          indexing="ij")
    img = np.stack([t.reshape(-1), h.reshape(-1), w.reshape(-1)])
    text = img.max() + 1 + np.arange(N_TEXT)
    p3 = np.concatenate([img, np.stack([text] * 3)], axis=1)
    return np.broadcast_to(p3, (B, 3, N_PATCH + N_TEXT)).astype(
        np.int32).copy()


def _embeds():
    return np.random.default_rng(20).standard_normal(
        (B, N_PATCH, 128)).astype(np.float32)


def _tokens(step, n=T, seed=40):
    rng = np.random.default_rng(seed + step)
    return rng.integers(0, 512, size=(B, n if step < 0 else 1),
                        dtype=np.int32)


def _vl_batch():
    rng = np.random.default_rng(50)
    labels = rng.integers(0, 512, (B, N_TEXT)).astype(np.int32)
    labels[1, :2] = -1
    return {"tokens": rng.integers(0, 512, (B, N_TEXT)).astype(np.int32),
            "labels": labels, "embeds": _embeds()}


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, size=(n,), dtype=np.int32)
            for n in PROMPT_LENS]


def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.layers import common as jcommon
    from repro.models import decoder
    from repro.train import step as jstep

    res = {}
    for hd, theta in MROPE_CASES:
        p3 = jnp.asarray(_mrope_positions(hd))
        half = hd // 2
        cos, sin = jcommon.mrope_cos_sin(
            p3, hd, theta, (half // 4, half * 3 // 8, half * 3 // 8))
        res[f"mrope/{hd}/cos"], res[f"mrope/{hd}/sin"] = (np.asarray(cos),
                                                          np.asarray(sin))
    flags = decoder.RunFlags(logits_dtype="float32", remat="none")
    for arch in ARCHS:
        full, cfg = jget(arch), jreduced(arch)
        res[f"{arch}/config/full"] = json.dumps(dataclasses.asdict(full))
        res[f"{arch}/config/reduced"] = json.dumps(dataclasses.asdict(cfg))
        res[f"{arch}/n_params/full"] = np.int64(full.n_params())
        res[f"{arch}/n_params/reduced"] = np.int64(cfg.n_params())
        drawn = tf.draw_params(jax.eval_shape(
            lambda k: decoder.init(k, cfg), jax.random.PRNGKey(0)))
        if cfg.padded_heads != cfg.n_heads:
            # the pad heads, at the tail of each kv group, are zero
            attn = drawn["groups"]["blk0"]["attn"]
            G, Gp = cfg.n_heads // cfg.n_kv_heads, \
                cfg.padded_heads // cfg.n_kv_heads
            live = (np.arange(cfg.padded_heads * cfg.head_dim)
                    // cfg.head_dim) % Gp < G
            attn["wq"] = attn["wq"] * live[None, None, :].astype(
                attn["wq"].dtype)
            attn["wo"] = attn["wo"] * live[None, :, None].astype(
                attn["wo"].dtype)
        for path, leaf in tf.flatten(drawn):
            res[f"{arch}/param/{path}"] = np.asarray(leaf, np.float32)
        f32 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                           drawn)
        caches = jax.tree.map(lambda a: a.astype(jnp.float32),
                              decoder.init_cache(cfg, B, MAX_LEN))

        def tick(p, t, c, i):
            return decoder.forward(p, t, cfg, flags=flags, caches=c,
                                   cache_index=i)[::2]
        if arch != VL:
            toks = jnp.asarray(_tokens(-1))
            logits, caches = tf.fast_compile(
                lambda p, t, c: decoder.forward(p, t, cfg, flags=flags,
                                                caches=c)[::2],
                f32, toks, caches)(f32, toks, caches)
            res[f"{arch}/prefill"] = np.asarray(logits)
            step_fn = None
            for step in range(STEPS):
                toks, idx = jnp.asarray(_tokens(step)), jnp.int32(T + step)
                if step_fn is None:
                    step_fn = tf.fast_compile(tick, f32, toks, caches, idx)
                logits, caches = step_fn(f32, toks, caches, idx)
                res[f"{arch}/step{step}"] = np.asarray(logits)
            continue

        # qwen2-vl: patches before the text, with and without caches
        toks = jnp.asarray(_tokens(-1, N_TEXT, seed=30))
        emb, p3 = jnp.asarray(_embeds()), jnp.asarray(_vl_positions3())

        def vl(p, t, e, q3, c):
            return decoder.forward(p, t, cfg, flags=flags, embeds=e,
                                   positions3=q3, caches=c)[::2]
        res[f"{arch}/forward"] = np.asarray(tf.fast_compile(
            lambda p, t, e, q3: vl(p, t, e, q3, None)[0], f32, toks, emb,
            p3)(f32, toks, emb, p3))
        logits, caches = tf.fast_compile(vl, f32, toks, emb, p3, caches)(
            f32, toks, emb, p3, caches)
        res[f"{arch}/prefill"] = np.asarray(logits)
        step_fn = None
        for step in range(VL_TICKS):
            toks = jnp.asarray(_tokens(step, seed=35))
            idx = jnp.asarray(np.array(VL_INDEX, np.int32) + step)
            if step_fn is None:
                step_fn = tf.fast_compile(tick, f32, toks, caches, idx)
            logits, caches = step_fn(f32, toks, caches, idx)
            res[f"{arch}/step{step}"] = np.asarray(logits)
        # the loss over the token tail, and its gradients
        tcfg = jstep.TrainConfig(flags=flags)
        batch = {k: jnp.asarray(v) for k, v in _vl_batch().items()}
        loss, grads = tf.fast_compile(jax.value_and_grad(
            lambda p, b_: jstep.loss_fn(p, b_, cfg, tcfg)[0]), f32, batch)(
            f32, batch)
        res[f"{arch}/loss"] = np.asarray(loss)
        for path, g in tf.flatten(jax.device_get(grads)):
            res[f"{arch}/grad/{path}"] = np.asarray(g, np.float32)
        # the Engine: each request alone on a fresh engine
        bf16 = jax.tree.map(jnp.asarray, drawn)
        for i, p in enumerate(_prompts()):
            (res[f"{arch}/solo{i}/tokens"], res[f"{arch}/solo{i}/margins"]), \
                = tf.ref_serve(bf16, cfg, [p], 1, MAX_LEN, NEW)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tf.reference_npz(__file__, tmp_path_factory, "decoder_family_ref")


def _of(reference, arch):
    return {k[len(arch) + 1:]: v for k, v in reference.items()
            if k.startswith(arch + "/")}


@pytest.fixture(scope="module")
def models(reference):
    return {(arch, dt): interop.params_from_reference(
                tf.tree(_of(reference, arch), dt, ()), reduced_config(arch),
                device="cpu")
            for arch in ARCHS for dt in ("float32", "bfloat16")}


def _long(a):
    return torch.from_numpy(np.asarray(a)).long()


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,theta", MROPE_CASES)
def test_mrope_matches_reference_on_distinct_streams(reference, hd, theta):
    p3 = torch.from_numpy(_mrope_positions(hd))
    assert len({tuple(p3[0, s].tolist()) for s in range(3)}) == 3
    sections = common.mrope_sections(hd)
    cos, sin = common.mrope_cos_sin(p3, hd, theta, sections)
    for got, name in ((cos, "cos"), (sin, "sin")):
        np.testing.assert_allclose(got.numpy(),
                                   reference[f"mrope/{hd}/{name}"],
                                   rtol=0, atol=TRIG_TOL, err_msg=name)
    # slot f of section s: stream s's plain rotary angle, bit for bit
    lo = 0
    for stream, n in enumerate(sections):
        want = common.rope_cos_sin(p3[:, stream], hd, theta)
        assert torch.equal(cos[..., lo:lo + n], want[0][..., lo:lo + n])
        assert torch.equal(sin[..., lo:lo + n], want[1][..., lo:lo + n])
        lo += n


@pytest.mark.parametrize("hd,theta", MROPE_CASES)
def test_mrope_of_equal_streams_is_rope(hd, theta):
    pos = torch.from_numpy(_mrope_positions(hd)[:, 0])
    got = common.mrope_cos_sin(common.text_positions3(pos), hd, theta,
                               common.mrope_sections(hd))
    want = common.rope_cos_sin(pos, hd, theta)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_mrope_sections():
    assert common.mrope_sections(128) == (16, 24, 24)
    assert common.mrope_sections(32) == (4, 6, 6)
    with pytest.raises(ValueError, match="do not fill"):
        common.mrope_cos_sin(torch.zeros(1, 3, 2, dtype=torch.long), 32,
                             1e4, (4, 6, 5))


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(reference, arch):
    ref = _of(reference, arch)
    for kind, cfg in (("full", get_config(arch)),
                      ("reduced", reduced_config(arch))):
        want = json.loads(str(ref[f"config/{kind}"]))
        assert json.loads(json.dumps(dataclasses.asdict(cfg))) == want, kind
        assert cfg.n_params() == int(ref[f"n_params/{kind}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_follow_the_reference_tree(reference, arch, models):
    """``params.n_params`` counts the reference tree's leaves; the config's
    formula counts ``n_heads``, not yi's padded heads."""
    ref = _of(reference, arch)
    for cfg in (reduced_config(arch), get_config(arch)):
        pad = cfg.n_layers * 2 * cfg.d_model * cfg.head_dim * \
            (cfg.padded_heads - cfg.n_heads)
        assert tparams.n_params(cfg) == cfg.n_params() + pad
    cfg = reduced_config(arch)
    assert [(k[len("param/"):], a.shape) for k, a in ref.items()
            if k.startswith("param/")] == tparams.param_shapes(cfg)
    assert sum(p.numel() for p in models[arch, "float32"].parameters()) == \
        tparams.n_params(cfg)


def test_full_sizes():
    """The published widths and the parameter counts at full size."""
    counts = {"qwen2-vl-72b": 72_705_384_448, "yi-34b": 35_269_721_088,
              "qwen1.5-4b": 3_950_369_280, "phi3-medium-14b": 14_659_507_200}
    for arch, n in counts.items():
        assert tparams.n_params(get_config(arch)) == n, arch
    vl = get_config(VL)
    assert (vl.rope, vl.input_mode, vl.head_dim,
            common.mrope_sections(vl.head_dim)) == ("mrope", "vl", 128,
                                                    (16, 24, 24))
    yi = get_config("yi-34b")
    assert (yi.padded_heads, yi.n_kv_heads, yi.head_dim) == (64, 8, 128)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_at_reduced_size_on_meta(arch):
    cfg = reduced_config(arch)
    model = (EncDecLM if cfg.family == "encdec" else DecoderLM)(
        cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        tparams.n_params(cfg)
    assert {p.device.type for p in model.parameters()} == {"meta"}


# ---------------------------------------------------------------------------
# qwen2-vl
# ---------------------------------------------------------------------------


def test_vl_forward_with_patches_matches_reference(reference, models):
    model = models[VL, "float32"]
    flags = RunFlags(logits_dtype="float32", remat="none")
    with torch.no_grad():
        logits, _, caches = model(
            _long(_tokens(-1, N_TEXT, seed=30)), flags=flags,
            embeds=torch.from_numpy(_embeds()),
            positions3=_long(_vl_positions3()))
    assert caches is None
    assert logits.shape == (B, N_PATCH + N_TEXT, 512)
    tf.relative(logits, _of(reference, VL)["forward"], F32_TOL, "logits")


@pytest.mark.parametrize("use_flash_decode", [False, True])
def test_vl_prefill_and_per_row_ticks_match_reference(reference, models,
                                                      use_flash_decode):
    ref = _of(reference, VL)
    model = models[VL, "float32"]
    flags = RunFlags(logits_dtype="float32",
                     use_flash_decode=use_flash_decode)
    caches = model.init_cache(B, MAX_LEN, dtype=torch.float32)
    with torch.no_grad():
        logits, _, _ = model(_long(_tokens(-1, N_TEXT, seed=30)), caches,
                             flags=flags, embeds=torch.from_numpy(_embeds()),
                             positions3=_long(_vl_positions3()))
        tf.relative(logits, ref["prefill"], F32_TOL, "prefill")
        for step in range(VL_TICKS):
            idx = torch.tensor(VL_INDEX) + step
            logits, _, _ = model(_long(_tokens(step, seed=35)), caches, idx,
                                 flags=flags)
            tf.relative(logits, ref[f"step{step}"], F32_TOL, f"step {step}")


def test_vl_text_positions_follow_the_cache_index(models):
    """Without ``positions3`` the M-RoPE positions are three equal text
    streams from each row's own cache index, as the reference gives
    them."""
    model = models[VL, "float32"]
    flags = RunFlags(logits_dtype="float32")
    toks = _long(_tokens(0))
    idx = torch.tensor(VL_INDEX)
    got, want = [], []
    for p3, out in ((None, got), (common.text_positions3(idx[:, None]),
                                  want)):
        caches = model.init_cache(B, MAX_LEN, dtype=torch.float32)
        with torch.no_grad():
            out.append(model(toks, caches, idx, flags=flags,
                             positions3=p3)[0])
    assert torch.equal(got[0], want[0])


def test_vl_loss_and_gradients_with_embeds_match_reference(reference):
    """The loss over the token tail only (the patches are inputs)."""
    ref = _of(reference, VL)
    model = interop.params_from_reference(
        tf.tree(ref, "float32", ()), reduced_config(VL),
        device="cpu").trainable()
    flat = FlatParams.of(model)
    batch = {k: torch.from_numpy(v) for k, v in _vl_batch().items()}
    batch["tokens"], batch["labels"] = (batch["tokens"].long(),
                                        batch["labels"].long())
    tcfg = TrainConfig(flags=RunFlags(logits_dtype="float32", remat="none"))
    loss, mets, grads = value_and_grad(model, flat, batch, tcfg)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)
    assert int(mets["tokens"]) == B * N_TEXT - 2
    buf = flat.gather(grads)
    for path, start, end, _ in flat.spans:
        want = ref[f"grad/{path}"]
        tf.relative(buf[start:end].reshape(want.shape), want, GRAD_TOL, path)


@pytest.mark.parametrize("use_flash_decode", [False, True])
def test_vl_engine_matches_reference_solo_runs(reference, models,
                                               use_flash_decode):
    """Both requests through two slots give, request by request, the
    reference engine's tokens for that request alone, up to the bf16
    guard."""
    ref = _of(reference, VL)
    eng = Engine(models[VL, "bfloat16"], reduced_config(VL), max_batch=2,
                 max_len=MAX_LEN,
                 flags=RunFlags(use_flash_decode=use_flash_decode))
    done = eng.run([Request(prompt=p.copy(), max_new_tokens=NEW)
                    for p in _prompts()])
    got = {tuple(r.prompt.tolist()): r.out_tokens for r in done}
    same = 0
    for i, p in enumerate(_prompts()):
        toks = got[tuple(p.tolist())]
        want = ref[f"solo{i}/tokens"].tolist()
        assert len(toks) == len(want) == NEW
        same += tf.guard(toks, want, ref[f"solo{i}/margins"], BF16_TOL,
                         f"request {i}")
    assert same >= len(PROMPT_LENS) - 1, f"only {same} requests agree"


# ---------------------------------------------------------------------------
# the dense configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_flash_decode", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_logits_through_caches_match_reference(reference, models, arch,
                                                     use_flash_decode):
    ref = _of(reference, arch)
    model = models[arch, "float32"]
    flags = RunFlags(logits_dtype="float32",
                     use_flash_decode=use_flash_decode)
    caches = model.init_cache(B, MAX_LEN, dtype=torch.float32)
    with torch.no_grad():
        logits, _, _ = model(_long(_tokens(-1)), caches, flags=flags)
        tf.relative(logits, ref["prefill"], F32_TOL, "prefill")
        for step in range(STEPS):
            logits, _, _ = model(_long(_tokens(step)), caches,
                                 torch.tensor(T + step), flags=flags)
            tf.relative(logits, ref[f"step{step}"], F32_TOL, f"step {step}")


def test_dense_configs_carry_their_features(models):
    """yi's pad heads are zero in the carried weights (G 8 over 2 KV
    heads, 2 live heads a group); qwen1.5 has QKV biases; phi3 has
    none."""
    yi = models["yi-34b", "float32"].blocks[0].attn
    cfg = reduced_config("yi-34b")
    assert (cfg.padded_heads, cfg.n_kv_heads) == (16, 2)
    wq = yi.wq.reshape(cfg.d_model, cfg.n_kv_heads, 8, cfg.head_dim)
    assert not bool(wq[:, :, 2:].any()) and bool(wq[:, :, :2].any())
    assert hasattr(models["qwen1.5-4b", "float32"].blocks[0].attn, "bq")
    assert not hasattr(models["phi3-medium-14b", "float32"].blocks[0].attn,
                       "bq")


if __name__ == "__main__":
    _reference(sys.argv[1])
