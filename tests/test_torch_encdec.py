"""The port's encoder-decoder (``models/encdec.py``) against the
reference's, on the reduced seamless-m4t-large-v2: 2 encoder and 2
decoder layers, d_model 128, 4 heads of 32 (MHA), d_ff 256, vocab 512, no
rotary embedding; frames ``(2, 24, 128)`` (cast to bf16 by ``encode``, as
the reference casts them) and tokens ``(2, 16)``.

The reference side — this file's ``__main__``, run once per module in a
subprocess with 4 forced host devices — draws the weights from numpy
(``torch_family.draw_params``), compiles its programs at XLA's lowest
backend level (``torch_family.fast_compile``) and writes every output to
an ``.npz``; the port receives the same weights through
``interop.params_from_reference``. Everything runs in float32 (the tree
cast in both packages), each result within ``F32_TOL`` times its largest
``|value|``, unless stated otherwise:

  * attention: ``"bidir"`` (also with RoPE) and ``"cross"`` (S != T)
    through ``Attention.forward`` against ``attention.apply``, and both
    past the streaming threshold (cross T 2048 over S 4096, bidir T
    3072, batch 1), where the port must take ``attend_streaming``;
  * the model: ``encode`` in bf16 (``BF16_TOL``), ``cross_cache``,
    ``decode_forward``'s causal
    pass (the logits), 8 decode ticks with caches at a scalar index with
    ``use_flash_decode`` off and on (the reference's Pallas kernel in
    interpret mode; the port's plain version on the CPU);
  * training: ``loss_fn`` and its gradients (each leaf against its
    largest ``|g|``) against ``jax.value_and_grad``, remat off and on;
    ``train_step`` over 4 microbatches and one fused lossless
    ``pip_mcoll`` manual step on a 2x2 grid against the reference's
    ``make_manual_train_step`` on a 2x2 mesh (loss, and AdamW's first
    moment leaf by leaf). The reference's ``encode`` runs on bf16 encoder
    layers only (its scan carries the frames' bf16), so these run on bf16
    encoder weights at ``MIXED_*`` bars, and the decoder's loss and
    gradients (the encoder output's too) are held apart in float32 at
    ``LOSS_RTOL`` and ``GRAD_TOL``;
  * the parameter counts and the carried weights, bitwise.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import torch_family as tf
from repro_torch import interop
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.grid import RankGrid
from repro_torch.layers import attention
from repro_torch.models import params as tparams
from repro_torch.models.decoder import RunFlags
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.train import manual_step as ms
from repro_torch.train.step import (TrainConfig, cross_entropy, loss_fn,
                                    train_step, value_and_grad)

ARCH = "seamless-m4t-large-v2"
B, S_ENC, T = 2, 24, 16
D = 128
MAX_LEN, TICKS = 64, 8
#: past the streaming threshold (T*S > 2048**2): mode -> (B, T, S)
STREAM = {"cross": (1, 2048, 4096), "bidir": (1, 3072, 3072)}
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
#: through the bf16 encoder (the reference's ``encode`` runs on bf16 layers
#: only): the two packages' encoder outputs differ by about one bf16 ulp of
#: the largest value (measured 0.0087 of it), which moves the loss by about
#: 1e-4 of itself and the gradients by up to 0.014 of a leaf's largest
#: ``|g|`` (the encoder's own leaves are bf16)
MIXED_LOSS_RTOL = 1e-3
MIXED_GRAD_TOL = 2.0 ** -5
#: the manual step's 2x2 grid: one sequence a rank
GRID = (2, 2)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10, schedule="constant",
           grad_clip=1e9)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed, b=B, t=T):
    return np.random.default_rng(seed).integers(0, 512, (b, t)).astype(
        np.int32)


def _batch(b=B):
    labels = _tokens(71, b)
    labels[0, :3] = -1
    return {"frames": _normal(70, b, S_ENC, D), "tokens": _tokens(72, b),
            "labels": labels}


def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.core.topology import Topology
    from repro.layers import attention as jattn
    from repro.models import encdec
    from repro.models.decoder import RunFlags as JFlags
    from repro.optim import adamw as jadamw
    from repro.train import manual_step as jms
    from repro.train import step as jstep

    res = {}
    full, cfg = jget(ARCH), jreduced(ARCH)
    res["config/full"] = json.dumps(dataclasses.asdict(full))
    res["config/reduced"] = json.dumps(dataclasses.asdict(cfg))
    res["n_params/full"] = np.int64(full.n_params())
    res["n_params/reduced"] = np.int64(cfg.n_params())
    drawn = tf.draw_params(jax.eval_shape(
        lambda k: encdec.init(k, cfg), jax.random.PRNGKey(0)))
    for path, leaf in tf.flatten(drawn):
        res[f"param/{path}"] = np.asarray(leaf, np.float32)
    f32 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                       drawn)
    bf16 = jax.tree.map(jnp.asarray, drawn)
    mixed = dict(f32, enc=bf16["enc"])
    flags = JFlags(logits_dtype="float32", remat="none")

    # attention on decoder layer 0's weights: bidir (and with RoPE), cross
    layer = jax.tree.map(lambda a: a[0], f32["dec"])
    rope = dataclasses.replace(cfg, rope="rope")
    x, kv = _normal(1, B, T, D), _normal(2, B, S_ENC, D)

    def modes(p, x_, kv_):
        return {"bidir": jattn.apply(p["attn"], x_, cfg, mode="bidir")[0],
                "bidir_rope": jattn.apply(p["attn"], x_, rope,
                                          mode="bidir")[0],
                "cross": jattn.apply(p["xattn"], x_, cfg, mode="cross",
                                     kv_source=kv_)[0]}
    for mode, y in tf.fast_compile(modes, layer, x, kv)(layer, x,
                                                         kv).items():
        res[f"attn/{mode}"] = np.asarray(y)
    for mode, (b, t, s) in STREAM.items():
        xs, kvs = _normal(3, b, t, D), _normal(4, b, s, D)
        p = layer["xattn" if mode == "cross" else "attn"]
        fn = tf.fast_compile(lambda p_, x_, kv_, mode=mode: jattn.apply(
            p_, x_, cfg, mode=mode, kv_source=kv_)[0], p, xs, kvs)
        res[f"stream/{mode}"] = np.asarray(fn(p, xs, kvs))

    # the model: encode (its scan carries the bf16 frames, so it runs
    # on bf16 encoder weights only), cross K/V, the causal pass and the
    # decode ticks from a float32 encoder output
    frames = jnp.asarray(_normal(5, B, S_ENC, D))
    for tag, p in (("bfloat16", bf16), ("mixed", mixed)):
        res[f"encode/{tag}"] = np.asarray(tf.fast_compile(
            lambda p_, f: encdec.encode(p_, f, cfg), p, frames)(p, frames),
            np.float32)
    enc_out = jnp.asarray(_normal(7, B, S_ENC, D))
    xkv = tf.fast_compile(lambda p, e: encdec.cross_cache(p, e, cfg),
                          f32, enc_out)(f32, enc_out)
    res["xkv/k"], res["xkv/v"] = np.asarray(xkv["k"]), np.asarray(xkv["v"])
    toks = jnp.asarray(_tokens(6))
    res["train_logits"] = np.asarray(tf.fast_compile(
        lambda p, t_, e: encdec.decode_forward(p, t_, e, cfg, flags=flags)[0],
        f32, toks, enc_out)(f32, toks, enc_out))
    for kernel in (False, True):
        kflags = dataclasses.replace(flags, use_flash_decode=kernel)
        caches = jax.tree.map(lambda a: a.astype(jnp.float32),
                              encdec.init_cache(cfg, B, MAX_LEN))
        tick = None
        for i in range(TICKS):
            t_, idx = jnp.asarray(_tokens(10 + i, t=1)), jnp.int32(i)
            if tick is None:
                tick = tf.fast_compile(
                    lambda p, t_, c, i_, x_, kflags=kflags:
                    encdec.decode_forward(p, t_, None, cfg, flags=kflags,
                                          caches=c, cache_index=i_, xkv=x_),
                    f32, t_, caches, idx, xkv)
            logits, caches = tick(f32, t_, caches, idx, xkv)
            res[f"tick{int(kernel)}/{i}"] = np.asarray(logits)

    # training (bf16 encoder weights, the rest float32): loss and
    # gradients, remat off and on, in one program
    ocfg = jadamw.AdamWConfig(**OPT)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def grads(p, b_, p32, e):
        out = {}
        for remat in ("none", "full"):
            tcfg = jstep.TrainConfig(flags=dataclasses.replace(
                flags, remat=remat))
            out[remat] = jax.value_and_grad(
                lambda q: jstep.loss_fn(q, b_, cfg, tcfg)[0])(p)

        def dec_loss(q, e_):  # the decoder alone, float32 throughout
            logits, _ = encdec.decode_forward(q, b_["tokens"], e_, cfg,
                                              flags=flags)
            return jstep.cross_entropy(logits, b_["labels"], 1e-4)[0]
        loss, (g, ge) = jax.value_and_grad(dec_loss, (0, 1))(p32, e)
        out["decoder"] = loss, dict(g, enc_out=ge)
        return out
    for remat, (loss, g) in tf.fast_compile(
            grads, mixed, batch, f32, enc_out)(
            mixed, batch, f32, enc_out).items():
        res[f"loss/{remat}"] = np.asarray(loss)
        for path, a in tf.flatten(jax.device_get(g)):
            res[f"grad/{remat}/{path}"] = np.asarray(a, np.float32)

    # one fused lossless manual step on a 2x2 mesh, a sequence a rank (the
    # mean of the four ranks' gradients: train_step's over 4 microbatches)
    mesh = jax.make_mesh(GRID, ("node", "local"))
    tcfg = jstep.TrainConfig(optimizer=ocfg, flags=flags)
    step = jms.make_manual_train_step(cfg, tcfg, mesh, Topology(*GRID),
                                      algo="pip_mcoll")
    batch = {k: jnp.asarray(v) for k, v in _batch(GRID[0] * GRID[1]).items()}
    opt = jax.jit(lambda p: jadamw.init(p, ocfg))(mixed)
    _, opt2, _, mets = tf.fast_compile(step, mixed, opt, (), batch)(
        mixed, opt, (), batch)
    res["manual/loss"] = np.asarray(mets["loss"])
    for path, m in tf.flatten(jax.device_get(opt2["m"])):
        res[f"manual/m/{path}"] = np.asarray(m, np.float32)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tf.reference_npz(__file__, tmp_path_factory, "encdec_ref",
                            devices=GRID[0] * GRID[1])


def _tree(reference, kind):
    """The reference's weights: ``"float32"``, ``"bfloat16"`` (its own
    dtypes) or ``"mixed"`` (the encoder's layers bf16, the rest float32:
    the reference's ``encode`` scans its carry in the frames' bf16, so it
    runs on bf16 encoder layers only)."""
    if kind != "mixed":
        return tf.tree(reference, kind, ())
    return dict(tf.tree(reference, "float32", ()),
                enc=tf.tree(reference, "bfloat16", ())["enc"])


def _model(reference, kind="float32"):
    return interop.params_from_reference(_tree(reference, kind),
                                         reduced_config(ARCH), device="cpu")


@pytest.fixture(scope="module")
def model(reference):
    """The float32 model on the reference's weights."""
    return _model(reference)


def _fresh(reference):
    """A trainable model on the reference's mixed weights, and its flat
    layout."""
    model = _model(reference, "mixed")
    flat = FlatParams.of(model.trainable())
    return model, flat


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _torch_batch(b=B):
    return {k: _t(v).long() if v.dtype == np.int32 else _t(v)
            for k, v in _batch(b).items()}


F32_FLAGS = RunFlags(logits_dtype="float32", remat="none")


def _leafwise(flat, buf, want, tol, what):
    """Each leaf of the flat ``buf`` within ``tol`` of its largest
    ``|want|`` (``want``: ``{path: array}``)."""
    for path, s, e, _ in flat.spans:
        w = want[path]
        tf.relative(buf[s:e].reshape(w.shape), w, tol, f"{what} {path}")


def _of(reference, prefix):
    return {k[len(prefix) + 1:]: v for k, v in reference.items()
            if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


def test_config_matches_the_reference(reference):
    for kind, cfg in (("full", get_config(ARCH)),
                      ("reduced", reduced_config(ARCH))):
        assert json.loads(json.dumps(dataclasses.asdict(cfg))) == \
            json.loads(str(reference[f"config/{kind}"])), kind
        assert cfg.n_params() == int(reference[f"n_params/{kind}"])
    cfg = reduced_config(ARCH)
    assert (cfg.family, cfg.enc_layers, cfg.n_layers, cfg.d_model,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab,
            cfg.rope, cfg.input_mode) == ("encdec", 2, 2, 128, 4, 4, 32, 512,
                                          "none", "frames")


def test_param_counts_follow_the_reference_tree(reference, model):
    """``params.n_params`` counts the reference ``init``'s leaves, in its
    flatten order. The reference's ``ModelConfig.n_params()`` misses the
    vocab padding of both tables and the encoder's final norm: it is
    short by exactly ``2 * (Vp - V) * D + D`` (103,424 at full size)."""
    cfg = reduced_config(ARCH)
    leaves = [(k[len("param/"):], a.shape) for k, a in reference.items()
              if k.startswith("param/")]
    assert leaves == tparams.param_shapes(cfg)
    assert tparams.n_params(cfg) == sum(
        a.size for k, a in reference.items() if k.startswith("param/"))
    assert sum(p.numel() for p in model.parameters()) == \
        tparams.n_params(cfg)
    for c in (cfg, get_config(ARCH)):
        pad = 2 * (-(-c.vocab // 128) * 128 - c.vocab) * c.d_model
        assert tparams.n_params(c) - c.n_params() == pad + c.d_model
    assert tparams.n_params(get_config(ARCH)) == 2_034_886_656
    assert tparams.n_params(get_config(ARCH)) - \
        get_config(ARCH).n_params() == 103_424


def test_weights_carry_across_bitwise(reference):
    """Every leaf of the reference tree lands in the port's weight that
    ``module_names`` names, bit for bit (bf16, the reference's dtype), and
    comes back out of the flat layout in the reference's order."""
    cfg = reduced_config(ARCH)
    model = interop.params_from_reference(tf.tree(reference, "bfloat16", ()),
                                          cfg, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    flat = FlatParams.of(model)
    got = flat.read().numpy()
    want = np.concatenate([a.reshape(-1) for k, a in reference.items()
                           if k.startswith("param/")])
    assert np.array_equal(got, want)
    assert [p for p, *_ in flat.spans] == [p for p, _ in
                                           tparams.param_shapes(cfg)]
    assert len(model.enc) == cfg.enc_layers and len(model.dec) == \
        cfg.n_layers
    assert not hasattr(model.dec[0].xattn, "bq")


def test_builds_on_meta_and_refuses_a_decoder_config():
    model = EncDecLM(get_config(ARCH), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 2_034_886_656
    with pytest.raises(ValueError, match="DecoderLM"):
        EncDecLM(reduced_config("smollm-360m"), device="meta")


# ---------------------------------------------------------------------------
# attention modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bidir", "bidir_rope", "cross"])
def test_attention_modes_match_reference(reference, model, mode):
    layer = model.dec[0]
    x, kv = _t(_normal(1, B, T, D)), _t(_normal(2, B, S_ENC, D))
    if mode == "cross":
        got, cache = layer.xattn(x, mode="cross", kv_source=kv)
    else:
        attn = layer.attn
        if mode == "bidir_rope":
            cfg = dataclasses.replace(reduced_config(ARCH), rope="rope")
            attn = attention.Attention(cfg, device="meta")
            attn.load_state_dict(layer.attn.state_dict(), assign=True)
        got, cache = attn(x, mode="bidir")
    assert cache is None
    tf.relative(got, reference[f"attn/{mode}"], F32_TOL, mode)


@pytest.mark.parametrize("mode", list(STREAM))
def test_attention_past_the_streaming_threshold(reference, model, mode,
                                                monkeypatch):
    """T*S over 2048**2 (T != S for cross): the port streams, as the
    reference's test on ``q.shape[1] * k.shape[1]`` has it."""
    b, t, s = STREAM[mode]
    calls = []
    stream = attention.attend_streaming

    def counted(q, k, v, causal, **kw):
        calls.append((q.shape[1], k.shape[1], causal))
        return stream(q, k, v, causal, **kw)
    monkeypatch.setattr(attention, "attend_streaming", counted)
    x, kv = _t(_normal(3, b, t, D)), _t(_normal(4, b, s, D))
    layer = model.dec[0]
    with torch.no_grad():
        if mode == "cross":
            got, _ = layer.xattn(x, mode="cross", kv_source=kv)
        else:
            got, _ = layer.attn(x, mode="bidir")
    assert calls == [(t, s, False)]
    tf.relative(got, reference[f"stream/{mode}"], F32_TOL, mode)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bfloat16", "mixed"])
def test_encode_matches_reference(reference, kind):
    """The encoder in bf16 (the frames cast, the layers' weights bf16):
    within ``BF16_TOL`` of the largest ``|value|``; the two packages round
    bf16 at different places (XLA keeps fused elementwise chains in
    float32)."""
    model = _model(reference, kind)
    with torch.no_grad():
        got = model.encode(_t(_normal(5, B, S_ENC, D)), F32_FLAGS)
    assert got.dtype == (torch.bfloat16 if kind == "bfloat16"
                         else torch.float32)
    tf.relative(got, reference[f"encode/{kind}"], BF16_TOL, "encode")


def test_cross_cache_and_causal_pass_match_reference(reference, model):
    enc_out = _t(_normal(7, B, S_ENC, D))
    with torch.no_grad():
        xkv = model.cross_cache(enc_out)
        for name in ("k", "v"):
            got = torch.stack([c[name] for c in xkv])
            tf.relative(got, reference[f"xkv/{name}"], F32_TOL, name)
        logits, caches = model.decode_forward(_t(_tokens(6)).long(), enc_out,
                                              F32_FLAGS)
    assert caches is None
    tf.relative(logits, reference["train_logits"], F32_TOL, "logits")


def test_causal_pass_with_caches_neither_fills_nor_returns_them(model):
    """The reference's ``decode_forward`` with caches and no index is the
    causal pass."""
    with torch.no_grad():
        enc_out = model.encode(_t(_normal(5, B, S_ENC, D)), F32_FLAGS)
        caches = model.init_cache(B, MAX_LEN, dtype=torch.float32)
        toks = _t(_tokens(6)).long()
        got, out = model.decode_forward(toks, enc_out, F32_FLAGS, caches)
        want, _ = model.decode_forward(toks, enc_out, F32_FLAGS)
    assert out is None
    assert torch.equal(got, want)
    assert not any(bool(c["k"].any()) for c in caches)


@pytest.mark.parametrize("use_flash_decode", [False, True])
def test_decode_ticks_match_reference(reference, model, use_flash_decode):
    flags = dataclasses.replace(F32_FLAGS, use_flash_decode=use_flash_decode)
    with torch.no_grad():
        xkv = model.cross_cache(_t(_normal(7, B, S_ENC, D)))
        caches = model.init_cache(B, MAX_LEN, dtype=torch.float32)
        for i in range(TICKS):
            logits, out = model.decode_forward(
                _t(_tokens(10 + i, t=1)).long(), None, flags, caches, i, xkv)
            assert out is caches
            tf.relative(logits, reference[f"tick{int(use_flash_decode)}/{i}"],
                        F32_TOL, f"tick {i}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_reference(reference, remat):
    """``loss_fn`` through ``forward_train`` (frames, then tokens) on the
    mixed weights, within the bf16 encoder's bars."""
    model, flat = _fresh(reference)
    tcfg = TrainConfig(flags=dataclasses.replace(F32_FLAGS, remat=remat))
    loss, _, grads = value_and_grad(model, flat, _torch_batch(), tcfg)
    np.testing.assert_allclose(float(loss), reference[f"loss/{remat}"],
                               rtol=MIXED_LOSS_RTOL)
    _leafwise(flat, flat.gather(grads), _of(reference, f"grad/{remat}"),
              MIXED_GRAD_TOL, "grad")


def test_decoder_loss_and_gradients_match_reference_in_float32(reference):
    """The decoder's causal pass from a float32 encoder output, float32
    throughout: the loss, every decoder weight's gradient and the
    encoder output's (through the cross-attention's K and V) at the
    float32 bars."""
    model = _model(reference).trainable()
    flat = FlatParams.of(model)
    batch = _torch_batch()
    enc_out = _t(_normal(7, B, S_ENC, D)).requires_grad_()
    with torch.enable_grad():
        logits, _ = model.decode_forward(batch["tokens"], enc_out, F32_FLAGS)
        loss, _ = cross_entropy(logits, batch["labels"], 1e-4)
        grads = torch.autograd.grad(loss, flat.tensors + [enc_out],
                                    allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()),
                               reference["loss/decoder"], rtol=LOSS_RTOL)
    want = _of(reference, "grad/decoder")
    tf.relative(grads[-1], want["enc_out"], GRAD_TOL, "enc_out")
    buf = flat.gather(grads[:-1])
    for path, s, e, _ in flat.spans:
        if path.startswith("enc/"):
            assert not bool(buf[s:e].any()), path  # the loss skips them
            continue
        tf.relative(buf[s:e].reshape(want[path].shape), want[path],
                    GRAD_TOL, path)


def test_remat_gives_the_same_gradients_bitwise(reference):
    """Every remat policy recomputes the same values."""
    bufs = []
    for remat in ("none", "full", "dots"):
        model, flat = _fresh(reference)
        tcfg = TrainConfig(flags=dataclasses.replace(F32_FLAGS, remat=remat))
        bufs.append(flat.gather(value_and_grad(model, flat, _torch_batch(),
                                               tcfg)[2]))
    assert torch.equal(bufs[0], bufs[1]) and torch.equal(bufs[0], bufs[2])


def test_loss_fn_reads_the_frames(reference):
    model, _ = _fresh(reference)
    batch = _torch_batch()
    tcfg = TrainConfig(flags=F32_FLAGS)
    with torch.no_grad():
        a, _ = loss_fn(model, batch, tcfg)
        b, _ = loss_fn(model, dict(batch, frames=batch["frames"] + 1), tcfg)
    assert float(a) != float(b)


def test_microbatched_train_step_matches_reference(reference):
    """``train_step`` over 4 microbatches of one sequence (``split_batch``
    cuts ``frames`` with the tokens) takes the mean of their gradients,
    as the reference's manual step over four ranks of one sequence
    does."""
    model, flat = _fresh(reference)
    opt = adamw.init(flat, adamw.AdamWConfig(**OPT))
    n = GRID[0] * GRID[1]
    mets = train_step(model, opt, _torch_batch(n),
                      TrainConfig(optimizer=adamw.AdamWConfig(**OPT),
                                  microbatches=n, flags=F32_FLAGS), flat)
    np.testing.assert_allclose(float(mets["loss"]), reference["manual/loss"],
                               rtol=MIXED_LOSS_RTOL)
    _leafwise(flat, opt["m"], _of(reference, "manual/m"), MIXED_GRAD_TOL,
              "m")


def test_fused_manual_step_matches_reference(reference):
    """The monolithic fused step, lossless ``pip_mcoll`` on a 2x2 grid,
    each rank a sequence of frames and tokens, against the reference's
    ``make_manual_train_step``: the loss, and the mean gradient as AdamW's
    first moment holds it."""
    model, flat = _fresh(reference)
    ocfg = adamw.AdamWConfig(**OPT)
    opt = adamw.init(flat, ocfg)
    step = ms.make_manual_train_step(
        model.cfg, TrainConfig(optimizer=ocfg, flags=F32_FLAGS),
        RankGrid(*GRID, device="cpu"), algo="pip_mcoll")
    _, mets = step(model, opt, (), _torch_batch(GRID[0] * GRID[1]))
    np.testing.assert_allclose(float(mets["loss"]), reference["manual/loss"],
                               rtol=MIXED_LOSS_RTOL)
    _leafwise(flat, opt["m"], _of(reference, "manual/m"), MIXED_GRAD_TOL,
              "m")


def test_the_overlapped_step_takes_the_monolithic_decomposition(reference):
    """The segmented backward does not apply to the encoder-decoder (the
    reference's reason): ``segmented=True`` raises, ``"auto"`` runs the
    monolithic decomposition."""
    model, flat = _fresh(reference)
    ocfg = adamw.AdamWConfig(**OPT)
    tcfg = TrainConfig(optimizer=ocfg, flags=F32_FLAGS)
    grid = RankGrid(*GRID, device="cpu")
    batch = _torch_batch(GRID[0] * GRID[1])
    with pytest.raises(ValueError, match="encoder-decoder family"):
        ms.make_overlapped_train_step(model.cfg, tcfg, grid,
                                      segmented=True)(
            model, adamw.init(flat, ocfg), batch)
    step = ms.make_overlapped_train_step(model.cfg, tcfg, grid)
    opt = adamw.init(flat, ocfg)
    mets = step(model, opt, batch)
    assert step.mode == "monolithic"
    step.release()
    np.testing.assert_allclose(float(mets["loss"]), reference["manual/loss"],
                               rtol=MIXED_LOSS_RTOL)


if __name__ == "__main__":
    _reference(sys.argv[1])
