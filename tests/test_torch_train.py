"""The port's train step and what it is made of, against the reference, on
the reduced smollm config (2 layers, d_model 128, 4 heads of 32, 2 KV
heads, vocab 512) and small trees: ``attend_streaming``'s backward,
``cross_entropy``, ``loss_fn`` and its gradients, ``remat``, ``train_step``
with and without microbatches, AdamW, the tree codecs and a resume from
the reference's state.

The reference side (``tests/train_reference.py``, run once per module in
a subprocess on the CPU) draws every input, the model's weights among
them (``torch_family.draw_params``, in the reference tree's shapes), from
numpy seeds and writes its results to an ``.npz``; the port takes the
same weights through ``interop.params_from_reference`` and the same
inputs. The
reference compiles its model programs at XLA's lowest backend
optimisation level (``torch_family.fast_compile``) to stay within the
time budget on one core, and its codecs at the default level (their
bitwise results need its fused multiply-adds).

Tolerances: attention ``1e-5 * (1 + |ref|)`` in float32; float32
gradients within ``1e-4`` of each leaf's largest ``|g|``; a step's
float32 weights within ``2 * lr`` and its loss within ``rtol=1e-5``; the
bf16 model's updated weights within 5e-2 and its loss within
``BF16_LOSS_RTOL``; AdamW on a small tree within float32 ulps. The tree
codecs and the three remat policies are bitwise.
"""
import numpy as np
import pytest
import torch

import torch_family as tf
import train_reference as tr
from train_reference import (ARCH, ATTN_CASES, B, CODEC_TREE, OPT, OPT_TREE,
                             SCHED_STEPS, _attn_inputs, _batch, _ce_inputs,
                             _tree)
from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.core import compress
from repro_torch.layers import attention as tattn
from repro_torch.models.decoder import RunFlags
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.optim import compress as ocompress
from repro_torch.train.step import TrainConfig, cross_entropy, loss_fn, \
    train_step

ATTN_TOL = 1e-5
GRAD_TOL = 1e-4
#: the bf16 model's loss against the reference's: XLA keeps a fusion's
#: elementwise chain (SwiGLU, the norms) in float32 and rounds once, the
#: port rounds each operation to bf16 (3.7e-5 measured); the bars of the
#: port against itself on the card (rtol 1e-5) hold in
#: ``tests/test_torch_manual_step.py``
BF16_LOSS_RTOL = 1e-4


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its steps are many small
    operations over 8 ranks, and the suite runs files in parallel
    workers, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tf.reference_npz(tr.__file__, tmp_path_factory, "train_ref")


@pytest.fixture(scope="module")
def cfg():
    return reduced_config(ARCH)


def _param_tree(reference, dtype):
    return tf.tree(reference, dtype, ())


def _model(reference, cfg, dtype):
    return interop.params_from_reference(_param_tree(reference, dtype), cfg,
                                         device="cpu")


def _tcfg(dtype, mb=1, remat="none"):
    return TrainConfig(optimizer=adamw.AdamWConfig(**OPT), microbatches=mb,
                       flags=RunFlags(remat=remat, logits_dtype=dtype))


def _torch_batch(step=0):
    return {k: torch.from_numpy(v).long() for k, v in _batch(step).items()}


def _leaves(reference, prefix):
    return {k[len(prefix) + 1:]: v for k, v in reference.items()
            if k.startswith(prefix + "/")}


def _by_leaf(flat, buf):
    """``{path: (start, end) slice of buf as numpy}`` in the flat layout."""
    return {p: buf[s:e].float().numpy() for p, s, e, _ in flat.spans}


def _within(got, want, tol, what):
    """Each leaf within ``tol`` absolute."""
    for path, w in want.items():
        g = got[path].reshape(w.shape)
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{what} {path}: max error {err} > {tol}"


@pytest.mark.parametrize("i", range(len(ATTN_CASES)))
def test_attend_streaming_and_its_backward_match_reference(reference, i):
    """Out, dq, dk and dv against ``jax.vjp`` of the reference's custom
    VJP: causal and not, G 2 and 3, a q_offset, chunks that divide and
    the ``attend_full`` fallback, float32, within ``ATTN_TOL * (1 +
    |ref|)``."""
    causal, *_, qc, kc, off = ATTN_CASES[i]
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(ATTN_CASES[i],
                                                              i))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tattn.attend_streaming(q, k, v, causal, qc, kc, off)
    grads = torch.autograd.grad(out, (q, k, v), do)
    for name, got in zip(("out", "dq", "dk", "dv"), (out,) + grads):
        want = reference[f"attn{i}/{name}"]
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   rtol=ATTN_TOL, atol=ATTN_TOL,
                                   err_msg=name)


def test_cross_entropy_masks_labels_and_adds_z_loss(reference):
    lg, lb = (torch.from_numpy(a) for a in _ce_inputs())
    lg.requires_grad_()
    ce, n = cross_entropy(lg, lb, 1e-4)
    (g,) = torch.autograd.grad(ce, lg)
    assert int(n) == int(reference["ce/n"]) == 10
    np.testing.assert_allclose(float(ce.detach()), reference["ce/loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), reference["ce/grad"], rtol=1e-5,
                               atol=1e-7)


def test_f32_loss_and_gradients_match_reference(reference, cfg):
    """float32 weights: the loss within ``rtol=1e-6`` and every leaf's
    gradient within ``GRAD_TOL`` of that leaf's largest ``|g|``."""
    model = _model(reference, cfg, "float32").trainable()
    flat = FlatParams.of(model)
    from repro_torch.train.step import value_and_grad
    loss, mets, grads = value_and_grad(model, flat, _torch_batch(),
                                       _tcfg("float32"))
    np.testing.assert_allclose(float(loss), reference["f32/loss"],
                               rtol=1e-6)
    got = _by_leaf(flat, flat.gather(grads))
    for path, want in _leaves(reference, "f32/grad").items():
        tf.relative(torch.from_numpy(got[path].reshape(want.shape)), want,
                    GRAD_TOL, path)


def test_bf16_step_matches_reference(reference, cfg):
    """The reference's own dtypes (bf16 weights and logits): one step's
    updated weights within 5e-2 (the bar of ``tests/checks/
    manual_step_check.py``) and the loss within ``BF16_LOSS_RTOL``."""
    model = _model(reference, cfg, "bfloat16")
    flat = FlatParams.of(model)
    opt = adamw.init(flat, adamw.AdamWConfig(**OPT))
    mets = train_step(model, opt, _torch_batch(), _tcfg("bfloat16"), flat)
    np.testing.assert_allclose(float(mets["loss"]), reference["bf16/loss"],
                               rtol=BF16_LOSS_RTOL)
    _within(_by_leaf(flat, flat.read()), _leaves(reference, "bf16/param"),
            5e-2, "bf16 weights")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_policies_agree_bitwise(reference, cfg, dtype):
    """``remat`` "none", "full" and "dots" give the same loss and
    gradients, bit for bit; the segment API composes to the forward."""
    from repro_torch.train.step import value_and_grad
    model = _model(reference, cfg, dtype).trainable()
    flat = FlatParams.of(model)
    batch = _torch_batch()
    outs = []
    for remat in ("none", "full", "dots"):
        loss, _, grads = value_and_grad(model, flat, batch,
                                        _tcfg(dtype, remat=remat))
        outs.append((loss, flat.gather(grads)))
    for loss, g in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        assert torch.equal(g, outs[0][1])
    with torch.no_grad():
        flags = RunFlags(logits_dtype=dtype)
        h = model.embed_apply(batch["tokens"])
        h, aux = model.segment_apply(h, 0, 1, flags)
        h, aux2 = model.segment_apply(h, 1, 2, flags)
        logits, aux_all, _ = model(batch["tokens"], flags=flags)
        assert torch.equal(model.head_apply(h, flags), logits)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_reference(reference, cfg, mb):
    """float32, one and two microbatches: the loss and grad norm within
    ``rtol=1e-5``, ``m`` within 1e-4 of its largest entry, and the updated
    weights within ``2 * lr``. Where a gradient entry is about as small as
    the order of float32 sums, the first AdamW step's ``m/sqrt(v)`` can
    take either sign: ``2 * lr`` is that worst case; ``v`` is held as
    ``m``."""
    model = _model(reference, cfg, "float32")
    flat = FlatParams.of(model)
    ocfg = adamw.AdamWConfig(**OPT)
    opt = adamw.init(flat, ocfg)
    mets = train_step(model, opt, _torch_batch(), _tcfg("float32", mb), flat)
    tag = "f32" if mb == 1 else "mb2"
    np.testing.assert_allclose(float(mets["loss"]), reference[f"{tag}/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(mets["grad_norm"]),
                               reference[f"{tag}/grad_norm"], rtol=1e-5)
    assert opt["step"] == 1
    _within(_by_leaf(flat, flat.read()), _leaves(reference, f"{tag}/param"),
            2 * ocfg.lr, "weights")
    for key in ("m", "v"):
        want = _leaves(reference, f"{tag}/{key}")
        got = _by_leaf(flat, opt[key])
        for path, w in want.items():
            tf.relative(torch.from_numpy(got[path].reshape(w.shape)), w,
                        1e-4, f"{key} {path}")


@pytest.mark.parametrize("sched", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(reference, sched):
    c = adamw.AdamWConfig(lr=1.0, warmup_steps=2, total_steps=10,
                          min_lr_ratio=0.1, schedule=sched)
    got = np.array([adamw.schedule_lr(c, s) for s in SCHED_STEPS],
                   np.float32)
    np.testing.assert_allclose(got, reference[f"sched/{sched}"], rtol=1e-6,
                               atol=0)


def _opt_tree_flat(tree, dtype):
    leaves = [(p, [torch.from_numpy(a).to(dtype)])
              for p, a in interop.flatten_reference(tree)]
    return FlatParams(leaves)


def test_clip_by_global_norm_and_decay_mask_match_reference(reference):
    g = _opt_tree_flat(_tree(OPT_TREE, 2, 0.5), torch.float32)
    clipped, norm = adamw.clip_by_global_norm(g.read(), 1.0, g.spans)
    np.testing.assert_allclose(float(norm), reference["clip/norm"],
                               rtol=1e-6)
    for path, want in _leaves(reference, "clip/g").items():
        s, e = g.leaf(path)
        np.testing.assert_allclose(clipped[s:e].numpy(), want.reshape(-1),
                                   rtol=1e-6, atol=1e-7)
    mask = _leaves(reference, "mask")
    assert {p: adamw.decays(p) for p in mask} == \
        {p: bool(m) for p, m in mask.items()}
    # the reference's substrings on the model's own leaf paths: the
    # embedding and the LM head decay, norms and every "groups/..." leaf
    # (its path holds a "u") do not
    from repro_torch.models.params import param_shapes
    decayed = [p for p, _ in param_shapes(reduced_config(ARCH))
               if adamw.decays(p)]
    assert decayed == ["embed", "lm_head"]


@pytest.mark.parametrize("master", [False, True])
def test_update_matches_reference(reference, master):
    """Two AdamW steps on a small bf16 tree (decayed and undecayed leaves,
    clipping active): weights, ``m``, ``v``, the masters and the metrics.
    ``m`` and ``v`` within a float32 ulp or two (``rtol=1e-6``); the bf16
    weights bitwise or one bf16 ulp apart where the float32 value sits on
    a rounding boundary."""
    c = adamw.AdamWConfig(master_fp32=master, **OPT)
    p = _opt_tree_flat(_tree(OPT_TREE, 1), torch.bfloat16)
    g = _opt_tree_flat(_tree(OPT_TREE, 2, 0.5), torch.float32).read()
    state = adamw.init(p, c)
    for _ in range(2):
        mets = adamw.update(p, g.clone(), state, c)
    tag = f"opt{int(master)}"
    np.testing.assert_allclose(float(mets["lr"]), reference[f"{tag}/lr"],
                               rtol=1e-7)
    np.testing.assert_allclose(float(mets["grad_norm"]),
                               reference[f"{tag}/grad_norm"], rtol=1e-6)
    for key in ("m", "v") + (("master",) if master else ()):
        for path, want in _leaves(reference, f"{tag}/{key}").items():
            s, e = p.leaf(path)
            np.testing.assert_allclose(state[key][s:e].numpy(),
                                       want.reshape(-1), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{key} {path}")
    got = p.read()
    for path, want in _leaves(reference, f"{tag}/param").items():
        s, e = p.leaf(path)
        ulp = np.abs(want.reshape(-1)) * 2.0 ** -7
        assert (np.abs(got[s:e].numpy() - want.reshape(-1)) <= ulp).all(), \
            path


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def test_tree_codecs_bitwise(reference):
    """``compress_tree`` (one feedback encode per leaf) with a carried
    error: wire forms and new error bitwise the reference's; decoded tree
    bitwise; the wire bytes equal."""
    grads = _torch_tree(_tree(CODEC_TREE, 5))
    err = _torch_tree(_tree(CODEC_TREE, 6, 1e-3))
    comp, new_err = compress.compress_tree(grads, err)
    qs, scales, _ = comp
    for i, (q, s) in enumerate(zip(qs, scales)):
        assert np.array_equal(q.numpy(), reference[f"codec/q{i}"])
        assert np.array_equal(s.numpy(), reference[f"codec/scale{i}"])
    for path, a in interop.flatten_reference(_flat_np(new_err)):
        assert np.array_equal(a, reference[f"codec/err/{path}"]), path
    dec = compress.decompress_tree(comp, grads)
    for path, a in interop.flatten_reference(_flat_np(dec)):
        assert np.array_equal(a, reference[f"codec/dec/{path}"]), path
    assert compress.wire_bytes(comp) == int(reference["codec/wire_bytes"])
    # a tree of zeros as the starting state
    zero = compress.init_error_state(grads)
    assert torch.equal(zero["b"]["c"], torch.zeros(2, 700))


def _flat_np(tree):
    if isinstance(tree, dict):
        return {k: _flat_np(v) for k, v in tree.items()}
    return tree.numpy()


def test_optim_compress_reexports_core():
    """No second implementation: ``optim.compress`` re-exports the core
    objects themselves."""
    for name in ocompress.__all__:
        assert getattr(ocompress, name) is getattr(compress, name), name
    assert ocompress.BLOCK == compress.BLOCK == 256


def test_resume_from_reference_state(reference, cfg):
    """The reference's weights and AdamW state after step 1, carried by
    ``interop``, give the reference's step 2 (float32; bars as in
    :func:`test_train_step_matches_reference`)."""
    model = interop.params_from_reference(
        _nest(_leaves(reference, "f32/param")), cfg, device="cpu")
    state = {"step": reference["resume/step"],
             "m": _nest(_leaves(reference, "f32/m")),
             "v": _nest(_leaves(reference, "f32/v"))}
    opt = interop.opt_state_from_reference(state, cfg, device="cpu")
    assert opt["step"] == 1
    flat = FlatParams.of(model)
    mets = train_step(model, opt, _torch_batch(1), _tcfg("float32"), flat)
    np.testing.assert_allclose(float(mets["loss"]),
                               reference["resume/loss"], rtol=1e-5)
    assert opt["step"] == 2
    _within(_by_leaf(flat, flat.read()), _leaves(reference, "resume/param"),
            2 * OPT["lr"], "weights")


def _nest(flat_items):
    tree = {}
    for path, a in flat_items.items():
        node = tree
        *parents, leaf = path.split("/")
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = a
    return tree


def test_loss_fn_refuses_what_is_not_ported(reference, cfg):
    """Frontend embeds in the batch (the VLM input, once refused) go
    before the tokens, and the loss runs over the token tail only, as
    the reference's ``loss_fn`` takes it."""
    model = _model(reference, cfg, "float32")
    batch = dict(_torch_batch(), embeds=torch.from_numpy(tr._embeds()))
    with torch.no_grad():
        loss, mets = loss_fn(model, batch, _tcfg("float32"))
    np.testing.assert_allclose(float(loss), reference["embeds/loss"],
                               rtol=1e-6)
    assert int(mets["tokens"]) == int((batch["labels"] >= 0).sum())


def _kernel_calls(dev):
    """One call of each model-kernel wrapper on operands that require grad
    (reduced shapes on ``dev``)."""
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import mamba as kmamba
    from repro_torch.kernels import rwkv as krwkv
    g = torch.Generator(dev).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device=dev).requires_grad_()
    q, k, v = r(2, 1, 4, 32), r(2, 8, 2, 32), r(2, 8, 2, 32)
    rr, kk, vv = r(1, 3, 2, 8), r(1, 3, 2, 8), r(1, 3, 2, 8)
    w = torch.rand(1, 3, 2, 8, device=dev)
    u, s0 = r(2, 8), torch.zeros(1, 2, 8, 8, device=dev)
    dt, A = torch.rand(1, 3, 16, device=dev), -r(16, 4)
    Bm, Cm, x = r(1, 3, 4), r(1, 3, 4), r(1, 3, 16)
    return {"flash_decode": lambda: kattn.flash_decode(q, k, v, 8),
            "rwkv6_wkv": lambda: krwkv.rwkv6_wkv(rr, kk, vv, w, u, s0),
            "rwkv6_wkv_chunked": lambda: krwkv.rwkv6_wkv_chunked(
                rr, kk, vv, w, u, s0),
            "rwkv6_wkv_recurrent": lambda: krwkv.rwkv6_wkv_recurrent(
                rr, kk, vv, w, u, s0),
            "mamba_scan": lambda: kmamba.mamba_scan(dt, A, Bm, Cm, x)}


@pytest.mark.parametrize("name", ["flash_decode", "rwkv6_wkv",
                                  "rwkv6_wkv_chunked", "rwkv6_wkv_recurrent",
                                  "mamba_scan"])
def test_kernel_wrappers_refuse_grad(name):
    """A kernel has no backward: under grad mode, with an operand that
    requires grad, its wrapper raises (on the CPU too, where it would run
    the plain version); under ``no_grad`` it runs."""
    call = _kernel_calls("cpu")[name]
    with pytest.raises(RuntimeError, match="has no backward"):
        call()
    with torch.no_grad():
        call()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_decode", "rwkv6_wkv",
                                  "rwkv6_wkv_chunked", "rwkv6_wkv_recurrent",
                                  "mamba_scan"])
def test_kernel_wrappers_refuse_grad_on_the_card(cuda, name):
    call = _kernel_calls(cuda)[name]
    with pytest.raises(RuntimeError, match="has no backward"):
        call()


@pytest.mark.cuda
def test_compress_tree_feedback_kernel_bitwise_on_the_card(cuda):
    """On the card each leaf is one ``int8_encode_feedback`` launch; wire
    forms and the new error equal the plain versions' bitwise."""
    from repro_torch.kernels import codec as kcodec
    grads = {k: v.to(cuda) for k, v in _torch_tree(_tree(
        {"a": (300,), "d": (256,)}, 5)).items()}
    err = {k: v.to(cuda) for k, v in _torch_tree(_tree(
        {"a": (300,), "d": (256,)}, 6, 1e-3)).items()}
    kcodec.reset_launches()
    (qs, scales, _), new_err = compress.compress_tree(grads, err)
    assert kcodec.launches["int8_block_encode_feedback"] == 2
    with compress.reference_paths():
        (pq, ps, _), plain_err = compress.compress_tree(grads, err)
    for a, b in zip(qs + scales + list(new_err.values()),
                    pq + ps + list(plain_err.values())):
        assert torch.equal(a, b)
