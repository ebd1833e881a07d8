"""The reference side of ``tests/test_torch_train.py``: its inputs, drawn
from numpy seeds, and the reference's results on them, written to an
``.npz`` by ``python tests/train_reference.py OUT.npz`` (the test file's
module fixture runs it once in a subprocess on the CPU). Imports no
torch."""
import sys

import numpy as np

import torch_family as tf

ARCH = "smollm-360m"
B, T = 4, 32
#: (causal, B, T, S, H, KV, hd, q_chunk, kv_chunk, q_offset): chunks that
#: divide (G 2 and 3, a q_offset) and the attend_full fallback
ATTN_CASES = [(True, 2, 16, 16, 4, 2, 8, 4, 8, 0),
              (False, 2, 16, 16, 4, 2, 8, 4, 8, 0),
              (True, 1, 8, 16, 6, 2, 8, 4, 8, 8),
              (False, 1, 8, 32, 6, 2, 8, 8, 8, 0),
              (True, 2, 10, 10, 4, 2, 8, 4, 8, 0),
              (False, 1, 12, 20, 4, 1, 8, 4, 8, 0)]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0,
           weight_decay=0.1)
SCHED_STEPS = (0, 1, 2, 5, 9, 10, 12)
#: the small tree for AdamW and the codecs: decayed and undecayed leaves
OPT_TREE = {"dense": {"w": (3, 40)}, "ln1": {"scale": (40,)},
            "embed": (5, 30)}
CODEC_TREE = {"a": (300,), "b": {"c": (2, 700)}, "d": (256,)}


def _attn_inputs(case, i):
    causal, b, t, s, h, kv, hd, qc, kc, off = case
    rng = np.random.default_rng(40 + i)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(b, t, h, hd), f(b, s, kv, hd), f(b, s, kv, hd), f(b, t, h * hd)


def _batch(step=0, n=B):
    rng = np.random.default_rng(10 + step)
    toks = rng.integers(0, 512, size=(n, T)).astype(np.int32)
    labels = rng.integers(0, 512, size=(n, T)).astype(np.int32)
    labels[0, :5] = -1
    return {"tokens": toks, "labels": labels}


def _embeds(n=B, t_p=2, d=128):
    """Stub frontend embeddings (VLM patches) put before the tokens."""
    return np.random.default_rng(12).standard_normal((n, t_p, d)).astype(
        np.float32)


def _ce_inputs():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    labels[1, 2:4] = -1
    return logits, labels


def _tree(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    if isinstance(shapes, dict):
        return {k: _tree(v, seed + 7 * i + 1, scale)
                for i, (k, v) in enumerate(sorted(shapes.items()))}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _flat_items(tree, prefix):
    return {f"{prefix}/{p}": a for p, a in tf.flatten(tree)}


def reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from repro.configs import reduced_config as jreduced
    from repro.core import compress as jcompress
    from repro.layers import attention as jattn
    from repro.models import decoder
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep

    res = {}
    # attend_streaming and its custom VJP, every case in one program
    def fwd_bwd(case, q, k, v, do):
        causal, *_, qc, kc, off = case
        out, vjp = jax.vjp(lambda q_, k_, v_: jattn.attend_streaming(
            q_, k_, v_, causal, qc, kc, off), q, k, v)
        return (out,) + vjp(do)

    inputs = [_attn_inputs(case, i) for i, case in enumerate(ATTN_CASES)]
    outs = tf.fast_compile(lambda xs: [fwd_bwd(c, *x) for c, x in zip(
        ATTN_CASES, xs)], inputs)(inputs)
    for i, case_outs in enumerate(outs):
        for name, a in zip(("out", "dq", "dk", "dv"), case_outs):
            res[f"attn{i}/{name}"] = np.asarray(a)
    # cross_entropy with masked labels and the z-loss
    lg, lb = (jnp.asarray(a) for a in _ce_inputs())
    (ce, n), dlg = jax.jit(jax.value_and_grad(
        lambda x: jstep.cross_entropy(x, lb, 1e-4), has_aux=True))(lg)
    res["ce/loss"], res["ce/n"], res["ce/grad"] = (np.asarray(ce),
                                                   np.asarray(n),
                                                   np.asarray(dlg))
    # the reduced model: loss, gradients and one AdamW step (train_step's
    # single-microbatch path) in float32 and bf16; the float32 state, then
    # its second step (the resume); train_step over 2 microbatches
    cfg = jreduced(ARCH)
    ocfg = jadamw.AdamWConfig(**OPT)
    drawn = tf.draw_params(jax.eval_shape(
        lambda k: decoder.init(k, cfg), jax.random.PRNGKey(0)))
    for path, leaf in tf.flatten(drawn):
        res[f"param/{path}"] = np.asarray(leaf, np.float32)
    params = jax.tree.map(jnp.asarray, drawn)
    f32 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                       drawn)
    init = jax.jit(lambda p_: jadamw.init(p_, ocfg))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def tcfg_of(dtype, mb=1):
        return jstep.TrainConfig(optimizer=ocfg, microbatches=mb,
                                 flags=decoder.RunFlags(
                                     remat="none", logits_dtype=dtype))

    for tag, p, dtype in (("f32", f32, "float32"),
                          ("bf16", params, "bfloat16")):
        tcfg = tcfg_of(dtype)

        def one_step(p_, o_, b_):
            (loss, mets), grads = jax.value_and_grad(
                lambda q_: jstep.loss_fn(q_, b_, cfg, tcfg),
                has_aux=True)(p_)
            p2, o2, om = jadamw.update(p_, grads, o_, ocfg)
            return loss, mets["ce"], om["grad_norm"], grads, p2, o2

        o0 = init(p)
        fn = tf.fast_compile(one_step, p, o0, batch)
        loss, ce, gn, grads, p1, o1 = fn(p, o0, batch)
        res[f"{tag}/loss"], res[f"{tag}/ce"] = np.asarray(loss), \
            np.asarray(ce)
        res[f"{tag}/grad_norm"] = np.asarray(gn)
        for name, tree in (("grad", grads), ("param", p1), ("m", o1["m"]),
                           ("v", o1["v"])):
            res.update(_flat_items(jax.device_get(jax.tree.map(
                lambda a: np.asarray(a, np.float32), tree)),
                f"{tag}/{name}"))
        if tag == "f32":
            res["resume/step"] = np.asarray(o1["step"])
            b2 = {k: jnp.asarray(v) for k, v in _batch(1).items()}
            loss2, *_, p2, _ = fn(p1, o1, b2)
            res["resume/loss"] = np.asarray(loss2)
            res.update(_flat_items(jax.device_get(p2), "resume/param"))
    tcfg = tcfg_of("float32", 2)
    p1, o1, m1 = tf.fast_compile(lambda p_, o_, b_: jstep.train_step(
        p_, o_, b_, cfg, tcfg), f32, o0, batch)(f32, init(f32),
                                                 batch)
    res["mb2/loss"] = np.asarray(m1["loss"])
    res["mb2/grad_norm"] = np.asarray(m1["grad_norm"])
    res.update(_flat_items(jax.device_get(p1), "mb2/param"))
    res.update(_flat_items(jax.device_get(o1["m"]), "mb2/m"))
    res.update(_flat_items(jax.device_get(o1["v"]), "mb2/v"))
    # frontend embeds before the tokens: the loss over the token tail
    eb = dict(batch, embeds=jnp.asarray(_embeds()))
    res["embeds/loss"] = np.asarray(tf.fast_compile(
        lambda p_, b_: jstep.loss_fn(p_, b_, cfg, tcfg_of("float32"))[0],
        f32, eb)(f32, eb))
    # schedules
    for sched in ("cosine", "linear", "constant"):
        c = jadamw.AdamWConfig(lr=1.0, warmup_steps=2, total_steps=10,
                               min_lr_ratio=0.1, schedule=sched)
        res[f"sched/{sched}"] = np.asarray(jax.jit(
            lambda s_: jadamw.schedule_lr(c, s_))(
                jnp.asarray(SCHED_STEPS, jnp.int32)))
    # AdamW on a small tree: clip, mask, update (bf16 weights), with and
    # without float32 masters, two steps
    tree = jax.tree.map(lambda a: jnp.asarray(a.astype(ml_dtypes.bfloat16)),
                        _tree(OPT_TREE, 1))
    g = jax.tree.map(jnp.asarray, _tree(OPT_TREE, 2, 0.5))
    clipped, norm = jax.jit(lambda g_: jadamw.clip_by_global_norm(
        g_, 1.0))(g)
    res.update(_flat_items(jax.device_get(clipped), "clip/g"))
    res["clip/norm"] = np.asarray(norm)
    res.update(_flat_items(jax.device_get(jax.tree.map(
        lambda m: np.asarray(m, np.float32),
        jadamw._decay_mask(tree))), "mask"))
    for master in (False, True):
        c = jadamw.AdamWConfig(master_fp32=master, **OPT)
        p, o = tree, jax.jit(lambda p_: jadamw.init(p_, c))(tree)
        upd = jax.jit(lambda p_, o_: jadamw.update(p_, g, o_, c))
        for s in range(2):
            p, o, m = upd(p, o)
        tag = f"opt{int(master)}"
        res.update(_flat_items(jax.tree.map(
            lambda a: np.asarray(a, np.float32), jax.device_get(p)),
            f"{tag}/param"))
        res.update(_flat_items(jax.device_get(o["m"]), f"{tag}/m"))
        res.update(_flat_items(jax.device_get(o["v"]), f"{tag}/v"))
        if master:
            res.update(_flat_items(jax.device_get(o["master"]),
                                   f"{tag}/master"))
        res[f"{tag}/lr"] = np.asarray(m["lr"])
        res[f"{tag}/grad_norm"] = np.asarray(m["grad_norm"])
    # the tree codecs, with a carried error
    grads = jax.tree.map(jnp.asarray, _tree(CODEC_TREE, 5))
    err = jax.tree.map(jnp.asarray, _tree(CODEC_TREE, 6, 1e-3))
    (qs, scales), new_err = jax.jit(lambda g_, e_: (
        lambda c_, e2: (c_[:2], e2))(*jcompress.compress_tree(g_, e_)))(
            grads, err)
    _ = jax.tree.structure(grads)
    for i, (q, s) in enumerate(zip(qs, scales)):
        res[f"codec/q{i}"], res[f"codec/scale{i}"] = (np.asarray(q),
                                                      np.asarray(s))
    res.update(_flat_items(jax.device_get(new_err), "codec/err"))
    res.update(_flat_items(jax.device_get(jax.jit(
        lambda q_, s_: jcompress.decompress_tree((q_, s_, _), grads))(
            qs, scales)), "codec/dec"))
    res["codec/wire_bytes"] = np.asarray(jcompress.wire_bytes(
        (qs, scales, _)))
    np.savez(out_path, **res)


if __name__ == "__main__":
    reference(sys.argv[1])
