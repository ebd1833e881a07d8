"""The reference side of ``tests/test_torch_manual_step.py``: its inputs,
drawn from numpy seeds, and the reference's results on them, written to
an ``.npz`` by ``python tests/manual_step_reference.py OUT.npz`` under 8
forced host devices (the test file's module fixture runs it once in a
subprocess on the CPU). Imports no torch."""
import sys

import numpy as np

import torch_family as tf

N, P = 2, 4
WORLD = N * P
B, T = 2 * WORLD, 32
BUDGET = 0.004  # admits int8_block (bound 0.5/127), excludes fp8 and topk
BUCKET = 256 << 10
EF_STEPS = 3
#: the family check: reduced rwkv6 and jamba, one sequence of 16 a rank
FAMILIES = ("rwkv6-1.6b", "jamba-1.5-large-398b")
FAMILY_T = 16
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10, schedule="constant",
           grad_clip=1e9)


def _batch(n=B, t=T, vocab=512, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, size=(n, t)).astype(np.int32),
            "labels": rng.integers(0, vocab, size=(n, t)).astype(np.int32)}


def reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.core.topology import Topology
    from repro.models import decoder
    from repro.optim import adamw as jadamw
    from repro.train import manual_step as jms
    from repro.train import step as jstep

    res = {}
    mesh = jax.make_mesh((N, P), ("node", "local"))
    topo = Topology(N, P)
    ocfg = jadamw.AdamWConfig(**OPT)
    tcfg = jstep.TrainConfig(optimizer=ocfg,
                             flags=decoder.RunFlags(remat="none"))
    for arch in ("smollm-360m",) + FAMILIES:
        cfg = jreduced(arch)
        drawn = tf.draw_params(jax.eval_shape(
            lambda k: decoder.init(k, cfg), jax.random.PRNGKey(0)))
        for path, leaf in tf.flatten(drawn):
            res[f"{arch}/param/{path}"] = np.asarray(leaf, np.float32)
        if arch != "smollm-360m":
            batch = {k: jnp.asarray(v) for k, v in _batch(
                WORLD, FAMILY_T).items()}
            shard = {k: v[:1] for k, v in batch.items()}
            f32 = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a, np.float32)), drawn)
            fcfg = jstep.TrainConfig(flags=decoder.RunFlags(
                remat="none", logits_dtype="float32"))
            fn = tf.fast_compile(lambda p_, b_: jstep.loss_fn(
                p_, b_, cfg, fcfg)[0], f32, shard)
            res[f"{arch}/losses"] = np.array(
                [float(fn(f32, {k: v[d:d + 1] for k, v in batch.items()}))
                 for d in range(WORLD)], np.float32)
            continue
        params = jax.tree.map(jnp.asarray, drawn)
        step = jms.make_manual_train_step(
            cfg, tcfg, mesh, topo, algo="pip_mcoll", error_budget=BUDGET,
            codec="int8_block", bucket_bytes=BUCKET)
        err = jms.init_error_state(params, BUDGET, bucket_bytes=BUCKET,
                                   topo=topo)
        opt = jax.jit(lambda p_: jadamw.init(p_, ocfg))(params)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        fn = tf.fast_compile(step, params, opt, err, batch)
        losses = []
        for _ in range(EF_STEPS):
            params, opt, err, m = fn(params, opt, err, batch)
            losses.append(float(m["loss"]))
        res["ef/losses"] = np.array(losses, np.float32)
    np.savez(out_path, **res)


F32_LEAVES = ("A_log", "D_skip", "router", "w0", "w1", "w2", "u")


if __name__ == "__main__":
    reference(sys.argv[1])
