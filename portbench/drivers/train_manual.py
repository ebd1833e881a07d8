"""Traffic: the program's fused data-parallel train step back to back:
``make_manual_train_step`` on a ``RankGrid``, every rank's forward and
backward on its rows of the batch, the bucketed mean-allreduce of the
gradients with error feedback (the mix's algorithm, budget and bucket
size), AdamW in place. One step takes the mix's ``batch`` rows of
``seq_len`` tokens from the synthetic stream, one row a rank.

Correctness as ``trainlib`` sets out. The reference computes each rank's
gradient of its own rows with the plain decoder, syncs them through the
plain compressed allreduce (``reference/codec.py``) bucket by bucket with
its own carried error, and steps AdamW on the mean; its loss is the mean
of the ranks' losses.
"""
from __future__ import annotations

import types

from portbench import trainlib, weights

#: steps profiled after the traced run's untraced window
PROFILED_STEPS = 1


def setup(ctx):
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.models.decoder import RunFlags
    from repro_torch.optim import adamw
    from repro_torch.train import manual_step as ms
    from repro_torch.train.step import TrainConfig

    t = ctx.traffic
    model, flat = trainlib.build_model(ctx)
    grid = RankGrid(ctx.grid[0], ctx.grid[1], ctx.device)
    ocfg = trainlib.adamw_config(ctx)
    tcfg = TrainConfig(optimizer=ocfg, z_loss=t["z_loss"],
                       flags=RunFlags(remat=t["remat"]))
    fn = ms.make_manual_train_step(
        model.cfg, tcfg, grid, algo=t["algo"],
        error_budget=t["error_budget"], bucket_bytes=t["bucket_bytes"])
    errs = ms.init_error_state(flat.n, Communicator(grid), t["error_budget"],
                               t["bucket_bytes"])
    opt = adamw.init(flat, ocfg)
    st = types.SimpleNamespace(model=model, flat=flat, opt=opt, errs=errs,
                        data=trainlib.batches(ctx))

    def run(batch):
        st.errs, metrics = fn(model, opt, st.errs, batch)
        return metrics
    st.run = run
    fault = ctx.hooks.get("fault")
    if fault:
        fault(st, ctx)
    trainlib.check_steps(st, ctx, lambda i: float(
        st.run(st.data[i % len(st.data)])["loss"]))
    return st


def step(st, i):
    st.run(st.data[i % len(st.data)])


def after_window(st, ctx):
    pass


def trace(st, ctx):
    """An untraced window of ``ctx.seconds``, then ``PROFILED_STEPS``
    steps under the profiler."""
    from portbench import trace as _trace

    tr = _trace.traced_window(ctx.torch, lambda i: step(st, i),
                              st.next_step, ctx.seconds, PROFILED_STEPS,
                              ctx.sync, window=ctx.window)
    st.next_step = tr["next_step"]
    return tr


def reference_grads(ctx):
    """``grads_of`` for ``trainlib.reference_steps``: each rank's rows
    through the plain decoder, the ranks' gradients synced through the
    plain compressed allreduce with carried error, their mean."""
    torch = ctx.torch
    from portbench.reference import codec as ref_codec
    from portbench.reference import model as ref_model

    t = ctx.traffic
    n_nodes, n_local = ctx.grid
    world = n_nodes * n_local
    lay = weights.layout(ctx.cfg)
    n = weights.n_params(ctx.cfg)
    codec = t["codec"].split("_")[0]
    bucket = t["bucket_bytes"] // 4
    carry = {}

    def grads_of(wt, batch, prec):
        w = {p: v.detach().requires_grad_() for p, v in wt.items()}
        rows = batch["tokens"].shape[0] // world
        stacked = torch.empty((world, n), dtype=torch.float32,
                              device=ctx.device)
        losses = []
        for r in range(world):
            sl = slice(r * rows, (r + 1) * rows)
            loss, info = ref_model.forward_loss(
                w, batch["tokens"][sl], batch["labels"][sl], ctx.cfg, prec,
                z_loss=t["z_loss"])
            gs = torch.autograd.grad(loss, list(w.values()))
            off = 0
            for g in gs:
                stacked[r, off:off + g.numel()] = g.reshape(-1)
                off += g.numel()
            losses.append(info["loss"])
            del gs, loss
        mean = torch.empty(n, dtype=torch.float32, device=ctx.device)
        for b, s in enumerate(range(0, n, bucket)):
            x = stacked[:, s:s + bucket]
            err = carry.get(b)
            if err is None:
                err = torch.zeros_like(x)
            out, carry[b] = ref_codec.allreduce(x, err, n_nodes, n_local,
                                                codec)
            mean[s:s + x.shape[1]] = out[0] / world
        del stacked
        g, off = {}, 0
        for p, shape, _, _ in lay:
            k = 1
            for d in shape:
                k *= d
            g[p] = mean[off:off + k].reshape(shape)
            off += k
        return sum(losses) / world, g
    return grads_of


def control(ctx):
    """The control: ``trainlib.control`` with this mix's reference."""
    return trainlib.control(ctx, reference_grads)


def check(st, ctx):
    return trainlib.check(st, ctx, reference_grads)
