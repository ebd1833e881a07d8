"""Traffic: the program's sharded train step back to back: ``train_step``
with ``Rules(batch=(batch axis,), tp=expert axis)`` on a ``RankGrid``, so
every MoE block runs expert parallel (route, three dispatch all-to-alls,
each rank's experts, one combine, forward and backward) and AdamW updates
the weights in place. One step takes the mix's ``batch`` rows of
``seq_len`` tokens from the synthetic stream.

Correctness as ``trainlib`` sets out; the reference's layer routes at the
same capacity over the same layout (``reference/model.py``).
"""
from __future__ import annotations

import types

from portbench import trainlib

#: the benchmark's profiler range around each expert-parallel all-to-all
A2A_RANGE = "ep_alltoall"
#: steps profiled after the traced run's untraced window
PROFILED_STEPS = 2


def setup(ctx):
    from repro_torch.core.grid import RankGrid
    from repro_torch.models.decoder import RunFlags
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import Rules
    from repro_torch.train.step import TrainConfig, train_step

    t = ctx.traffic
    model, flat = trainlib.build_model(ctx)
    grid = RankGrid(ctx.grid[0], ctx.grid[1], ctx.device)
    rules = Rules(batch=(t["batch_axis"],), tp=t["expert_axis"])
    ocfg = trainlib.adamw_config(ctx)
    tcfg = TrainConfig(optimizer=ocfg, z_loss=t["z_loss"],
                       flags=RunFlags(remat=t["remat"]))
    opt = adamw.init(flat, ocfg)
    data = trainlib.batches(ctx)
    st = types.SimpleNamespace(model=model, flat=flat, opt=opt, data=data)
    st.run = lambda batch: train_step(model, opt, batch, tcfg, flat,
                                      rules=rules, grid=grid)
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
    steps under the profiler, each all-to-all the MoE calls inside a range
    of the benchmark's own (put in place only for them)."""
    from repro_torch.core import mcoll

    from portbench import trace as _trace

    torch = ctx.torch
    algos = dict(mcoll.ALLTOALL)

    def ranged(f):
        def call(*args, **kw):
            with torch.profiler.record_function(A2A_RANGE):
                return f(*args, **kw)
        return call

    def profile_from_here():
        mcoll.ALLTOALL.update({k: ranged(f) for k, f in algos.items()})

    try:
        tr = _trace.traced_window(torch, lambda i: step(st, i),
                                  st.next_step, ctx.seconds, PROFILED_STEPS,
                                  ctx.sync, on_profile=profile_from_here,
                                  window=ctx.window)
    finally:
        mcoll.ALLTOALL.update(algos)
    st.next_step = tr["next_step"]
    tr["ranges"] = {A2A_RANGE: _trace.range_kernel_s(tr["profile"],
                                                     A2A_RANGE)}
    return tr


def reference_grads(ctx):
    """``grads_of`` for ``trainlib.reference_steps``: the whole batch
    through the plain decoder expert parallel over the grid."""
    torch = ctx.torch
    from portbench.reference import model as ref_model

    def grads_of(wt, batch, prec):
        w = {p: v.detach().requires_grad_() for p, v in wt.items()}
        loss, info = ref_model.forward_loss(
            w, batch["tokens"], batch["labels"], ctx.cfg, prec,
            ep=tuple(ctx.grid), z_loss=ctx.traffic["z_loss"])
        gs = torch.autograd.grad(loss, list(w.values()))
        return info["loss"], dict(zip(w, gs))
    return grads_of


def control(ctx):
    """The control: ``trainlib.control`` with this mix's reference."""
    return trainlib.control(ctx, reference_grads)


def check(st, ctx):
    return trainlib.check(st, ctx, reference_grads)
