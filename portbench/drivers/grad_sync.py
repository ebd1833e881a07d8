"""Traffic: the bucketed data-parallel gradient sync alone, back to back.

The program's ``OverlappedGradSync`` (one persistent allreduce a bucket,
error feedback carried per bucket) over a ``RankGrid`` of the
configuration's layout, fed one stacked float32 gradient ``(world, n)``
drawn from the seed in set-up; the carried error makes each step's input
differ. A step is ``ensure_ops(step)`` and ``sync(buckets, metrics)``, as
a training step calls them.

Correctness: set-up drives the sync through its first ``CHECK_STEPS``
steps from a zero error and keeps, for buckets drawn from the seed (the
last, shorter one always among them), each step's result and new error;
after the window one more step runs from the program's own carried error,
kept likewise. The plain reference (``reference/codec.py``) follows the
first steps from a zero error, and the post-window step from the error the
program carried into it. Numbers (the worst over buckets and steps):
``out_rel`` and ``err_rel``, the L2 norm of the difference from the
reference over the reference's, of the results (every rank's row) and of
the new errors; ``out_max_rel``, the largest absolute difference of a
result over the reference's largest; ``metrics_abs``, the lossless
metric allreduce's largest difference from the exact sum.
"""
from __future__ import annotations

import gc
import random
import time
import types

CHECK_STEPS = 3
#: full buckets drawn from the seed for the check (the last one besides)
SAMPLED = 3
#: steps profiled after the traced run's untraced window
PROFILED_STEPS = 2
#: steps after the profiled ones, each started on an idle device, whose
#: sync calls are timed on the host from call to return
HOST_STEPS = 20


def _slices(n: int, bucket_elems: int):
    return [(s, min(bucket_elems, n - s)) for s in range(0, n, bucket_elems)]


def setup(ctx):
    torch = ctx.torch
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.train import manual_step as ms

    from portbench import weights

    tr, dev = ctx.traffic, ctx.device
    n = weights.n_params(ctx.cfg)
    grid = RankGrid(ctx.grid[0], ctx.grid[1], dev)
    world = grid.world
    comm = Communicator(grid)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    grads = torch.empty((world, n), dtype=torch.float32, device=dev)
    grads.normal_(0.0, tr["grad_std"], generator=gen)
    slices = _slices(n, tr["bucket_bytes"] // 4)
    buckets = [grads[:, s:s + k] for s, k in slices]
    gs = ms.OverlappedGradSync(comm, slices, metric_len=4, algo=tr["algo"],
                               codec=tr["codec"],
                               error_budget=tr["error_budget"])
    mvec = torch.arange(world * 4, dtype=torch.float32,
                        device=dev).reshape(world, 4)
    rng = random.Random(ctx.seed)
    full = list(range(len(slices) - 1))
    picked = sorted(rng.sample(full, min(SAMPLED, len(full)))) \
        + [len(slices) - 1]
    st = types.SimpleNamespace(
        grid=grid, comm=comm, grads=grads, slices=slices, buckets=buckets,
        gs=gs, mvec=mvec, picked=picked, kept=[], post=None,
        check_steps=CHECK_STEPS + 1, next_step=CHECK_STEPS, metric_err=0.0)
    fault = ctx.hooks.get("fault")
    if fault:
        fault(st, ctx)
    for step in range(CHECK_STEPS):
        out, errs = _kept_step(st, step)
        st.kept.append((out, errs))
    return st


def _sync(st, step):
    st.gs.ensure_ops(step)
    return st.gs.sync(st.buckets, st.mvec)


def _kept_step(st, step):
    synced, msum = _sync(st, step)
    want = st.mvec.sum(0, keepdim=True).expand_as(st.mvec)
    st.metric_err = max(st.metric_err,
                        float((msum - want).abs().max()))
    out = [synced[b].clone() for b in st.picked]
    errs = [_err(st, b) for b in st.picked]
    return out, errs


def _err(st, b):
    e = st.gs.errs[b] if st.gs.errs else None
    return None if e is None else e.clone()


def step(st, i):
    _sync(st, i)


def after_window(st, ctx):
    """One more step through the same call, from the program's own
    carried error, kept for the check."""
    i = st.next_step
    before = [_err(st, b) for b in st.picked]
    out, errs = _kept_step(st, i)
    st.post = (before, out, errs)


def trace(st, ctx):
    """An untraced window of ``ctx.seconds``, then ``PROFILED_STEPS``
    steps under the profiler with the shape of every codec launch
    recorded (the recording put in place only for them), then
    ``HOST_STEPS`` steps each started after a synchronize, whose sync
    calls are timed on the host from call to return: the host's own cost,
    which a window that dispatches ahead cannot show (a call there may
    wait for room in the launch queue)."""
    from repro_torch.kernels import codec as kcodec

    from portbench import trace as _trace

    host, enc, dec = [], [], []
    _encode, _decode = kcodec._encode, kcodec._decode

    def encode(codec, plain, launch, x, err=None):
        L = int(x.shape[-1])
        enc.append((codec, x.numel() // max(L, 1), L, err is not None))
        return _encode(codec, plain, launch, x, err)

    def decode(codec, plain, launch, comp, length):
        sc = comp["scale"]
        W, nb = int(sc.shape[-2]), int(sc.shape[-1])
        dec.append((codec, sc.numel() // max(W * nb, 1), W, nb, int(length)))
        return _decode(codec, plain, launch, comp, length)

    def profile_from_here():
        kcodec._encode, kcodec._decode = encode, decode

    try:
        tr = _trace.traced_window(ctx.torch, lambda i: _sync(st, i),
                                  st.next_step, ctx.seconds,
                                  PROFILED_STEPS, ctx.sync,
                                  on_profile=profile_from_here,
                                  window=ctx.window)
    finally:
        kcodec._encode, kcodec._decode = _encode, _decode
    i = tr["next_step"]
    for k in range(HOST_STEPS):
        ctx.sync()
        t0 = time.perf_counter()
        _sync(st, i + k)
        host.append(time.perf_counter() - t0)
    ctx.sync()
    st.next_step = tr["next_step"] = i + HOST_STEPS
    tr.update(host_sync_s=host, buckets=len(st.slices), encodes=enc,
              decodes=dec, n_params=st.grads.shape[1], world=st.grid.world,
              extra_steps=HOST_STEPS)
    return tr


def control(ctx, codec: str = "int4"):
    """The control: the plain reference at ``codec``, the next precision
    down, in the program's place, judged as :func:`check` judges the
    program (the same gradient, buckets and steps)."""
    torch = ctx.torch
    from portbench import weights
    from portbench.reference import codec as ref

    tr, dev = ctx.traffic, ctx.device
    n_nodes, n_local = ctx.grid
    world = n_nodes * n_local
    n = weights.n_params(ctx.cfg)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    grads = torch.empty((world, n), dtype=torch.float32, device=dev)
    grads.normal_(0.0, tr["grad_std"], generator=gen)
    slices = _slices(n, tr["bucket_bytes"] // 4)
    rng = random.Random(ctx.seed)
    full = list(range(len(slices) - 1))
    picked = sorted(rng.sample(full, min(SAMPLED, len(full)))) \
        + [len(slices) - 1]
    want = tr["codec"].split("_")[0]
    out_rel = err_rel = out_max = 0.0
    for b in picked:
        s, k = slices[b]
        x = grads[:, s:s + k].clone()
        e_c = e_r = torch.zeros_like(x)
        for step in range(CHECK_STEPS + 1):
            if step == CHECK_STEPS:
                e_r = e_c  # the post-window step: from the control's error
            o_c, e_c = ref.allreduce(x, e_c, n_nodes, n_local, codec)
            o_r, e_r = ref.allreduce(x, e_r, n_nodes, n_local, want)
            out_rel = max(out_rel, _rel(o_c, o_r))
            out_max = max(out_max, _max_rel(o_c, o_r))
            err_rel = max(err_rel, _rel(e_c, e_r))
    return {"out_rel": out_rel, "out_max_rel": out_max, "err_rel": err_rel,
            "metrics_abs": 0.0}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm()
                 .clamp_min(1e-30))


def _max_rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def check(st, ctx):
    """Frees the program's state, then runs the reference."""
    torch = ctx.torch
    from portbench.reference import codec as ref

    n_nodes, n_local = ctx.grid
    codec = ctx.traffic["codec"].split("_")[0]  # int8_block -> int8
    inputs = {b: st.buckets[b].clone() for b in st.picked}
    kept, post, metric_err = st.kept, st.post, st.metric_err
    st.gs.release()
    del st.gs, st.buckets, st.grads
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out_rel = err_rel = out_max = 0.0

    def judge(pairs):
        nonlocal out_rel, err_rel, out_max
        for (o_p, e_p), (o_r, e_r) in pairs:
            out_rel = max(out_rel, _rel(o_p, o_r))
            out_max = max(out_max, _max_rel(o_p, o_r))
            err_rel = max(err_rel, 1.0 if e_p is None else _rel(e_p, e_r))

    for j, b in enumerate(st.picked):
        x = inputs[b]
        err = torch.zeros_like(x)
        pairs = []
        for k in range(CHECK_STEPS):
            out, err = ref.allreduce(x, err, n_nodes, n_local, codec)
            pairs.append(((kept[k][0][j], kept[k][1][j]), (out, err)))
        before, o_p, e_p = post[0][j], post[1][j], post[2][j]
        start = torch.zeros_like(x) if before is None else before
        pairs.append(((o_p, e_p), ref.allreduce(x, start, n_nodes, n_local,
                                                codec)))
        judge(pairs)
    return {"out_rel": out_rel, "out_max_rel": out_max, "err_rel": err_rel,
            "metrics_abs": metric_err}
