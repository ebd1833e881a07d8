"""Manual-collective training steps: the collectives of ``core.mcoll``
wired into the data-parallel gradient sync (port of
``repro.train.manual_step``).

A gradient is held STACKED and FLAT: one ``(world, n_params)`` buffer whose
row ``d`` is rank ``d``'s gradient and whose columns are the leaves in the
reference's flatten order (``models.params.param_shapes``; leaves are views
into the buffer). A bucket is then a column window of that buffer, so the
bucket flatten copies nothing. On a ``ProcessGrid`` each process holds
only its own ranks' rows, ``(grid.rows, n_params)``, and computes only
those ranks' gradients.

The sync half:

  * :func:`sync_tree_bucketed` runs ``sync_fn(bucket, err) -> (synced,
    new_err)`` once per ``bucket_bytes`` window;
  * :class:`OverlappedGradSync` holds one persistent allreduce op per
    bucket (plan resolved and buffers allocated once, reused every step)
    plus one for the packed scalar metrics; buckets whose plan carries a
    codec thread per-bucket error-feedback state through carry ops.

The steps around it (each rank's forward and backward on its shard of the
batch, one after another on the grid's device, then the sync, then
``optim.adamw.update``; the weights and the AdamW state are updated in
place):

  * :func:`make_manual_train_step`, the fused barrier-style step: every
    rank's gradient into its row, then the bucketed sync with per-bucket
    error feedback (or one sync per leaf with ``bucketed=False``), the loss
    and the scalar metrics synced lossless;
  * :func:`make_overlapped_train_step`, the persistent nonblocking step, in
    two decompositions: ``"monolithic"`` (one backward emits every bucket,
    then ``OverlappedGradSync.sync``) and ``"segmented"`` (a forward that
    records the hidden state at each segment boundary, then the head's,
    each segment's, newest to oldest, and the embedding's backward, with
    bucket ``i``'s persistent op started between segments). ``overlap=
    False`` is the barrier twin of either: the same ops and the same
    arithmetic, so the two agree bitwise.

Plans resolve through the selection subsystem (``algo="auto"``) or are
pinned (``algo=``, ``chunks=``, ``codec=``); ``error_budget`` (a float or,
for the overlapped step, a schedule ``callable(step)``) admits
error-bounded codecs. Metrics always sync lossless. The reference's
``donate`` knob has no counterpart: nothing here is donated.

Telemetry (``core.telemetry``). Spans, which are also profiler ranges
whenever a profiler records: the fused step's ``train/fwd_bwd`` (each held
rank's forward, backward and gather), ``train/grad_sync`` (holding a
``sync/bucket`` a bucket), ``train/metric_sync`` (the lossless loss and
metric syncs) and ``adamw.update``'s ``train/optimizer``; its blocking
reads ``host_read/train_shard_index`` and ``host_read/train_lr``; a
``sync/bucket`` around each ``OverlappedGradSync.start``; the overlapped
step's stages (``train/step``, with ``mode`` and ``overlap``, and inside it
``train/fwd``, ``train/head_bwd``, ``train/chunk_bwd[k]``,
``train/embed_bwd``, or ``train/backward``, and ``train/apply``). On only
when enabled: each bucket's start->wait window on its own ``bucket:<i>``
track, a ``bucket_rebuild`` instant and the ``train.bucket_rebuilds``
counter when a plan change rebuilds the ops, and, one wait in
``telemetry.SAMPLE_EVERY`` per bucket, the error-feedback probe
(:meth:`OverlappedGradSync._observe_ef`), the only hook that reads device
values.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core import autotune, costmodel, mcoll, runtime
from repro_torch.core import compress as codecs
from repro_torch.core import telemetry as _tm
from repro_torch.core.comm import Communicator
from repro_torch.core.topology import Topology
from repro_torch.models.decoder import DecoderLM, n_cycles
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.train.step import (Batch, TrainConfig, cross_entropy,
                                    value_and_grad)

#: default gradient bucket size — large enough that the pipelined allreduce
#: is the modeled winner, small enough to bound the per-bucket buffers
DEFAULT_BUCKET_BYTES = 4 << 20


def _resolve_plan(topo: Topology, nbytes: int, dtype, algo: str,
                  chunks: Optional[int], codec: Optional[str],
                  error_budget: float) -> Tuple[str, dict]:
    """(algorithm, kwargs) plan for one allreduce payload.

    ``algo="auto"`` takes the selector's full (algo, chunks, codec) plan
    under the error budget. A pinned ``algo`` with ``codec=None`` and a
    positive budget picks the cheapest admissible codec for that algorithm
    via the cost model."""
    net = costmodel.net_for(topo)
    name, c, cd = algo, chunks, codec
    if name == "auto":
        sel = autotune.default_selector().choose(
            "allreduce", topo, nbytes, net=net,
            dtype=runtime.dtype_name(dtype), error_budget=error_budget)
        name = sel.algo
        if c is None:
            c = sel.chunks
        if cd is None:
            cd = sel.codec
    elif cd is None and error_budget > 0.0 and \
            mcoll.supports_codec("allreduce", name):
        cands = codecs.for_budget(error_budget)
        if cands:
            cd = min(cands,
                     key=lambda k: costmodel.plan_cost(
                         "allreduce", name, topo, nbytes, net,
                         chunks=c or 1, codec=k).time)
    kw = {}
    if c and mcoll.supports_chunks("allreduce", name):
        kw["chunks"] = int(c)
    if cd and cd != codecs.NONE and mcoll.supports_codec("allreduce", name):
        kw["codec"] = cd
    return name, kw


def _comm_topo(grid, topo) -> Communicator:
    """The step's communicator: ``topo`` itself when it is a
    :class:`Communicator` on ``grid`` (the root, or a ``comm.split(axes=
    ...)`` child: its group is then the data-parallel domain, over which
    the batch is sharded and gradients are mean-reduced), else a root
    communicator on ``grid`` with the topology ``topo`` (None: the grid's
    own)."""
    if isinstance(topo, Communicator):
        if topo.grid is not grid and topo.grid != grid:
            raise ValueError("the group communicator's grid must be the "
                             "step's grid")
        return topo
    return Communicator(grid, topo)


def _shards(comm, batch: Batch) -> List[Batch]:
    """Each held row's shard of the global batch: its index along the
    group's axes picks one of ``topo.world`` equal slices of dim 0."""
    world = comm.topo.world
    B = batch["tokens"].shape[0]
    if B % world:
        raise ValueError(f"global batch of {B} does not shard over "
                         f"{world} ranks")
    b = B // world
    with _tm.host_read("train_shard_index"):
        idx = comm.grid.axis_index(comm.topo.active_axes).tolist()
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()
             if v is not None} for i in idx]


def _make_grad_sync(comm, algo: str, chunks: Optional[int],
                    codec: Optional[str], error_budget: float):
    """Mean-allreduce of one stacked ``(world, n)`` bucket with
    error-feedback threading: ``sync(x, err) -> (mean, new_err)``. When the
    resolved plan is lossless (or no state is given), ``err`` passes
    through. A payload size's plan is resolved on its first call and kept,
    as the reference bakes it into its jitted step."""
    topo, grid = comm.topo, comm.grid
    plans = {}

    def sync(v, err):
        g = v.float().reshape(v.shape[0], -1)
        nbytes = g[0].numel() * 4
        if nbytes not in plans:
            plans[nbytes] = _resolve_plan(topo, nbytes, g.dtype, algo,
                                          chunks, codec, error_budget)
        name, kw = plans[nbytes]
        fn = mcoll.algorithm("allreduce", name)
        if kw.get("codec") and err is not None:
            out, err = fn(g, topo, grid, err=err, **kw)
        else:
            out = fn(g, topo, grid, **kw)
        return (out / topo.world).reshape(v.shape), err

    return sync


def bucket_slices(total: int, bucket_elems: int) -> List[Tuple[int, int]]:
    """(start, length) windows covering [0, total) in fixed-size buckets
    (the last bucket carries the remainder)."""
    if total <= 0:
        return []
    b = max(1, int(bucket_elems))
    return [(s, min(b, total - s)) for s in range(0, total, b)]


def sync_tree_bucketed(flat: torch.Tensor, sync_fn, bucket_bytes: int,
                       err_state=None, out: Optional[torch.Tensor] = None):
    """Run ``sync_fn(bucket, err) -> (synced, new_err)`` over the
    ``bucket_bytes`` column windows of the stacked flat gradient ``flat``
    ``(world, n_params)``. Returns ``(synced (world, n_params),
    new_err_state)``; ``err_state`` is a tuple of per-bucket buffers (from
    :func:`init_error_state`) or empty for lossless sync. ``out`` (may be
    ``flat`` itself: each bucket is read before its result is written)
    receives the result; without it a new buffer does. Elementwise
    reductions make the result bit-identical to syncing each leaf with the
    same algorithm."""
    slices = bucket_slices(flat.shape[1], max(1, int(bucket_bytes) // 4))
    errs = list(err_state) if err_state else [None] * len(slices)
    if len(errs) != len(slices):
        raise ValueError(f"error state has {len(errs)} buckets, payload "
                         f"needs {len(slices)}")
    if out is None:
        out = torch.empty(flat.shape, dtype=torch.float32,
                          device=flat.device)
    new_errs = []
    for (start, n), e in zip(slices, errs):
        with _tm.span("sync/bucket", cat="sync"):
            y, e2 = sync_fn(flat[:, start:start + n], e)
            out[:, start:start + n] = y
        new_errs.append(e2)
    return out, tuple(e for e in new_errs if e is not None)


def init_error_state(n_params: int, comm, error_budget: float = 0.0,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """Per-bucket error-feedback buffers: zero ``(world, bucket_len)`` views
    into ONE ``(world, n_params)`` float32 buffer on the grid's device,
    matching :func:`bucket_slices`. Empty when the budget is 0 — lossless
    sync carries nothing between steps."""
    if error_budget <= 0.0:
        return ()
    return _error_views(comm, bucket_slices(
        int(n_params), max(1, int(bucket_bytes) // 4)))


def _error_views(comm, slices) -> Tuple[torch.Tensor, ...]:
    total = sum(n for _, n in slices)
    buf = torch.zeros((comm.grid.rows, total), dtype=torch.float32,
                      device=comm.grid.device)
    views, off = [], 0
    for _, n in slices:
        views.append(buf[:, off:off + n])
        off += n
    return tuple(views)


class OverlappedGradSync:
    """Per-bucket persistent allreduce ops for the overlapped step.

    One ``PersistentOp`` per gradient bucket plus one for the packed
    scalar-metrics vector (always lossless). ``error_budget`` is a float or
    a schedule ``callable(step) -> float``; ops are rebuilt only when a
    bucket's resolved plan changes (old ops released first), counted in
    ``rebuilds``.

    Buckets whose plan carries a codec ride carry ops: ``errs[i]`` is the
    bucket's error-feedback state, a view into one ``(world, n)`` buffer,
    updated in place by each start and reset to zeros when a plan change
    rebuilds the ops (``None`` for lossless buckets). Results are sums over
    ranks; the caller divides by the world size.
    """

    def __init__(self, comm, slices: List[Tuple[int, int]], metric_len: int,
                 algo: str = "auto", chunks: Optional[int] = None,
                 codec: Optional[str] = None, error_budget=0.0):
        self.comm = comm
        self.slices = list(slices)
        self.metric_len = int(metric_len)
        self.algo, self.chunks, self.codec = algo, chunks, codec
        self.error_budget = error_budget
        self.rebuilds = 0
        self._plans: Optional[List[Tuple[str, dict]]] = None
        self._last_budget: Optional[float] = None
        self._ops: List = []
        self.errs: List = []
        self._metric_op = None
        self._btokens: List = []  # open per-bucket telemetry windows

    def budget_at(self, step: int) -> float:
        if callable(self.error_budget):
            return float(self.error_budget(int(step)))
        return float(self.error_budget)

    def plans(self) -> List[str]:
        """Current per-bucket plan keys (``algo#cN@codec``)."""
        return [op.plan for op in self._ops]

    def _resolve(self, budget: float) -> List[Tuple[str, dict]]:
        topo = self.comm.topo
        return [_resolve_plan(topo, n * 4, torch.float32, self.algo,
                              self.chunks, self.codec, budget)
                for _, n in self.slices]

    def ensure_ops(self, step: int) -> None:
        """Re-resolve the per-bucket plan for this step's budget; rebuild
        the persistent ops only when a plan actually changed."""
        budget = self.budget_at(step)
        if self._plans is not None and budget == self._last_budget:
            return
        self._last_budget = budget
        plans = self._resolve(budget)
        if plans == self._plans:
            return
        for op in self._ops:
            op.release()
        self._ops, self.errs = [], []  # free the old buffers first
        world = self.comm.grid.rows  # a ProcessGrid: this process's ranks
        self._ops = [
            self.comm.allreduce_init(
                shape=(world, n), dtype=torch.float32, algo=name,
                chunks=kw.get("chunks"), codec=kw.get("codec"),
                carry=bool(kw.get("codec"))
                and runtime.supports_carry("allreduce", name))
            for (_, n), (name, kw) in zip(self.slices, plans)]
        carried = [s for s, op in zip(self.slices, self._ops) if op.carry]
        views = iter(_error_views(self.comm, carried))
        self.errs = [next(views) if op.carry else None for op in self._ops]
        if self._metric_op is None:
            mname, mkw = _resolve_plan(self.comm.topo, self.metric_len * 4,
                                       torch.float32, self.algo, self.chunks,
                                       None, 0.0)
            self._metric_op = self.comm.allreduce_init(
                shape=(world, self.metric_len), dtype=torch.float32,
                algo=mname, chunks=mkw.get("chunks"))
        self._btokens = [None] * len(self._ops)
        if self._plans is not None:
            self.rebuilds += 1
            _tm.counter("train.bucket_rebuilds").inc()
            if _tm.enabled():
                _tm.instant("bucket_rebuild", cat="train", step=int(step),
                            budget=budget,
                            plans=",".join(op.plan for op in self._ops))
        self._plans = plans

    def release(self) -> None:
        """Release every persistent op and drop the error state, so their
        buffers can be freed before another sync is built; the next
        ``ensure_ops`` builds everything anew."""
        for op in self._ops + [self._metric_op]:
            if op is not None:
                op.release()
        self._ops, self.errs, self._metric_op = [], [], None
        self._btokens = []
        self._plans = self._last_budget = None

    def start(self, i: int, payload):
        """Start bucket ``i``'s persistent allreduce (threading its EF
        carry when the plan compresses); returns the handle."""
        op = self._ops[i]
        if _tm.enabled():
            # the bucket's start->wait window, one track per bucket
            self._btokens[i] = _tm.begin(
                f"bucket{i}[{op.plan}]", cat="bucket", track=f"bucket:{i}",
                bucket=i, **op._tags())
        with _tm.span("sync/bucket", cat="sync"):
            if op.carry:
                return op.start(payload, carry=self.errs[i])
            return op.start(payload)

    def wait(self, i: int, handle, block: bool = False):
        """Complete bucket ``i``: returns the reduced payload and absorbs
        the new error-feedback state for carry buckets."""
        op = self._ops[i]
        if op.carry:
            y, self.errs[i] = handle.wait(block=block)
            self._close_bucket(i)
            if _tm.should_sample(f"ef:{id(self)}:{i}"):
                self._observe_ef(op, y, self.errs[i])
            return y
        y = handle.wait(block=block)
        self._close_bucket(i)
        return y

    def _close_bucket(self, i: int) -> None:
        if self._btokens and self._btokens[i] is not None:
            _tm.end(self._btokens[i])
            self._btokens[i] = None

    @staticmethod
    def _observe_ef(op, y, new_err) -> None:
        """Sampled codec-quality probe (telemetry on, one wait in
        ``telemetry.SAMPLE_EVERY``): the carry's max-abs over the result's,
        beside the codec's stated bound, and the achieved wire ratio on the
        reduced payload. The only telemetry site that reads device values
        to the host, which is why it hides behind ``should_sample``; the
        two max-abs values go to pinned host memory behind an event and are
        recorded later (``telemetry.defer``), so the probe never waits on
        the card."""
        inf = float("inf")  # the max-abs, one pass and no temporary
        amax = torch.stack([torch.linalg.vector_norm(y, inf),
                            torch.linalg.vector_norm(new_err, inf)]).float()
        event = None
        if amax.is_cuda:
            host = torch.empty(2, dtype=torch.float32, pin_memory=True)
            host.copy_(amax, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            amax = host
        ratio = codecs.codec(op.codec).achieved_ratio(y)
        bound = codecs.meta(op.codec).error_bound

        def observe(block: bool) -> bool:
            if event is not None and not event.query():
                if not block:
                    return False
                event.synchronize()
            amax_y, amax_e = amax.tolist()
            _tm.observe_ef_error(op.codec, amax_e / (amax_y + 1e-30), bound)
            _tm.observe_codec_ratio(op.codec, ratio)
            return True
        _tm.defer(observe)

    def run(self, i: int, payload):
        """Barrier-style bucket ``i``: start and block out the wait."""
        return self.wait(i, self.start(i, payload), block=True)

    def start_metric(self, mvec):
        return self._metric_op.start(mvec)

    def sync(self, buckets, mvec, overlap: bool = True):
        """Allreduce every bucket + the metrics vector. ``overlap=True``
        starts everything, then waits; ``overlap=False`` completes each
        bucket before starting the next. Same ops, bit-identical results."""
        if overlap:
            handles = [self.start(i, b) for i, b in enumerate(buckets)]
            mh = self.start_metric(mvec)
            synced = [self.wait(i, h, block=False)
                      for i, h in enumerate(handles)]
            return synced, mh.wait(block=False)
        synced = [self.run(i, b) for i, b in enumerate(buckets)]
        return synced, self.start_metric(mvec).wait(block=True)


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

#: ``loss_fn``'s scalar metrics, sorted: the packed metrics vector is
#: ``[loss, aux, ce, tokens]``
METRIC_KEYS = ("aux", "ce", "tokens")


def _pack(tensors, out: torch.Tensor) -> None:
    """``tensors`` flattened one after another into the float32 row
    ``out`` (None as zeros)."""
    off = 0
    for t, w in tensors:
        seg = out[off:off + w.numel()]
        seg.zero_() if t is None else seg.copy_(t.reshape(-1))
        off += w.numel()


def _metric_row(loss, metrics) -> torch.Tensor:
    return torch.stack([loss.float()] + [metrics[k].float()
                                         for k in METRIC_KEYS])


class _Model:
    """The weights' flat layout of the model a step last saw, kept while
    the step sees the same model."""

    def __init__(self):
        self.model, self.flat = None, None

    def of(self, model) -> FlatParams:
        if model is not self.model:
            model.trainable()
            self.model, self.flat = model, FlatParams.of(model)
        return self.flat


def make_manual_train_step(cfg, tcfg: TrainConfig, grid, topo=None,
                           algo: str = "auto", error_budget: float = 0.0,
                           bucketed: bool = True,
                           bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                           chunks: Optional[int] = None,
                           codec: Optional[str] = None):
    """The fused barrier-style data-parallel step over the communicator's
    group (``topo``: a :class:`Topology`, None for the grid's own, or a
    :class:`Communicator`, a ``comm.split(axes=...)`` child among them).

    ``step(model, opt_state, err_state, batch) -> (err_state, metrics)``:
    every held rank's forward and backward on its shard of the global
    ``batch`` into its row of one ``(rows, n_params)`` float32 buffer
    (kept by the step between calls), the bucketed mean-allreduce with
    per-bucket error feedback (``err_state`` from :func:`init_error_state`,
    updated in place and returned; ``()`` when lossless), or one sync per
    leaf with ``bucketed=False`` (stateless), then ``adamw.update`` of the
    model and ``opt_state`` in place from the first held row. The loss and
    every scalar metric are synced lossless (means over the group).
    ``algo``/``chunks``/``codec``/``error_budget`` as in
    :func:`_resolve_plan`."""
    comm = _comm_topo(grid, topo)
    grad_sync = _make_grad_sync(comm, algo, chunks, codec, error_budget)
    metric_sync = _make_grad_sync(comm, algo, chunks, None, 0.0)
    sync_mean = lambda v: metric_sync(v, None)[0]  # lossless, no state
    held = _Model()
    buf: List[torch.Tensor] = []

    def bucket_sync(v, e):
        y, e2 = grad_sync(v, e)
        if e is not None and e2 is not e:
            e.copy_(e2)  # the carried state in place: one buffer, not two
        return y, e

    def step(model, opt_state, err_state, batch):
        if model.cfg != cfg:
            raise ValueError(f"step built for {cfg.name}, model is "
                             f"{model.cfg.name}")
        flat = held.of(model)
        rows = comm.grid.rows
        if not buf or buf[0].shape != (rows, flat.n):
            buf[:] = [torch.empty((rows, flat.n), dtype=torch.float32,
                                  device=comm.grid.device)]
        g = buf[0]
        per_rank = []
        for r, mb in enumerate(_shards(comm, batch)):
            with _tm.span("train/fwd_bwd", cat="train"):
                loss, metrics, grads = value_and_grad(model, flat, mb, tcfg)
                flat.gather(grads, out=g[r])
                del grads
            per_rank.append((loss, metrics))
        with _tm.span("train/grad_sync", cat="train"):
            if bucketed:
                g, err_state = sync_tree_bucketed(g, bucket_sync,
                                                  bucket_bytes, err_state,
                                                  out=g)
            else:
                for _, s, e, _ in flat.spans:
                    g[:, s:e] = grad_sync(g[:, s:e], None)[0]
        with _tm.span("train/metric_sync", cat="train"):
            loss = sync_mean(torch.stack([l for l, _ in per_rank])[:, None])
        om = adamw.update(flat, g[0], opt_state, tcfg.optimizer)
        out = {}
        with _tm.span("train/metric_sync", cat="train"):
            for k in METRIC_KEYS + ("grad_norm", "lr", "loss"):
                if k == "loss":
                    v = loss[:, 0]
                elif k in om:
                    v = om[k]
                    if v.device != g.device:  # the lr, made on the host
                        with _tm.host_read("train_" + k):
                            v = v.to(g.device)
                    v = v.expand(rows)
                else:
                    v = torch.stack([m[k] for _, m in per_rank])
                out[k] = sync_mean(v.float()[:, None])[0, 0]
        return err_state, out

    return step


class _OverlappedStep:
    """Callable train step built by :func:`make_overlapped_train_step`.

    Builds its buckets and persistent ops from the first ``(model, batch)``
    it sees. Two decompositions (``.mode`` after the first call):

    * ``"monolithic"``: every held rank's backward into its row of one
      ``(rows, n_params)`` buffer, whose ``bucket_bytes`` column windows
      are the buckets, then ``OverlappedGradSync.sync``;
    * ``"segmented"``: segments of whole pattern cycles sized so one
      segment's weights fill about ``bucket_bytes`` of float32 (``.bounds``;
      at least one cycle each); a forward records the hidden state entering
      each segment, then the head's backward (bucket 0: final norm and LM
      head, with the loss and metrics), each segment's, newest to oldest
      (buckets 1..K), and the embedding's (bucket K+1), each segment's
      backward recomputing its forward from the recorded state; bucket
      ``i``'s persistent op starts as soon as its backward is done. For the
      decoder family with ``microbatches == 1`` and no frontend embeds
      (:meth:`_segment_support`); gradients agree with the monolithic
      decomposition within rounding, not bitwise (each segment's backward
      recomputes its forward).

    ``overlap=False`` waits out each bucket before the next is computed:
    the same ops on the same operands, so its results are bitwise the
    overlapped step's.
    """

    def __init__(self, cfg, tcfg: TrainConfig, grid, topo, algo: str,
                 error_budget, bucket_bytes: int, chunks: Optional[int],
                 codec: Optional[str], overlap: bool, segmented="auto"):
        self.cfg, self.tcfg = cfg, tcfg
        self.comm = _comm_topo(grid, topo)
        self.topo = self.comm.topo
        self.overlap = bool(overlap)
        self._knobs = (algo, chunks, codec)
        self._budget = error_budget
        self.bucket_bytes = int(bucket_bytes)
        self.segmented = segmented
        self.mode: Optional[str] = None
        self.grad_sync: Optional[OverlappedGradSync] = None
        self.bounds: List[Tuple[int, int]] = []
        self._auto_step = 0
        self._held = _Model()
        self._flat: Optional[FlatParams] = None
        self._slices: List[Tuple[int, int]] = []
        self._buf: Optional[torch.Tensor] = None
        # segmented: per bucket, the flat ranges it fills, in bucket order
        self._ranges: List[List[Tuple[int, int]]] = []

    # -- build ---------------------------------------------------------------

    def _segment_support(self, model, batch) -> Optional[str]:
        """None when the segmented decomposition applies, else why not."""
        if getattr(self.cfg, "family", None) == "encdec":
            return "encoder-decoder family"
        if self.tcfg.microbatches != 1:
            return "microbatch gradient accumulation"
        if not isinstance(model, DecoderLM):
            return "non-decoder parameter tree"
        if batch.get("embeds") is not None:
            return "frontend embeds in the batch"
        return None

    def _build(self, model, batch) -> None:
        why_not = self._segment_support(model, batch)
        if self.segmented is True and why_not is not None:
            raise ValueError(f"segmented=True but the segmented backward "
                             f"does not apply here: {why_not}")
        self.mode = ("segmented" if self.segmented and why_not is None
                     else "monolithic")
        flat = self._flat = self._held.of(model)
        if self.mode == "monolithic":
            self._slices = bucket_slices(flat.n,
                                         max(1, self.bucket_bytes // 4))
            sizes = [n for _, n in self._slices]
        else:
            nc = n_cycles(self.cfg)
            cycle = sum(e - s for p, s, e, _ in flat.spans
                        if p.startswith("groups/")) // nc
            seg = min(nc, max(1, (self.bucket_bytes // 4) // max(1, cycle)))
            self.bounds = [(lo, min(lo + seg, nc))
                           for lo in range(0, nc, seg)]
            self._ranges = (
                [[flat.leaf("final_norm/scale"), flat.leaf("lm_head")]]
                + [flat.cycles(lo, hi)[1] for lo, hi in reversed(self.bounds)]
                + [[flat.leaf("embed")]])
            sizes = [sum(e - s for s, e in r) for r in self._ranges]
        algo, chunks, codec = self._knobs
        self.grad_sync = OverlappedGradSync(
            self.comm, [(0, n) for n in sizes], len(METRIC_KEYS) + 1,
            algo=algo, chunks=chunks, codec=codec,
            error_budget=self._budget)

    # -- the step ------------------------------------------------------------

    def _apply(self, opt_state, synced, mvec):
        """Mean gradient from the first held row of the synced buckets,
        AdamW, and the synced metrics."""
        flat, world = self._flat, self.topo.world
        with _tm.span("train/apply", cat="train"):
            g = torch.empty(flat.n, dtype=torch.float32,
                            device=self.comm.grid.device)
            if self.mode == "monolithic":
                for (s, n), y in zip(self._slices, synced):
                    torch.div(y[0], world, out=g[s:s + n])
            else:
                for ranges, y in zip(self._ranges, synced):
                    off = 0
                    for s, e in ranges:
                        torch.div(y[0, off:off + e - s], world, out=g[s:e])
                        off += e - s
            om = adamw.update(flat, g, opt_state, self.tcfg.optimizer)
            mv = mvec[0] / world
            metrics = {k: mv[i + 1] for i, k in enumerate(METRIC_KEYS)}
            return dict(metrics, **om, loss=mv[0])

    def _monolithic(self, model, opt_state, batch):
        gs, flat = self.grad_sync, self._flat
        rows = self.comm.grid.rows
        if self._buf is None or self._buf.shape != (rows, flat.n):
            self._buf = torch.empty((rows, flat.n), dtype=torch.float32,
                                    device=self.comm.grid.device)
        g = self._buf
        with _tm.span("train/backward", cat="train"):
            mrows = []
            for r, mb in enumerate(_shards(self.comm, batch)):
                loss, metrics, grads = value_and_grad(model, flat, mb,
                                                      self.tcfg)
                flat.gather(grads, out=g[r])
                del grads
                mrows.append(_metric_row(loss, metrics))
            mvec = torch.stack(mrows)
        synced, mvec = gs.sync([g[:, s:s + n] for s, n in self._slices],
                               mvec, overlap=self.overlap)
        return self._apply(opt_state, synced, mvec)

    def _segmented(self, model, opt_state, batch):
        """Backward newest to oldest, bucket ``i``'s op started before
        segment ``i+1``'s backward is computed (or, ``overlap=False``,
        waited out first)."""
        gs, flat, tcfg = self.grad_sync, self._flat, self.tcfg
        flags, cfg = tcfg.flags, self.cfg
        moe_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
        shards = _shards(self.comm, batch)
        rows, dev = len(shards), self.comm.grid.device
        K = len(self.bounds)
        bucket = lambda i: torch.empty(
            (rows, sum(e - s for s, e in self._ranges[i])),
            dtype=torch.float32, device=dev)
        handles, synced = [], []

        def emit(i, payload):
            if self.overlap:
                handles.append(gs.start(i, payload))
            else:
                synced.append(gs.run(i, payload))

        with _tm.span("train/fwd", cat="train"):
            hs, h_out, auxs = [], [], []
            with torch.no_grad():
                for mb in shards:
                    h = model.embed_apply(mb["tokens"])
                    aux = torch.zeros((), dtype=torch.float32, device=dev)
                    ins = []
                    for lo, hi in self.bounds:
                        ins.append(h)
                        h, a = model.segment_apply(h, lo, hi, flags)
                        aux = aux + a
                    hs.append(ins)
                    h_out.append(h)
                    auxs.append(aux)
        with _tm.span("train/head_bwd", cat="train"):
            head = [model.final_norm.scale, model.lm_head]
            out, dhs, mrows = bucket(0), [], []
            for r, mb in enumerate(shards):
                with torch.enable_grad():
                    h = h_out[r].detach().requires_grad_()
                    ce, n = cross_entropy(model.head_apply(h, flags),
                                          mb["labels"], tcfg.z_loss)
                    gn, gl, dh = torch.autograd.grad(ce, head + [h])
                _pack(zip((gn, gl), head), out[r])
                dhs.append(dh)
                ce = ce.detach()
                mrows.append(_metric_row(ce.float() + moe_w * auxs[r], {
                    "aux": auxs[r], "ce": ce, "tokens": n}))
            mvec = torch.stack(mrows)
        emit(0, out)
        if self.overlap:
            mh = gs.start_metric(mvec)
        else:
            mvec_s = gs.start_metric(mvec).wait(block=True)
        for j, k in enumerate(range(K - 1, -1, -1)):
            lo, hi = self.bounds[k]
            with _tm.span(f"train/chunk_bwd[{k}]", cat="train"):
                tensors, _ = flat.cycles(lo, hi)
                out = bucket(1 + j)
                for r in range(rows):
                    with torch.enable_grad():
                        h_in = hs[r][k].detach().requires_grad_()
                        h, aux = model.segment_apply(h_in, lo, hi, flags)
                        outs, cots = [h], [dhs[r]]
                        if aux.requires_grad:
                            outs.append(aux)
                            cots.append(torch.full_like(aux, moe_w))
                        *grads, dh = torch.autograd.grad(
                            outs, tensors + [h_in], cots, allow_unused=True)
                    _pack(zip(grads, tensors), out[r])
                    dhs[r] = dh
            emit(1 + j, out)
        with _tm.span("train/embed_bwd", cat="train"):
            out = bucket(K + 1)
            for r, mb in enumerate(shards):
                with torch.enable_grad():
                    (de,) = torch.autograd.grad(
                        model.embed_apply(mb["tokens"]), [model.embed],
                        dhs[r])
                out[r].copy_(de.reshape(-1))
        emit(K + 1, out)
        del hs, dhs
        if self.overlap:
            synced = [gs.wait(i, h, block=False)
                      for i, h in enumerate(handles)]
            mvec_s = mh.wait(block=False)
        return self._apply(opt_state, synced, mvec_s)

    def __call__(self, model, opt_state, batch: Batch,
                 step: Optional[int] = None):
        """One train step of ``model`` (made trainable) on the global
        ``batch``; the weights and ``opt_state`` are updated in place.
        ``step`` feeds the error-budget schedule (when a callable was
        given); defaults to an internal counter. Returns the metrics."""
        if self.mode is None:
            self._build(model, batch)
        elif self._held.of(model) is not self._flat:
            raise ValueError("the step was built for another model")
        if step is None:
            step = self._auto_step
        self._auto_step = int(step) + 1
        self.grad_sync.ensure_ops(int(step))
        with _tm.span("train/step", cat="train", mode=self.mode,
                      overlap=self.overlap):
            if self.mode == "segmented":
                return self._segmented(model, opt_state, batch)
            return self._monolithic(model, opt_state, batch)

    def release(self) -> None:
        """Release the persistent ops and the gradient buffer."""
        if self.grad_sync is not None:
            self.grad_sync.release()
        self._buf = None


def make_overlapped_train_step(cfg, tcfg: TrainConfig, grid, topo=None,
                               algo: str = "auto", error_budget=0.0,
                               bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                               chunks: Optional[int] = None,
                               codec: Optional[str] = None,
                               overlap: bool = True,
                               segmented="auto") -> _OverlappedStep:
    """Bucketed data-parallel step with persistent nonblocking gradient
    sync (see the module docstring and :class:`_OverlappedStep`).

    Same semantics as :func:`make_manual_train_step` (``topo`` a Topology
    or a group Communicator, the plan knobs, loss and scalar metrics
    synced lossless), error feedback through carry ops; ``error_budget``
    may also be a schedule ``callable(step) -> float`` (plans re-resolved
    only when the budget changes, ops rebuilt only when a plan does).
    ``segmented``: ``"auto"`` takes the segmented decomposition where it
    applies, else the monolithic one; ``True`` requires it (raises when it
    does not apply); ``False`` pins the monolithic one. The step is
    ``step(model, opt_state, batch, step=None) -> metrics``; ``.mode``
    names the decomposition, ``.bounds`` the segments' cycle windows and
    ``.grad_sync`` the persistent ops (plans, rebuilds, error state).
    ``overlap=False`` is the barrier twin, bitwise the same results."""
    return _OverlappedStep(cfg, tcfg, grid, topo, algo, error_budget,
                           bucket_bytes, chunks, codec, overlap,
                           segmented=segmented)
