"""Bucketed data-parallel gradient sync (the sync half of
``repro.train.manual_step``).

A gradient is held STACKED and FLAT: one ``(world, n_params)`` buffer whose
row ``d`` is rank ``d``'s gradient and whose columns are the leaves in the
reference's flatten order (``models.params.param_shapes``; leaves are views
into the buffer). A bucket is then a column window of that buffer, so the
bucket flatten copies nothing. On a ``ProcessGrid`` each process holds
only its own ranks' rows, ``(grid.rows, n_params)``.

  * :func:`sync_tree_bucketed` runs ``sync_fn(bucket, err) -> (synced,
    new_err)`` once per ``bucket_bytes`` window;
  * :class:`OverlappedGradSync` holds one persistent allreduce op per
    bucket (plan resolved and buffers allocated once, reused every step)
    plus one for the packed scalar metrics; buckets whose plan carries a
    codec thread per-bucket error-feedback state through carry ops.

Plans resolve through the selection subsystem (``algo="auto"``) or are
pinned (``algo=``, ``chunks=``, ``codec=``); ``error_budget`` (a float or a
schedule ``callable(step)``) admits error-bounded codecs. Metrics always
sync lossless.

Telemetry (``core.telemetry``, on only when enabled): each bucket's
start->wait window on its own ``bucket:<i>`` track, a ``bucket_rebuild``
instant and the ``train.bucket_rebuilds`` counter when a plan change
rebuilds the ops, and, one wait in ``telemetry.SAMPLE_EVERY`` per bucket,
the error-feedback probe (:meth:`OverlappedGradSync._observe_ef`), the only
hook that reads device values.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core import autotune, costmodel, mcoll, runtime
from repro_torch.core import compress as codecs
from repro_torch.core import telemetry as _tm
from repro_torch.core.topology import Topology

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


def _make_grad_sync(comm, algo: str, chunks: Optional[int],
                    codec: Optional[str], error_budget: float):
    """Mean-allreduce of one stacked ``(world, n)`` bucket with
    error-feedback threading: ``sync(x, err) -> (mean, new_err)``. When the
    resolved plan is lossless (or no state is given), ``err`` passes
    through."""
    topo, grid = comm.topo, comm.grid

    def sync(v, err):
        g = v.float().reshape(v.shape[0], -1)
        name, kw = _resolve_plan(topo, g[0].numel() * 4, g.dtype, algo,
                                 chunks, codec, error_budget)
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
                       err_state=None):
    """Run ``sync_fn(bucket, err) -> (synced, new_err)`` over the
    ``bucket_bytes`` column windows of the stacked flat gradient ``flat``
    ``(world, n_params)``. Returns ``(synced (world, n_params),
    new_err_state)``; ``err_state`` is a tuple of per-bucket buffers (from
    :func:`init_error_state`) or empty for lossless sync. Elementwise
    reductions make the result bit-identical to syncing each leaf with the
    same algorithm."""
    slices = bucket_slices(flat.shape[1], max(1, int(bucket_bytes) // 4))
    errs = list(err_state) if err_state else [None] * len(slices)
    if len(errs) != len(slices):
        raise ValueError(f"error state has {len(errs)} buckets, payload "
                         f"needs {len(slices)}")
    out = torch.empty(flat.shape, dtype=torch.float32, device=flat.device)
    new_errs = []
    for (start, n), e in zip(slices, errs):
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
        to the host, which is why it hides behind ``should_sample``."""
        amax_y = float(y.abs().max())
        amax_e = float(new_err.abs().max())
        _tm.observe_ef_error(op.codec, amax_e / (amax_y + 1e-30),
                             codecs.meta(op.codec).error_bound)
        _tm.observe_codec_ratio(
            op.codec, codecs.codec(op.codec).achieved_ratio(y))

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
