"""Communicator: the object API for collectives — blocking methods plus
persistent, nonblocking ops (port of ``repro.core.comm``).

  * :class:`Communicator` owns ``(grid, topo, selector)`` and fronts the
    runtime caches: ``comm.allreduce(x, algo="auto", chunks=...,
    codec=..., error_budget=...)``, knobs validated when the plan is made;
  * :class:`PlanSpec` normalizes the knobs once (``chunks=None`` == 1 ==
    omitted, ``codec=None`` == "none" == omitted), so every spelling of a
    plan shares one cache entry;
  * ``op = comm.<collective>_init(...)`` returns a :class:`PersistentOp`:
    the plan is resolved and its output buffers allocated once, at init;
    ``op.start(x)`` enqueues the work on the current CUDA stream and
    returns a :class:`CollHandle` at once; ``handle.wait()`` waits on a
    CUDA event recorded after that work, not on the whole device.

  * ``comm.split(axes=...)`` makes groups first-class (the
    ``MPI_Comm_split`` analog): a child scoped to a sub-topology over the
    named grid axes, on the parent's grid, running every group at once;
    its tuning rows carry the group tag (``/g:`` keys) and its caches key
    on the group topology. ``split(color=..., key=...)`` builds irregular
    groups, each on a grid of its own. ``calibrate(include_splits=True)``
    measures the root and every child of ``split_lattice()``.

Every collective has its blocking method and its ``*_init`` persistent
constructor; operands and results follow the reference's global
conventions (``core/runtime.py``). :func:`communicator` is the
process-wide memo per ``(grid, topo)``.

Telemetry (``core.telemetry``, the reference's hooks at its places): plan
resolution and persistent init emit spans, init and release bump the
``comm.persistent_inits`` / ``comm.persistent_releases`` counters, and each
``start`` opens a window on the op's own ``comm:<collective>#<n>`` track
that ``wait`` closes; a blocking wait also records a plan observation
(the window ends after the card's work is done). ``start``'s copies into
the op's own buffers run in a ``persistent/writeback`` range.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import autotune, runtime
from repro_torch.core import telemetry as _tm
from repro_torch.core.grid import ProcessGrid, RankGrid
from repro_torch.core.topology import Topology
from repro_torch.distributed import backend as _dist

# ---------------------------------------------------------------------------
# plan spec: one normalization point for every call path
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """The caller's plan request for one collective invocation, validated
    and normalized at construction (see the reference's ``PlanSpec``)."""

    collective: str
    algo: str = "auto"
    chunks: Optional[int] = None
    chunk_bytes: Optional[int] = None
    codec: Optional[str] = None
    error_budget: float = 0.0
    #: allgather only: False returns the gather once instead of per rank
    stacked: bool = True
    #: carry-threaded persistent program: start(x, carry=state) ->
    #: wait() -> (result, new_state) (error-feedback allreduce only)
    carry: bool = False

    def __post_init__(self):
        if self.collective not in runtime.collectives():
            raise ValueError(f"unknown collective {self.collective!r}; "
                             f"one of {runtime.collectives()}")
        if self.carry and self.collective != "allreduce":
            raise ValueError(
                f"carry state threading is only supported on allreduce "
                f"(error-feedback reductions), not {self.collective!r}")
        if self.chunks is not None and int(self.chunks) < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.chunk_bytes is not None and int(self.chunk_bytes) < 1:
            raise ValueError(
                f"chunk_bytes must be >= 1, got {self.chunk_bytes}")
        if callable(self.error_budget):
            raise TypeError(
                "error_budget schedules (callables) are only accepted by "
                "the gradient-sync op (train.manual_step."
                "OverlappedGradSync); per-call plans need a float")
        if float(self.error_budget) < 0.0:
            raise ValueError(
                f"error_budget must be >= 0, got {self.error_budget}")

    def kwargs(self) -> Dict[str, Any]:
        """The normalized knob dict handed to the resolver."""
        kw: Dict[str, Any] = {}
        if self.chunks is not None:
            kw["chunks"] = int(self.chunks)
        if self.chunk_bytes is not None:
            kw["chunk_bytes"] = int(self.chunk_bytes)
        if self.codec is not None:
            kw["codec"] = str(self.codec)
        return kw


# ---------------------------------------------------------------------------
# persistent nonblocking ops
# ---------------------------------------------------------------------------


class CollHandle:
    """One in-flight persistent-op invocation. ``wait()`` yields the result
    exactly once; a second ``wait`` is a misuse error."""

    __slots__ = ("_op", "_value", "_done", "_event", "_token", "_t0")

    def __init__(self, op: "PersistentOp", value, event=None, token=None,
                 t0=0.0):
        self._op = op
        self._value = value
        self._done = False
        self._event = event
        self._token = token
        self._t0 = t0

    @property
    def done(self) -> bool:
        """True once this handle has been waited on."""
        return self._done

    def wait(self, block: bool = True):
        """Complete the operation and return its result.

        ``block=True`` waits on the CUDA event recorded after the op's work
        (a no-op on the CPU, where the work already ran); ``block=False``
        returns at once — later work on the same stream is ordered after
        the op either way."""
        if self._done:
            raise RuntimeError(
                f"double wait on a {self._op.collective} handle: each "
                f"start(x) yields one result")
        self._done = True
        self._op._inflight -= 1
        if block and self._event is not None:
            self._event.synchronize()
        if self._token is not None:
            # the telemetry window opened at start(): close it here; after
            # a blocking wait it is a sample for the drift detector
            _tm.end(self._token)
            if block:
                op = self._op
                _tm.observe_plan(op.comm.topo, op.collective,
                                 runtime.dtype_name(op.dtype),
                                 op._msg_nbytes, op.plan,
                                 time.perf_counter() - self._t0)
        return self._value


#: count of live (initialised, not yet released) persistent ops
_LIVE_OPS = 0

#: monotone op id feeding per-op telemetry track names
_OP_SEQ = 0


def live_persistent_ops() -> int:
    """Number of :class:`PersistentOp` objects initialised and not yet
    released (process-wide)."""
    return _LIVE_OPS


class PersistentOp:
    """A persistent collective: plan resolved, callable bound and output
    buffers allocated once at init (``comm.<collective>_init``), reused by
    every ``start``.

    At most ``depth`` starts may be outstanding; the op owns ``depth``
    output buffers used in turn, so a result stays valid until ``depth``
    later starts. With ``carry=True``, ``start(x, carry=state)`` takes a
    second operand of the payload's spec and updates it IN PLACE with the
    new state (one error buffer instead of two); ``wait()`` returns
    ``(result, state)``.
    """

    def __init__(self, comm: "Communicator", collective: str,
                 shape: Tuple[int, ...], dtype: torch.dtype, algo: str,
                 kw: Dict[str, Any], *, stacked: bool = True,
                 depth: int = 1, carry: bool = False):
        if int(depth) < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.comm = comm
        self.collective = collective
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.algo = algo
        self.kw = dict(kw)
        self.stacked = bool(stacked)
        self.depth = int(depth)
        self.carry = bool(carry)
        self.starts = 0
        self._inflight = 0
        self._released = False
        # per-rank message bytes in the cost model's convention: the drift
        # detector's size key
        self._msg_nbytes = runtime._message_bytes(
            collective, comm.topo, runtime.logical(
                comm.grid, collective, runtime.Proto(self.shape, dtype)))
        global _LIVE_OPS, _OP_SEQ
        _OP_SEQ += 1
        # each op its own trace track, so concurrent windows render as
        # parallel lanes
        self._track = f"comm:{collective}#{_OP_SEQ}"
        tm_on = _tm.enabled()
        t0 = time.perf_counter() if tm_on else 0.0
        self._fn = runtime.compile_persistent(
            comm.grid, comm.topo, collective, algo, self.shape, dtype,
            stacked=self.stacked, carry=self.carry, **self.kw)
        out_shape = runtime.wiring(collective).result_shape(
            self.shape, comm.grid.world, self.stacked, comm.topo.world,
            rows=comm.grid.rows)
        self._out = [torch.empty(out_shape, dtype=dtype,
                                 device=comm.grid.device)
                     for _ in range(self.depth)]
        if tm_on:
            dt = time.perf_counter() - t0
            _tm.emit(f"persistent_init/{collective}", _tm.now() - dt, dt,
                     cat="persistent", **self._tags())
        _tm.counter("comm.persistent_inits").inc()
        _LIVE_OPS += 1

    def _tags(self) -> Dict[str, Any]:
        return _tm.plan_tags(self.collective, self.algo, self.chunks,
                             self.codec, self.comm.topo.group or "",
                             nbytes=self._msg_nbytes)

    @property
    def chunks(self) -> int:
        return int(self.kw.get("chunks", 1))

    @property
    def codec(self) -> str:
        return str(self.kw.get("codec", "none"))

    @property
    def plan(self) -> str:
        """The resolved plan key (``algo#cN@codec``, defaults omitted)."""
        return autotune.encode_plan(self.algo, self.chunks, self.codec)

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        """Free this op: drop its callable and buffers and retire it from
        the live-op count. Idempotent; any ``start`` after release raises.
        The bound plan stays in the runtime exec cache."""
        global _LIVE_OPS
        if self._released:
            return
        self._released = True
        self._fn = None
        self._out = []
        _LIVE_OPS -= 1
        _tm.counter("comm.persistent_releases").inc()
        if _tm.enabled():
            _tm.instant(f"persistent_release/{self.collective}",
                        cat="persistent", starts=self.starts,
                        **self._tags())

    def _check_operand(self, x, what: str = "operand") -> None:
        if not torch.is_tensor(x) or tuple(x.shape) != self.shape \
                or x.dtype != self.dtype:
            got = (f"{tuple(x.shape)}/{x.dtype}" if torch.is_tensor(x)
                   else type(x).__name__)
            raise ValueError(
                f"persistent {self.collective} op built for "
                f"{self.shape}/{self.dtype}, got {what} {got}; init a new "
                f"op for a new operand spec")
        if x.device != self.comm.grid.device:
            raise ValueError(f"{what} on {x.device}, op on "
                             f"{self.comm.grid.device}")

    def start(self, x, carry=None) -> CollHandle:
        """Enqueue one invocation on ``x`` and return its handle."""
        if self._released:
            raise RuntimeError(
                f"start() on a released {self.collective} persistent op; "
                f"init a new op (release() retired this one)")
        if self._inflight >= self.depth:
            raise RuntimeError(
                f"{self.collective} persistent op already has "
                f"{self._inflight} outstanding start(s) at depth="
                f"{self.depth}; wait() the previous handle first, or init "
                f"with depth>=2 for double buffering")
        if self.carry != (carry is not None):
            raise ValueError(
                f"{self.collective} persistent op was built with "
                f"carry={self.carry}; start() "
                + ("requires carry=state" if self.carry
                   else "does not take a carry operand"))
        self._check_operand(x)
        token, t0 = None, 0.0
        if _tm.enabled():
            # the start->wait window rides this op's own track
            t0 = time.perf_counter()
            token = _tm.begin(f"{self.collective}[{self.plan}]",
                              cat="comm", track=self._track, **self._tags())
        out = self._out[self.starts % self.depth]
        if self.carry:
            self._check_operand(carry, what="carry")
            y, new_carry = self._fn(x, carry)
            with _tm.span("persistent/writeback", cat="writeback"):
                out.copy_(y)
                carry.copy_(new_carry)
            value = (out, carry)
        else:
            y = self._fn(x)
            with _tm.span("persistent/writeback", cat="writeback"):
                out.copy_(y)
            value = out
        event = None
        if out.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(out.device))
        self._inflight += 1
        self.starts += 1
        return CollHandle(self, value, event, token, t0)

    def __call__(self, x, carry=None):
        """Blocking convenience: ``start(x).wait()``."""
        return self.start(x, carry=carry).wait()


# ---------------------------------------------------------------------------
# the communicator
# ---------------------------------------------------------------------------


class Communicator:
    """A long-lived collective context bound to ``(grid, topo)``.

    ``topo`` defaults to :meth:`Topology.from_grid`; a given topology must
    name grid axes with the grid's sizes: both axes (a root, or the
    two-axis group), or one axis at both levels (a ``1 x size`` group).
    The selector defaults to the process-wide one
    (``autotune.default_selector()``). A grid always has the ``node`` and
    ``local`` axes, so every communicator is scoped: the reference's
    unscoped root (a mesh without those axes) has no counterpart here.

    ``ranks`` names, per row of this communicator's operands, the rank of
    the parent grid it stands for: ``0 .. world-1``, except in a color
    split's child, which holds its group's ranks in ``(key, rank)``
    order."""

    def __init__(self, grid, topo: Optional[Topology] = None, *,
                 selector: Optional[autotune.Selector] = None):
        self.grid = grid
        self.ranks: Tuple[int, ...] = tuple(range(grid.world))
        if topo is None:
            topo = Topology.from_grid(grid)
        sizes = grid.shape
        if topo.node_axis == topo.local_axis:
            fits = topo.n_nodes == 1 and \
                sizes.get(topo.local_axis) == topo.n_local
        else:
            fits = (sizes.get(topo.node_axis), sizes.get(topo.local_axis)) \
                == (topo.n_nodes, topo.n_local)
        if not fits:
            raise ValueError(f"topology {topo.n_nodes}x{topo.n_local} over "
                             f"{topo.axes} does not match {grid!r}")
        self.topo = topo
        self.selector = (selector if selector is not None
                         else autotune.default_selector())
        self._groups: Dict[tuple, Any] = {}

    def __repr__(self) -> str:
        grp = f", group={self.topo.group!r}" if self.topo.group else ""
        return (f"Communicator({self.topo.n_nodes}x{self.topo.n_local}, "
                f"axes={self.topo.axes}{grp}, device={self.grid.device})")

    # -- sub-communicators --------------------------------------------------

    def split(self, axes=None, *, color=None, key=None,
              group: Optional[str] = None):
        """The ``MPI_Comm_split`` analog: child communicator(s) scoped to a
        subset of this communicator's ranks. Children are memoized per spec
        and share this communicator's selector.

        ``split(axes=...)``: regular groups along one grid axis or a
        ``(node_axis, local_axis)`` pair. The child shares this grid and
        runs every group along the other axis at once, so one child serves
        all siblings; its operand spans all of the grid's ranks, as the
        parent's does. Its topology comes from :meth:`Topology.subset`
        (links inherited where the axis matches), tagged ``group`` (default
        ``"x".join(axes)``).

        ``split(color=..., key=...)``: irregular groups. ``color`` holds one
        int per rank of this grid (flat order); ranks of one color form a
        group ordered by ``(key[rank], rank)`` (``key`` defaults to the
        rank). Returns ``{color: Communicator}``, each on its own
        ``(1, size)`` grid on ``device`` and tagged ``color<c>`` unless
        ``group`` is given; its operand is the caller's choice of the
        group's rows, in that order (the child's ``ranks``).

        On a ``ProcessGrid`` an axes child shares the grid (and its
        process group), along any axis, inside a process or across them.
        A color group inside one process runs on a ``RankGrid`` of its
        own; one that spans processes runs on a ``ProcessGrid.over`` its
        members' processes, which holds this process's members in the
        group's ``(key, rank)`` order (consecutive or not) and exchanges
        with those processes alone, through the parent's transport. Every process gets the same dict of
        colors, as the reference's does; a child of which this process
        holds no member raises on every collective."""
        if (axes is None) == (color is None):
            raise ValueError("split() takes exactly one of axes= or color=")
        if axes is not None:
            if key is not None:
                raise ValueError("key= only applies to color splits")
            ax = (axes,) if isinstance(axes, str) else tuple(axes)
            spec = ("axes", ax, group)
            hit = self._groups.get(spec)
            if hit is None:
                topo = Topology.subset(self.grid, ax, parent=self.topo,
                                       group=group)
                hit = self._groups[spec] = Communicator(
                    self.grid, topo, selector=self.selector)
            return hit
        return self._split_color(color, key, group)

    def _split_color(self, color, key, group: Optional[str]
                     ) -> Dict[int, "Communicator"]:
        world = self.grid.world
        color = tuple(int(c) for c in color)
        if len(color) != world:
            raise ValueError(
                f"color needs one entry per parent rank: got {len(color)} "
                f"for world {world}")
        key = (tuple(range(world)) if key is None
               else tuple(int(k) for k in key))
        if len(key) != world:
            raise ValueError(
                f"key needs one entry per parent rank: got {len(key)} "
                f"for world {world}")
        spec = ("color", color, key, group)
        hit = self._groups.get(spec)
        if hit is None:
            hit = {}
            for c in sorted(set(color)):
                ranks = sorted((r for r in range(world) if color[r] == c),
                               key=lambda r: (key[r], r))
                owners = [self.grid.owners[r] for r in ranks] \
                    if isinstance(self.grid, ProcessGrid) else [0]
                grid = (ProcessGrid.over(owners, self.grid.device,
                                         self.grid.transport)
                        if len(set(owners)) > 1
                        else RankGrid(1, len(ranks), self.grid.device))
                tag = group if group is not None else f"color{c}"
                topo = dataclasses.replace(Topology.from_grid(grid),
                                           group=tag)
                hit[c] = Communicator(grid, topo, selector=self.selector)
                hit[c].ranks = tuple(ranks)
            self._groups[spec] = hit
        return dict(hit)

    def split_lattice(self) -> Tuple["Communicator", ...]:
        """Every axis-aligned split child: one per active (size > 1) axis,
        plus the two-axis group when both are active (a 2x4 grid gives the
        ``("node",)``, ``("local",)`` and ``("node", "local")`` children).
        They are the memoized objects :meth:`split` returns."""
        axes = tuple(self.topo.active_axes)
        combos = [(a,) for a in axes]
        if len(axes) > 1:
            combos.append(axes)
        return tuple(self.split(axes=c) for c in combos)

    # -- plan resolution ----------------------------------------------------

    def plan(self, collective: str, nbytes: int, dtype: str = "float32",
             error_budget: float = 0.0) -> autotune.Selection:
        """The selector's ``(algo, chunks, codec)`` plan for one payload
        size on this communicator's topology."""
        return self.selector.choose(collective, self.topo, int(nbytes),
                                    dtype=dtype,
                                    error_budget=float(error_budget))

    def _resolve(self, spec: PlanSpec, proto, extra: Dict[str, Any]
                 ) -> Tuple[str, Dict[str, Any]]:
        kw = spec.kwargs()
        overlap = set(kw) & set(extra)
        if overlap:
            raise ValueError(f"duplicate plan knobs {sorted(overlap)}")
        kw.update(extra)
        tm_on = _tm.enabled()
        t0 = time.perf_counter() if tm_on else 0.0
        algo_r, kw_r = runtime.resolve_algo(
            self.topo, spec.collective, spec.algo, proto, kw,
            error_budget=spec.error_budget, selector=self.selector)
        if tm_on:
            dt = time.perf_counter() - t0
            _tm.emit(f"plan_resolve/{spec.collective}", _tm.now() - dt, dt,
                     cat="resolve",
                     requested=spec.algo,
                     **_tm.plan_tags(spec.collective, algo_r,
                                     int(kw_r.get("chunks", 1)),
                                     str(kw_r.get("codec", "none")),
                                     self.topo.group or "",
                                     nbytes=runtime._message_bytes(
                                         spec.collective, self.topo, proto)))
        return algo_r, kw_r

    # -- blocking methods ---------------------------------------------------

    def _call(self, name: str, x, *, algo: str = "auto",
              chunks: Optional[int] = None,
              chunk_bytes: Optional[int] = None,
              codec: Optional[str] = None, error_budget: float = 0.0,
              stacked: bool = True, **kw):
        spec = PlanSpec(name, algo, chunks, chunk_bytes, codec,
                        error_budget, stacked)
        algo_r, kw_r = self._resolve(spec, runtime.logical(self.grid, name, x),
                                     kw)
        return runtime.run_resolved(self.grid, self.topo, name, algo_r, x,
                                    stacked=stacked, **kw_r)

    def allreduce(self, x, **knobs):
        """Sum-allreduce: in ``(world, m, ...)`` (row d = rank d's payload),
        out the reduced payload per rank, same shape. Knobs: ``algo``
        (default "auto"), ``chunks``/``chunk_bytes``, ``codec``,
        ``error_budget``, plus algorithm kwargs (``inter``, ...)."""
        return self._call("allreduce", x, **knobs)

    def reduce_scatter(self, x, **knobs):
        """Reduce-scatter: in ``(world, world*s, ...)``, out each rank's
        reduced shard concatenated, ``(world*s, ...)``."""
        return self._call("reduce_scatter", x, **knobs)

    def allgather(self, x, *, stacked: bool = True, **knobs):
        """Allgather: in ``(world*m, ...)``, rank d's shard at rows
        ``[d*m, (d+1)*m)``; out stacked ``(world, world*m, ...)`` (row d =
        rank d's full copy) or the gather once with ``stacked=False``."""
        return self._call("allgather", x, stacked=stacked, **knobs)

    def alltoall(self, x, **knobs):
        """All-to-all: in ``(world, world, s...)`` (row d, column g = what
        rank d sends rank g), out the exchange: row d, column g = what rank
        d received from rank g."""
        return self._call("alltoall", x, **knobs)

    def broadcast(self, x, **knobs):
        """Broadcast from ``root`` (default 0): in ``(m, ...)`` replicated,
        out stacked ``(world, m, ...)``."""
        return self._call("broadcast", x, **knobs)

    def scatter(self, x, **knobs):
        """Scatter from ``root`` (default 0): in ``(world*m, ...)``
        replicated, out each rank's shard concatenated, ``(world*m, ...)``."""
        return self._call("scatter", x, **knobs)

    def invoke(self, name: str, x, **knobs):
        """Name-indexed dispatch to the blocking methods (parametrized
        sweeps); new call sites should prefer the per-collective
        methods."""
        method = getattr(self, name, None)
        if name not in runtime.collectives() or method is None:
            raise ValueError(f"unknown collective {name!r}; "
                             f"one of {runtime.collectives()}")
        return method(x, **knobs)

    # -- persistent nonblocking ops -----------------------------------------

    def persistent(self, name: str, x=None, *, shape=None, dtype=None,
                   algo: str = "auto", chunks: Optional[int] = None,
                   chunk_bytes: Optional[int] = None,
                   codec: Optional[str] = None, error_budget: float = 0.0,
                   stacked: bool = True, depth: int = 1, carry: bool = False,
                   **kw) -> PersistentOp:
        """Init a :class:`PersistentOp` for ``name`` on a fixed operand
        spec — an example tensor ``x`` or ``shape=``/``dtype=``."""
        if x is not None:
            shape, dtype = tuple(x.shape), x.dtype
        if shape is None or dtype is None:
            raise ValueError("persistent op needs an example operand x or "
                             "explicit shape= and dtype=")
        spec = PlanSpec(name, algo, chunks, chunk_bytes, codec,
                        error_budget, stacked, carry)
        proto = runtime.Proto(shape, dtype)
        algo_r, kw_r = self._resolve(spec, runtime.logical(self.grid, name,
                                                           proto), kw)
        return PersistentOp(self, name, proto.shape, dtype, algo_r, kw_r,
                            stacked=stacked, depth=depth, carry=carry)

    def allreduce_init(self, x=None, **knobs) -> PersistentOp:
        return self.persistent("allreduce", x, **knobs)

    def reduce_scatter_init(self, x=None, **knobs) -> PersistentOp:
        return self.persistent("reduce_scatter", x, **knobs)

    def allgather_init(self, x=None, **knobs) -> PersistentOp:
        return self.persistent("allgather", x, **knobs)

    def alltoall_init(self, x=None, **knobs) -> PersistentOp:
        return self.persistent("alltoall", x, **knobs)

    def broadcast_init(self, x=None, **knobs) -> PersistentOp:
        return self.persistent("broadcast", x, **knobs)

    def scatter_init(self, x=None, **knobs) -> PersistentOp:
        return self.persistent("scatter", x, **knobs)

    # -- calibration and observability passthroughs -------------------------

    def calibrate(self, include_splits: bool = False, path=None,
                  **kw) -> List["runtime.CalibrationRow"]:
        """Timed plan sweeps into this communicator's selector table (see
        ``runtime.calibrate``; ``kw`` are its ``names``, ``sizes``,
        ``dtype``, ``iters``, ``codecs``).

        ``include_splits=True`` also sweeps every child of
        :meth:`split_lattice`, so each group topology has measured
        ``/g:``-keyed rows before its first use: a fresh ``split(axes=...)``
        then resolves ``algo="auto"`` from measurement. Every row lands in
        the shared selector's table; ``path`` is written once, after the
        whole lattice.

        Under a process group of several processes every process runs the
        same sweeps (the timed plans cross processes), then every process
        folds all processes' tables in with ``max``
        (``distributed.backend.merge_tuning_table``), so ``algo="auto"``
        resolves to the same plan everywhere, and rank 0 alone writes
        ``path``; a barrier follows. (The reference folds on rank 0 only.)
        """
        kw.setdefault("selector", self.selector)
        rows = list(runtime.calibrate(self.grid, self.topo, **kw))
        if include_splits:
            for child in self.split_lattice():
                rows.extend(runtime.calibrate(child.grid, child.topo, **kw))
        table = kw["selector"].table
        _dist.merge_tuning_table(table)
        if path is not None and _dist.process_rank() == 0:
            table.save(path)
        _dist.barrier("comm.calibrate/saved")
        return rows

    def cache_stats(self) -> "runtime.CacheStats":
        return runtime.cache_stats()

    def selection_stats(self) -> autotune.SelectionStats:
        return self.selector.stats


# ---------------------------------------------------------------------------
# process-wide memo
# ---------------------------------------------------------------------------


_COMMS: Dict[tuple, Communicator] = {}


def communicator(grid, topo: Optional[Topology] = None) -> Communicator:
    """The memoized Communicator per ``(grid, topo)`` (``topo`` defaults to
    :meth:`Topology.from_grid`): hot loops that cannot keep a handle share
    one object per context, and, since :meth:`Communicator.split` memoizes
    its children, one child per split spec."""
    t = topo if topo is not None else Topology.from_grid(grid)
    hit = _COMMS.get((grid, t))
    if hit is None:
        hit = _COMMS[(grid, t)] = Communicator(grid, t)
    return hit
