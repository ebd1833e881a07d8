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

Every collective has its blocking method and its ``*_init`` persistent
constructor; operands and results follow the reference's global
conventions (``core/runtime.py``). ``comm.split`` is a later slice
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import autotune, runtime
from repro_torch.core.topology import Topology

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


class _Proto:
    """Shape/dtype stand-in for plan resolution without a live tensor."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * self.dtype.itemsize


# ---------------------------------------------------------------------------
# persistent nonblocking ops
# ---------------------------------------------------------------------------


class CollHandle:
    """One in-flight persistent-op invocation. ``wait()`` yields the result
    exactly once; a second ``wait`` is a misuse error."""

    __slots__ = ("_op", "_value", "_done", "_event")

    def __init__(self, op: "PersistentOp", value, event=None):
        self._op = op
        self._value = value
        self._done = False
        self._event = event

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
        return self._value


#: count of live (initialised, not yet released) persistent ops
_LIVE_OPS = 0


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
        self._fn = runtime.compile_persistent(
            comm.grid, comm.topo, collective, algo, self.shape, dtype,
            stacked=self.stacked, carry=self.carry, **self.kw)
        out_shape = runtime.wiring(collective).result_shape(
            self.shape, comm.grid.world, self.stacked)
        self._out = [torch.empty(out_shape, dtype=dtype,
                                 device=comm.grid.device)
                     for _ in range(self.depth)]
        global _LIVE_OPS
        _LIVE_OPS += 1

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
        out = self._out[self.starts % self.depth]
        if self.carry:
            self._check_operand(carry, what="carry")
            y, new_carry = self._fn(x, carry)
            out.copy_(y)
            carry.copy_(new_carry)
            value = (out, carry)
        else:
            out.copy_(self._fn(x))
            value = out
        event = None
        if out.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(out.device))
        self._inflight += 1
        self.starts += 1
        return CollHandle(self, value, event)

    def __call__(self, x, carry=None):
        """Blocking convenience: ``start(x).wait()``."""
        return self.start(x, carry=carry).wait()


# ---------------------------------------------------------------------------
# the communicator
# ---------------------------------------------------------------------------


class Communicator:
    """A long-lived collective context bound to ``(grid, topo)``.

    ``topo`` defaults to :meth:`Topology.from_grid`; a given topology must
    match the grid's axis sizes. The selector defaults to the process-wide
    one (``autotune.default_selector()``)."""

    def __init__(self, grid, topo: Optional[Topology] = None, *,
                 selector: Optional[autotune.Selector] = None):
        self.grid = grid
        if topo is None:
            topo = Topology.from_grid(grid)
        sizes = grid.shape
        if topo.world != grid.world or (
                topo.node_axis != topo.local_axis
                and (sizes.get(topo.node_axis), sizes.get(topo.local_axis))
                != (topo.n_nodes, topo.n_local)):
            raise ValueError(f"topology {topo.n_nodes}x{topo.n_local} over "
                             f"{topo.axes} does not match {grid!r}")
        self.topo = topo
        self.selector = (selector if selector is not None
                         else autotune.default_selector())

    def __repr__(self) -> str:
        return (f"Communicator({self.topo.n_nodes}x{self.topo.n_local}, "
                f"device={self.grid.device})")

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
        return runtime.resolve_algo(self.topo, spec.collective, spec.algo,
                                    proto, kw, error_budget=spec.error_budget,
                                    selector=self.selector)

    # -- blocking methods ---------------------------------------------------

    def _call(self, name: str, x, *, algo: str = "auto",
              chunks: Optional[int] = None,
              chunk_bytes: Optional[int] = None,
              codec: Optional[str] = None, error_budget: float = 0.0,
              stacked: bool = True, **kw):
        spec = PlanSpec(name, algo, chunks, chunk_bytes, codec,
                        error_budget, stacked)
        algo_r, kw_r = self._resolve(spec, x, kw)
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
        proto = _Proto(shape, dtype)
        algo_r, kw_r = self._resolve(spec, proto, kw)
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

    # -- observability passthroughs -----------------------------------------

    def cache_stats(self) -> "runtime.CacheStats":
        return runtime.cache_stats()

    def selection_stats(self) -> autotune.SelectionStats:
        return self.selector.stats
