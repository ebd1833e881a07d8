"""Collective runtime (port of ``repro.core.runtime``): plan resolution and
the build/exec caches behind the Communicator.

  * :func:`resolve_algo` turns a plan request into ``(algo, kwargs)``:
    ``algo="auto"`` through the selector (cost-model priors + measured
    tuning table), ``chunks``/``codec`` normalized so every spelling of one
    plan is one cache entry, knobs validated before anything runs;
  * :func:`build` caches the callable bound to ``(grid, topo, collective,
    algo, knobs)``; :func:`run_resolved` additionally keys the exec cache on
    the operand's shape and dtype; both caches are LRU-bounded and counted
    in :class:`CacheStats`;
  * :func:`compile_persistent` is the persistent-op backend. The reference
    compiles the plan ahead of time; PyTorch runs eagerly, so here it
    resolves and binds the plan once (``PersistentOp`` allocates its output
    buffers at init). Capturing the plan into a CUDA graph is later work;
  * :func:`calibrate` times every candidate plan at each size through the
    same cached path and records the medians in the selector's tuning
    table, so ``algo="auto"`` then resolves from measurement.

With telemetry on (``core.telemetry``), builds, persistent binds, cache
hits, every call and every calibrated plan leave spans tagged with the
resolved plan; calls add dispatch-only plan observations and calibration
samples synced ones. Each entry point reads ``telemetry.enabled()`` once;
with telemetry off that read is all the hooks cost.

Operands and results follow the reference's global conventions per
collective (:data:`_WIRING`, the reference's ``runtime.build`` table); the
algorithms themselves take and give *stacked* rows, dim 0 the flat rank:

  ==============  ======================  ===============================
  collective      operand                 result
  ==============  ======================  ===============================
  allgather       ``(D*m, ...)``          ``(D, G*m, ...)`` stacked, or
                                          ``(G*m, ...)`` (``stacked=False``)
  scatter         ``(G*m, ...)``          ``(D*m, ...)``
                  replicated
  broadcast       ``(m, ...)`` replicated ``(D, m, ...)`` stacked
  allreduce       ``(D, m, ...)``         ``(D, m, ...)`` stacked
  reduce_scatter  ``(D, G*s, ...)``       ``(D*s, ...)``
  alltoall        ``(D, G, s...)``        ``(D, G, s...)``
  ==============  ======================  ===============================

D is the grid's ranks, G the topology's: equal for a root communicator;
for a group (``Communicator.split(axes=...)``) G < D, every rank's result
is computed within its own group, and the allgather without ``stacked``
is group 0's gather. A replicated operand becomes rows by ``expand``, a
view, not a copy. Operands must already live on the grid's device:
nothing is moved implicitly.

On a :class:`~repro_torch.core.grid.ProcessGrid` over several processes
every process passes the same full logical operand, as the reference's
``global_operand`` has it; the plan wires it to the D rows as above and
keeps the process's own (``grid.rows``, flat ranks ``grid.held``).
A row-mode operand (allreduce, reduce_scatter, alltoall) may instead hold
only those rows, ``(rows, ...)``: a process then never holds the other
processes' payloads (:func:`logical` sizes it as the whole). The result
is the process's part: its rows of a stacked result, its shards of a
sharded one, concatenated in flat rank order;
``distributed.backend.to_host(y, grid)`` gives the full result on every
process. ``stacked=False`` returns held row 0, since every row of that
gather is the same.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import statistics
import time
from collections import OrderedDict
from functools import lru_cache, partial
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core import compress as _codecs
from repro_torch.core import mcoll as _mcoll
from repro_torch.core import telemetry as _tm
from repro_torch.core.topology import Topology

AUTO = "auto"


# ---------------------------------------------------------------------------
# declarative wiring table: collective -> operand/result conventions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Wiring:
    """How one collective maps its global operand onto stacked rows and
    the rows back onto its global result (the reference's ``Wiring``).

    in_mode:  "shard"     dim 0 split over the ranks, ``(D*m, ...)`` ->
                          ``(D, m, ...)``;
              "replicate" every rank holds the operand: ``expand`` to
                          ``(D, ...)``;
              "row"       already stacked, row d = rank d's payload.
    out_mode: "stack"     rows as they are, row d = rank d's result;
              "shard"     rows concatenated along dim 0.
    stackable: honors ``stacked=False`` by returning rank 0's row (every
               row of a root communicator is the same gather).
    rank_dim0: what the collective does to dim 0 of a rank's payload:
               "gather" (times G), "split" (over G) or "keep".
    """

    in_mode: str
    out_mode: str
    stackable: bool = False
    rank_dim0: str = "keep"

    def to_rows(self, x, world: int):
        if self.in_mode == "row":
            return x
        if self.in_mode == "replicate":
            return x.expand((world,) + tuple(x.shape))
        if x.shape[0] % world:
            raise ValueError(f"operand dim0 {x.shape[0]} is not divisible "
                             f"by the {world} ranks")
        return x.reshape((world, x.shape[0] // world) + tuple(x.shape[1:]))

    def from_rows(self, y, stacked: bool = True):
        if self.stackable and not stacked:
            return y[0]
        if self.out_mode == "shard":
            return y.reshape((-1,) + tuple(y.shape[2:]))
        return y

    def result_shape(self, shape, world: int, stacked: bool = True,
                     group: Optional[int] = None,
                     rows: Optional[int] = None) -> Tuple[int, ...]:
        """The global result's shape for an operand of ``shape`` on
        ``world`` (D) ranks in groups of ``group`` (G, default D); with
        ``rows``, the part of it that a process holding ``rows`` ranks
        holds (``ProcessGrid``)."""
        D = int(world)
        G = D if group is None else int(group)
        shape = tuple(int(s) for s in shape)
        mine = {"shard": lambda: (shape[0] // D,) + shape[1:],
                "replicate": lambda: shape,
                "row": lambda: shape[1:]}[self.in_mode]()
        if self.rank_dim0 == "gather":
            mine = (G * mine[0],) + mine[1:]
        elif self.rank_dim0 == "split":
            mine = (mine[0] // G,) + mine[1:]
        if self.stackable and not stacked:
            return mine
        lead = D if rows is None else int(rows)
        if self.out_mode == "stack":
            return (lead,) + mine
        return (lead * mine[0],) + mine[1:]


_WIRING: Dict[str, Wiring] = {
    "allgather": Wiring("shard", "stack", stackable=True,
                        rank_dim0="gather"),
    "scatter": Wiring("replicate", "shard", rank_dim0="split"),
    "broadcast": Wiring("replicate", "stack"),
    "allreduce": Wiring("row", "stack"),
    "reduce_scatter": Wiring("row", "shard", rank_dim0="split"),
    "alltoall": Wiring("row", "stack"),
}


def collectives() -> Tuple[str, ...]:
    return tuple(sorted(_WIRING))


def wiring(collective: str) -> Wiring:
    """The operand and result conventions of ``collective``."""
    if collective not in _WIRING:
        raise ValueError(f"unknown collective {collective!r}; "
                         f"one of {collectives()}")
    return _WIRING[collective]


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the dtype spelling tuning-table
    keys share with the reference."""
    return str(dtype).replace("torch.", "")


def nbytes(x) -> int:
    return int(x.numel()) * int(x.element_size()) if torch.is_tensor(x) \
        else int(x.nbytes)


class Proto:
    """Shape/dtype stand-in for plan resolution without a live tensor."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * self.dtype.itemsize


def logical(grid, collective: str, x):
    """``x`` as plan resolution and message sizes see it: a row-mode
    operand that holds only a process's rows of a ``ProcessGrid`` stands
    for the ``(world, ...)`` operand; anything else is itself."""
    if grid.rows != grid.world and _WIRING[collective].in_mode == "row" \
            and x.shape[0] == grid.rows:
        return Proto((grid.world,) + tuple(x.shape[1:]), x.dtype)
    return x


# ---------------------------------------------------------------------------
# caches (LRU-bounded)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    build_hits: int = 0
    build_misses: int = 0
    build_evictions: int = 0
    exec_hits: int = 0
    exec_misses: int = 0
    exec_evictions: int = 0

    @property
    def exec_hit_rate(self) -> float:
        total = self.exec_hits + self.exec_misses
        return self.exec_hits / total if total else 0.0

    def reset(self) -> None:
        """Zero every counter in place (handles stay live)."""
        self.build_hits = self.build_misses = self.build_evictions = 0
        self.exec_hits = self.exec_misses = self.exec_evictions = 0


_DEFAULT_MAX_BUILD = 256
_DEFAULT_MAX_EXEC = 1024

_BUILD_CACHE: "OrderedDict[tuple, Callable]" = OrderedDict()
_EXEC_CACHE: "OrderedDict[tuple, Callable]" = OrderedDict()
_LIMITS = {"build": _DEFAULT_MAX_BUILD, "exec": _DEFAULT_MAX_EXEC}
_STATS = CacheStats()


def cache_stats() -> CacheStats:
    return _STATS


def selection_stats() -> autotune.SelectionStats:
    """Selection counters of the default selector."""
    return autotune.default_selector().stats


def set_cache_limits(max_build: Optional[int] = None,
                     max_exec: Optional[int] = None) -> Dict[str, int]:
    """Set LRU bounds (entries) for the build/exec caches; None leaves a
    bound unchanged. Shrinking evicts oldest entries immediately."""
    if max_build is not None:
        _LIMITS["build"] = int(max_build)
    if max_exec is not None:
        _LIMITS["exec"] = int(max_exec)
    _evict(_BUILD_CACHE, "build")
    _evict(_EXEC_CACHE, "exec")
    return dict(_LIMITS)


def _evict(cache: "OrderedDict", which: str) -> None:
    limit = max(1, _LIMITS[which])
    while len(cache) > limit:
        cache.popitem(last=False)
        if which == "build":
            _STATS.build_evictions += 1
        else:
            _STATS.exec_evictions += 1


def clear_cache() -> None:
    _BUILD_CACHE.clear()
    _EXEC_CACHE.clear()
    _STATS.reset()


def _kw_key(kw: Dict[str, Any]) -> tuple:
    return tuple(sorted(kw.items()))


def _cached(cache: "OrderedDict", which: str, key: tuple,
            make: Callable[[], Callable]) -> Tuple[Callable, bool]:
    """The cached entry for ``key`` (made and inserted on a miss) and
    whether it was a hit."""
    hit = cache.get(key)
    if hit is not None:
        setattr(_STATS, f"{which}_hits", getattr(_STATS, f"{which}_hits") + 1)
        cache.move_to_end(key)
        return hit, True
    setattr(_STATS, f"{which}_misses",
            getattr(_STATS, f"{which}_misses") + 1)
    made = cache[key] = make()
    _evict(cache, which)
    return made, False


def _span_tags(topo: Topology, collective: str, algo: str,
               kw: Dict[str, Any], nbytes: Optional[int] = None
               ) -> Dict[str, Any]:
    """Telemetry tag dict for one resolved plan at a runtime boundary."""
    return _tm.plan_tags(collective, algo, int(kw.get("chunks", 1)),
                         str(kw.get("codec", "none")), topo.group or "",
                         nbytes=nbytes)


# ---------------------------------------------------------------------------
# algorithm resolution (algo="auto")
# ---------------------------------------------------------------------------


def _message_bytes(collective: str, topo: Topology, x) -> int:
    """Per-rank message size in the cost model's conventions: broadcast's
    operand is the payload itself; every other operand holds all ranks."""
    if collective == "broadcast":
        return max(1, nbytes(x))
    return max(1, nbytes(x) // topo.world)


@lru_cache(maxsize=None)  # one small frozenset per algorithm function
def _accepted_params(fn: Callable) -> frozenset:
    return frozenset(inspect.signature(fn).parameters)


def _filter_kwargs(fn: Callable, kw: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only kwargs the algorithm function accepts."""
    if not kw:
        return kw
    params = _accepted_params(fn)
    return {k: v for k, v in kw.items() if k in params}


def _not_admissible(codec: str, collective: str, dtype) -> ValueError:
    return ValueError(
        f"codec {codec!r} is not admissible for {collective} on dtype "
        f"{dtype} (lossy codecs never touch integer payloads; integer-only "
        f"codecs need integer payloads on non-reducing collectives)")


def resolve_algo(topo: Topology, collective: str, algo: str, x,
                 kw: Optional[Dict[str, Any]] = None,
                 error_budget: float = 0.0,
                 selector: Optional[autotune.Selector] = None
                 ) -> Tuple[str, Dict[str, Any]]:
    """Resolve ``algo`` ("auto" -> the selector's (algo, chunks, codec)
    plan) for operand ``x`` (a tensor or anything with ``shape``/``dtype``/
    ``nbytes``). Returns (resolved_algo, normalized_kwargs).

    ``chunk_bytes=<b>`` becomes ``chunks=ceil(payload/b)``; a chunk-capable
    algorithm always carries ``chunks`` (default 1) and a codec-capable one
    ``codec`` (default "none"), so default knobs and omitted knobs share a
    cache key; ``error_budget`` gates which codecs auto may pick; a pinned
    lossy codec implies its own bound as the budget.
    """
    kw = dict(kw or {})
    budget = kw.pop("error_budget", None)
    if budget is None:
        budget = error_budget
    nb = _message_bytes(collective, topo, x)
    integer = _mcoll._is_integer(x.dtype)
    cb = kw.pop("chunk_bytes", None)
    if cb:
        kw.setdefault("chunks", max(1, -(-nb // int(cb))))
    if algo != AUTO:
        try:
            fn = _mcoll.algorithm(collective, algo)
        except KeyError:
            raise ValueError(
                f"unknown algorithm {algo!r} for {collective}; one of "
                f"{_mcoll.algorithms(collective)}") from None
        if _mcoll.supports_chunks(collective, algo):
            kw["chunks"] = int(kw.get("chunks", 1))
        elif "chunks" in kw:
            raise ValueError(
                f"{collective}/{algo} does not support chunking; "
                f"chunk-capable algorithms: "
                f"{sorted(_mcoll.CHUNKED.get(collective, ())) or 'none'}")
        if _mcoll.supports_codec(collective, algo):
            cdd = str(kw.get("codec", _codecs.NONE))
            _codecs.codec(cdd)  # validate the name at resolution time
            if cdd != _codecs.NONE and not _codecs.admissible(
                    cdd, collective,
                    max(float(budget), _codecs.meta(cdd).error_bound),
                    integer):
                raise _not_admissible(cdd, collective, x.dtype)
            kw["codec"] = cdd
        elif kw.get("codec", _codecs.NONE) != _codecs.NONE:
            raise ValueError(
                f"{collective}/{algo} does not support compression; "
                f"codec-capable algorithms: "
                f"{sorted(_mcoll.COMPRESSED.get(collective, ())) or 'none'}")
        else:
            kw.pop("codec", None)
        bad = set(kw) - _accepted_params(fn)
        if bad:
            raise ValueError(
                f"{collective}/{algo} got unsupported kwargs "
                f"{sorted(bad)}; accepted: "
                f"{sorted(_accepted_params(fn) - {'x', 'topo', 'grid'})}")
        return algo, kw
    pinned_codec = kw.get("codec")
    if pinned_codec is not None:
        pinned_codec = str(pinned_codec)
        _codecs.codec(pinned_codec)
        if pinned_codec != _codecs.NONE:
            if not any(_mcoll.supports_codec(collective, a)
                       for a in autotune.candidates(collective, topo)):
                raise ValueError(
                    f"{collective} has no codec-capable algorithm; "
                    f"codec={pinned_codec!r} cannot be honored")
            budget = max(float(budget),
                         _codecs.meta(pinned_codec).error_bound)
            if not _codecs.admissible(pinned_codec, collective,
                                      float(budget), integer):
                raise _not_admissible(pinned_codec, collective, x.dtype)
    sel = (selector if selector is not None
           else autotune.default_selector()).choose(
        collective, topo, nb, dtype=dtype_name(x.dtype),
        error_budget=float(budget))
    algo, chunks = sel.algo, sel.chunks
    if pinned_codec not in (None, _codecs.NONE) and \
            not _mcoll.supports_codec(collective, algo):
        # the selector's winner cannot carry the pinned codec: take the
        # cheapest codec-capable plan instead of dropping the knob
        from repro_torch.core import costmodel
        net = costmodel.net_for(topo)
        cnet = costmodel.codec_net(net, topo, pinned_codec)
        best = None
        for a in autotune.candidates(collective, topo):
            if not _mcoll.supports_codec(collective, a):
                continue
            try:
                c = (costmodel.optimal_chunks(collective, a, topo, nb, cnet)
                     if _mcoll.supports_chunks(collective, a) else 1)
                t = costmodel.plan_cost(collective, a, topo, nb, net,
                                        chunks=c, codec=pinned_codec).time
            except ValueError:
                t, c = float("inf"), 1
            if best is None or t < best[0]:
                best = (t, a, c)
        _, algo, chunks = best
    kw = _filter_kwargs(_mcoll.algorithm(collective, algo), kw)
    if _mcoll.supports_chunks(collective, algo):
        kw["chunks"] = int(kw.get("chunks", chunks or 1))
    if _mcoll.supports_codec(collective, algo):
        kw["codec"] = str(kw.get("codec", sel.codec or _codecs.NONE))
    return algo, kw


# ---------------------------------------------------------------------------
# construction + caches
# ---------------------------------------------------------------------------


def supports_carry(collective: str, algo: str) -> bool:
    """Whether ``(collective, algo)`` threads an ``err`` state operand (the
    error-feedback carry of the compressed reductions)."""
    try:
        fn = _mcoll.algorithm(collective, algo)
    except KeyError:
        return False
    return "err" in _accepted_params(fn)


def _construct(grid, topo: Topology, collective: str, algo: str,
               stacked: bool, carry: bool, **kw) -> Callable:
    wire = _WIRING[collective]
    fn = partial(_mcoll.algorithm(collective, algo), topo=topo, grid=grid,
                 **kw)
    world = grid.world

    def held(x):  # this process's rows of the wired operand
        rows = wire.to_rows(x, world)
        return rows if rows.shape[0] == grid.rows else grid.held_of(rows)
    if not carry:
        return lambda x: wire.from_rows(fn(held(x)), stacked)
    if (wire.in_mode, wire.out_mode) != ("row", "stack"):
        raise ValueError(
            f"carry operand needs row-in/stack-out wiring; {collective} is "
            f"{wire.in_mode}/{wire.out_mode}")
    if not supports_carry(collective, algo):
        raise ValueError(
            f"{collective}/{algo} does not thread a carry (no err state "
            f"operand); carry-capable algorithms: "
            f"{[a for a in _mcoll.algorithms(collective) if supports_carry(collective, a)]}")
    return lambda x, e: fn(x, err=e)


def build(grid, topo: Topology, collective: str, algo: str, *,
          stacked: bool = True, carry: bool = False, **kw) -> Callable:
    """The cached callable for one resolved plan: ``f(x) -> y`` on the
    collective's global operand (see the table above) or, with
    ``carry=True``, ``f(x, e) -> (y, new_e)``. ``stacked=False`` returns
    allgather's gather once instead of per rank. The fused-codec switch is
    part of the key, so A/B variants are separate entries."""
    wiring(collective)  # raises on an unknown collective
    if algo == AUTO:
        raise ValueError("algo='auto' resolves per input size/dtype; call "
                         "Communicator methods (or resolve_algo first)")
    key = (grid, topo, collective, algo, stacked, carry, _kw_key(kw),
           _codecs.fused_enabled())

    def make():
        with _tm.span(f"build/{collective}", cat="build",
                      **(_span_tags(topo, collective, algo, kw)
                         if _tm.enabled() else {})):
            return _construct(grid, topo, collective, algo, stacked, carry,
                              **kw)
    return _cached(_BUILD_CACHE, "build", key, make)[0]


def _check_device(grid, x) -> None:
    if x.device != grid.device:
        raise ValueError(f"operand on {x.device}, grid on {grid.device}: "
                         f"move it explicitly")


def run(grid, topo: Topology, name: str, algo: str, x, *,
        stacked: bool = True, error_budget: float = 0.0, **kw):
    """Resolve the plan for ``x`` and execute it through the caches."""
    wiring(name)  # raises on an unknown collective
    algo, kw = resolve_algo(topo, name, algo, logical(grid, name, x), kw,
                            error_budget=error_budget)
    return run_resolved(grid, topo, name, algo, x, stacked=stacked, **kw)


def run_resolved(grid, topo: Topology, name: str, algo: str, x, *,
                 stacked: bool = True, **kw):
    """Execute an already-resolved plan through the exec cache (keyed on
    the plan plus the operand's shape and dtype)."""
    _check_device(grid, x)
    key = (grid, topo, name, algo, stacked, _kw_key(kw),
           (tuple(x.shape), dtype_name(x.dtype)), _codecs.fused_enabled())
    tm_on = _tm.enabled()  # one global read; the disabled path adds nothing
    t0 = time.perf_counter() if tm_on else 0.0
    fn, hit = _cached(_EXEC_CACHE, "exec", key, lambda: build(
        grid, topo, name, algo, stacked=stacked, **kw))
    out = fn(x)
    if tm_on:
        # dispatch host time only: the card may still be running
        dt = time.perf_counter() - t0
        nb = _message_bytes(name, topo, logical(grid, name, x))
        _tm.emit(name, t0, dt, cat="collective",
                 cache="hit" if hit else "miss",
                 **_span_tags(topo, name, algo, kw, nbytes=nb))
        _tm.observe_plan(topo, name, dtype_name(x.dtype), nb,
                         autotune.encode_plan(algo,
                                              int(kw.get("chunks", 1)),
                                              str(kw.get("codec", "none"))),
                         dt, synced=False)
    return out


def compile_persistent(grid, topo: Topology, name: str, algo: str,
                       shape: Tuple[int, ...], dtype, *,
                       stacked: bool = True, carry: bool = False,
                       **kw) -> Callable:
    """Bind one resolved plan for a fixed operand shape/dtype (the
    ``PersistentOp`` backend). Entries share the LRU exec cache, so
    re-initialising an op with an identical spec is a hit."""
    if algo == AUTO:
        raise ValueError("compile_persistent needs a resolved plan; call "
                         "resolve_algo first (Communicator.persistent "
                         "does this)")
    key = (grid, topo, name, algo, stacked, _kw_key(kw),
           (tuple(shape), dtype_name(dtype)), ("persistent", carry),
           _codecs.fused_enabled())
    tm_on = _tm.enabled()

    def make():
        with _tm.span(f"persistent_compile/{name}", cat="compile",
                      **(_span_tags(topo, name, algo, kw) if tm_on else {})):
            return build(grid, topo, name, algo, stacked=stacked,
                         carry=carry, **kw)
    fn, hit = _cached(_EXEC_CACHE, "exec", key, make)
    if hit and tm_on:
        _tm.instant(f"persistent_cache_hit/{name}", cat="cache",
                    **_span_tags(topo, name, algo, kw))
    return fn


# ---------------------------------------------------------------------------
# calibration: measured sweeps -> the selector's tuning table
# ---------------------------------------------------------------------------


def example_input(collective: str, topo: Topology, nbytes: int,
                  dtype: torch.dtype = torch.float32,
                  devices: Optional[int] = None,
                  device="cuda") -> torch.Tensor:
    """A global operand for ``collective`` on ``device`` sized so the
    per-rank message is ``nbytes`` (the cost model's size convention), the
    reference's ``example_input`` values.

    ``devices`` is the grid's rank count D that the operand's rank dim
    spans; it defaults to ``topo.world`` (G) and must be passed for a group
    topology, where G < D."""
    G = topo.world
    D = int(devices) if devices is not None else G
    elems = max(1, int(nbytes) // dtype.itemsize)

    def arange(n):
        return torch.arange(n, dtype=dtype, device=device)

    if collective == "allgather":
        return arange(D * elems)
    if collective == "scatter":
        return arange(G * elems)
    if collective == "broadcast":
        return arange(elems)
    if collective == "allreduce":
        return (arange(D * elems) % 13).reshape(D, elems)
    if collective == "reduce_scatter":
        s = max(1, elems // G)
        return (arange(D * G * s) % 11).reshape(D, G * s)
    if collective == "alltoall":
        s = max(1, elems // G)
        return arange(D * G * s).reshape(D, G, s)
    raise ValueError(f"unknown collective {collective!r}; "
                     f"one of {collectives()}")


@dataclasses.dataclass(frozen=True)
class CalibrationRow:
    collective: str
    algo: str
    nbytes: int
    dtype: str
    seconds: float
    chunks: int = 1
    codec: str = "none"
    #: sub-communicator group tag ("" = the root topology); split-lattice
    #: sweeps (``Communicator.calibrate(include_splits=True)``) fill this
    group: str = ""


def _synchronize(grid) -> None:
    """Wait for the grid's device: the counterpart of the reference's
    ``block_until_ready``. The CPU runs eagerly, so there is nothing to
    wait for there."""
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)


def calibrate(grid, topo: Topology,
              names: Optional[Iterable[str]] = None,
              sizes: Iterable[int] = (256, 4096, 65536),
              dtype: torch.dtype = torch.float32, iters: int = 10,
              selector: Optional[autotune.Selector] = None,
              codecs: Optional[Tuple[str, ...]] = None,
              path=None) -> List[CalibrationRow]:
    """Timed sweeps of every candidate plan x size through the cached call
    path the hot loops use, recorded into the selector's tuning table (and
    saved to ``path`` as JSON when given).

    Plans are ``autotune.plans``: every feasible algorithm, chunk-count
    variants of the pipelined ones, codec variants of the codec-capable
    ones (``codecs=()`` keeps the lossless plans only). Each sample is the
    host clock around one call that ends in a device synchronize; a plan's
    row is the median of ``iters`` samples after one warm call. Afterwards
    ``algo="auto"`` on this (topology, collective, dtype, size bucket)
    resolves from measurement, codec plans still gated by the caller's
    ``error_budget``. With telemetry on, each plan's warm call and samples
    lie in one ``calibrate/<collective>/<plan>`` span and every sample is a
    synced plan observation."""
    sel = selector if selector is not None else autotune.default_selector()
    dt = dtype_name(dtype)
    rows: List[CalibrationRow] = []
    for name in (tuple(names) if names else collectives()):
        for nb in sizes:
            x = example_input(name, topo, int(nb), dtype,
                              devices=grid.world, device=grid.device)
            for algo, chunks, codec in autotune.plans(
                    name, topo, int(nb), codecs=codecs, dtype=dt):
                kw: Dict[str, Any] = {}
                if _mcoll.supports_chunks(name, algo):
                    kw["chunks"] = chunks
                if codec != _codecs.NONE:
                    kw["codec"] = codec
                plan = autotune.encode_plan(algo, chunks, codec)
                tm_on = _tm.enabled()
                with _tm.span(f"calibrate/{name}/{plan}", cat="calibrate",
                              **(_span_tags(topo, name, algo, kw,
                                            nbytes=int(nb))
                                 if tm_on else {})):
                    run(grid, topo, name, algo, x, **kw)  # warm: build
                    _synchronize(grid)
                    samples = []
                    for _ in range(max(1, int(iters))):
                        t0 = time.perf_counter()
                        run(grid, topo, name, algo, x, **kw)
                        _synchronize(grid)
                        samples.append(time.perf_counter() - t0)
                if tm_on:
                    # a window that ends in a device synchronize: the
                    # drift detector's best evidence
                    for sample in samples:
                        _tm.observe_plan(topo, name, dt, int(nb), plan,
                                         sample, synced=True)
                sec = float(statistics.median(samples))
                sel.table.record(topo, name, dt, int(nb), plan, sec)
                rows.append(CalibrationRow(name, algo, int(nb), dt, sec,
                                           chunks, codec,
                                           group=topo.group or ""))
    if path is not None:
        sel.table.save(path)
    return rows
