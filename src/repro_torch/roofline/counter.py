"""The work counter: FLOPs, memory bytes and collectives of an eager
program (the port's counterpart of ``repro.roofline.hlo``).

The reference parses the post-SPMD HLO text of a compiled step. An eager
PyTorch program has no HLO, so :class:`WorkCounter` counts the program as
it runs, on ``meta``, ``cpu`` or ``cuda`` alike, with a
``TorchDispatchMode`` that sees every aten op below autograd:

  flops            the dot FLOPs of every product, by the formulas of
                   ``torch.utils.flop_counter`` (``FlopCounterMode``'s own
                   registry: ``mm``, ``bmm``, ``addmm``, convolutions,
                   attention)
  memory bytes     the bytes of each aten op's tensor inputs and outputs;
                   views and allocations count zero, ``copy_`` and
                   ``fill_`` only what they write. XLA fuses and folds
                   converts into their consumer; the eager program writes
                   every op's output to memory, so this number is the
                   eager program's own, not comparable with the
                   reference's
  collective bytes each grid primitive of ``core/grid.py`` once per call
                   under the reference's op names (``all-reduce``,
                   ``reduce-scatter``, ``all-gather``, ``all-to-all``,
                   ``collective-permute``), at the larger of its operand's
                   and its result's bytes per rank, as ``hlo.py`` counts
                   an instruction per device
  kernels          each hand-written kernel once per call, by the cost
                   registered beside its wrapper (``kernels/_dispatch``):
                   its bytes join the memory bytes, its fp32 operations
                   ``kernel_ops``; the aten ops beneath (its plain
                   version's on the CPU) are not counted, so a call counts
                   the same on every device

A Python loop counts once per iteration run: the trip-count weighting
``hlo.py`` has to work out. ``peak_live_bytes`` is the high point of the
bytes held by the tensors the counted program made (its arguments not
included): a one-device program's live peak, not the reference's
``temp_bytes``.

On ``meta`` the counter also skips rerunning an op it has seen with the
same operand shapes, strides and dtypes and the same other arguments: it
makes the outputs from the shapes it recorded (views and ops that return
other than tensors always run). Meta kernels of elementwise ops run
through Python decompositions, 0.1-0.4 ms an op, and a streaming
attention repeats one tile's ops thousands of times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _dispatch

aten = torch.ops.aten

#: ops that move no bytes: allocations without a fill, aliases that the
#: schema does not mark as views
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.lift_fresh.default,
         aten._unsafe_view.default, aten.detach.default,
         aten.alias.default, aten.set_.source_Storage_storage_offset,
         aten.resize_.default}
#: ops that write their first argument without reading it
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}
#: shape rules on ``meta`` for ops whose output shape depends on the
#: data: ``bincount`` gives ``minlength`` bins (its values taken to lie
#: below it, as the MoE's expert ids do)
_META_RULES = {
    aten.bincount.default: lambda x, weights=None, minlength=0: torch.empty(
        (minlength,), dtype=torch.long if weights is None else weights.dtype,
        device="meta"),
}
#: hashable non-tensor argument types of the meta cache's keys
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


@dataclasses.dataclass
class Costs:
    """One count: ``HloCosts``' fields (``flops``, ``memory_bytes``,
    ``collective_bytes``, ``collective_counts``,
    ``collective_bytes_by_op``), whole-program, plus the kernels' share
    and the live peak."""

    flops: float
    memory_bytes: float
    collective_bytes: float
    collective_counts: Dict[str, int]
    collective_bytes_by_op: Dict[str, float]
    kernel_ops: float
    kernels: Dict[str, Dict[str, float]]
    aten_ops: int
    peak_live_bytes: int

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of an op's (nested) arguments or outputs, in order."""
    out = [] if out is None else out
    for x in (tree if isinstance(tree, (list, tuple)) else (tree,)):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
        elif isinstance(x, dict):
            _tensors(tuple(x.values()), out)
    return out


class _Uncacheable(Exception):
    pass


def _desc(x):
    """A hashable description of one argument for the meta cache."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Uncacheable
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_desc(e) for e in x)
    if isinstance(x, _PLAIN):
        return (type(x), x)
    raise _Uncacheable


class WorkCounter(TorchDispatchMode):
    """Count what the program run inside the ``with`` does; read
    :meth:`costs` after. Counters do not nest in one thread."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.memory_bytes = 0.0
        self.kernel_ops = 0.0
        self.aten_ops = 0
        self.collective_counts: Dict[str, int] = defaultdict(int)
        self.collective_bytes_by_op: Dict[str, float] = defaultdict(float)
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.by_op: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        self.live = self.peak_live = 0
        self._scale = 1
        self._quiet = 0          # inside a kernel call
        self._in_collective = 0  # inside a grid primitive
        self._cache: Dict[tuple, Any] = {}

    # -- the context and its hooks ------------------------------------------

    def __enter__(self):
        if _dispatch.COUNTERS:
            raise RuntimeError("work counters do not nest")
        _dispatch.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _dispatch.COUNTERS.remove(self)
            self._scale = 1

    @contextlib.contextmanager
    def kernel(self, name: str, cost: _dispatch.Cost):
        """One hand-written kernel call: its registered cost, and nothing
        of the aten ops run inside."""
        rec = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                             "ops": 0.0})
        rec["calls"] += self._scale
        rec["bytes"] += self._scale * cost.nbytes
        rec["ops"] += self._scale * cost.ops
        self.memory_bytes += self._scale * cost.nbytes
        self.kernel_ops += self._scale * cost.ops
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    @contextlib.contextmanager
    def collective(self, op: str):
        """One grid primitive, counted once as ``op``; the primitive puts
        its bytes per rank into the yielded one-element list. Primitives
        it calls are part of it."""
        outer = not self._in_collective
        box = [0.0]
        self._in_collective += 1
        try:
            yield box
        finally:
            self._in_collective -= 1
        if outer:
            self.collective_counts[op] += self._scale
            self.collective_bytes_by_op[op] += self._scale * box[0]

    @contextlib.contextmanager
    def hidden(self):
        """Run ops inside without counting them."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    @contextlib.contextmanager
    def scaled(self, n: int):
        """Count everything inside ``n`` times: ``n`` ranks doing work of
        the same shapes, one of them run (``layers/moe.py``)."""
        self.push_scale(n)
        try:
            yield
        finally:
            self.pop_scale(n)

    def push_scale(self, n: int) -> None:
        self._scale *= int(n)

    def pop_scale(self, n: int) -> None:
        self._scale //= int(n)

    # -- the dispatch mode --------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._quiet:
            return func(*args, **kwargs)
        flat = _tensors((args, kwargs))
        out = self._run(func, args, kwargs, flat)
        self._account(func, args, kwargs, out, flat)
        return out

    def _run(self, func, args, kwargs, flat):
        """``func`` on its arguments, or on ``meta`` its outputs made from
        the shapes an earlier call with the same descriptions gave."""
        if func.is_view:
            return func(*args, **kwargs)
        rule = _META_RULES.get(func)
        if rule is not None and flat and all(t.device.type == "meta"
                                             for t in flat):
            return rule(*args, **kwargs)
        try:
            key = (func, _desc(args), _desc(tuple(sorted(kwargs.items()))))
        except _Uncacheable:
            return func(*args, **kwargs)
        spec = self._cache.get(key)
        if spec is None:
            before = [(t.shape, t.stride()) for t in flat]
            out = func(*args, **kwargs)
            self._cache[key] = self._spec(flat, out, before)
            return out
        if spec is False:
            return func(*args, **kwargs)
        made = [flat[s] if isinstance(s, int) else
                torch.empty_strided(s[0], s[1], dtype=s[2], device="meta")
                for s in spec[1]]
        return made[0] if spec[0] is None else type(spec[0])(made)

    @staticmethod
    def _spec(flat, out, before):
        """How to remake ``out``: per output tensor, the index of the
        argument it is (an in-place op's) or its (size, stride, dtype);
        False where that cannot be done (outputs off ``meta`` or other
        than tensors, views, an argument whose shape the op changed)."""
        outs = [out] if isinstance(out, torch.Tensor) else out
        if not isinstance(outs, (list, tuple)) or not outs or \
                not all(isinstance(o, torch.Tensor)
                        and o.device.type == "meta" for o in outs):
            return False
        stores = {t.untyped_storage()._cdata for t in flat}
        made = []
        for o in outs:
            same = [i for i, t in enumerate(flat) if t is o]
            if same:
                if before[same[0]] != (o.shape, o.stride()):
                    return False
                made.append(same[0])
            elif o.untyped_storage()._cdata in stores:
                return False
            else:
                made.append((o.shape, o.stride(), o.dtype))
        return (None if isinstance(out, torch.Tensor) else out, made)

    def _account(self, func, args, kwargs, out, ins) -> None:
        n = self._scale
        self.aten_ops += n
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += n * flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        if func.is_view or func in _FREE:
            return
        outs = _tensors(out)
        seen = {t.untyped_storage()._cdata for t in ins}
        read = ins[1:] if func in _WRITE_ONLY else ins
        moved = sum(map(_nbytes, read)) + sum(map(_nbytes, outs))
        self.memory_bytes += n * moved
        row = self.by_op[str(packet)]
        row[0] += n * moved
        row[1] += n
        for t in outs:
            store = t.untyped_storage()
            if store._cdata in seen:
                continue
            seen.add(store._cdata)
            size = store.nbytes()
            self.live += size
            self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(store, self._free, size)

    def _free(self, size: int) -> None:
        self.live -= size

    # -- results ------------------------------------------------------------

    def costs(self) -> Costs:
        return Costs(
            flops=self.flops, memory_bytes=self.memory_bytes,
            collective_bytes=sum(self.collective_bytes_by_op.values()),
            collective_counts=dict(self.collective_counts),
            collective_bytes_by_op=dict(self.collective_bytes_by_op),
            kernel_ops=self.kernel_ops,
            kernels={k: dict(v) for k, v in self.kernels.items()},
            aten_ops=self.aten_ops, peak_live_bytes=self.peak_live)

    def top_traffic(self, n: int = 25) -> List[Tuple[float, int, str]]:
        """The heaviest ops by bytes: ``(bytes, calls, op)``, the
        counterpart of ``hlo.top_traffic`` (kernels under their names)."""
        rows = [(b, c, op) for op, (b, c) in self.by_op.items()]
        rows += [(r["bytes"], r["calls"], f"kernel:{k}")
                 for k, r in self.kernels.items()]
        return sorted(rows, reverse=True)[:n]


def count(fn, *args, **kwargs) -> Tuple[Any, Costs]:
    """``fn(*args, **kwargs)`` under a fresh counter: ``(result, its
    costs)``."""
    with WorkCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.costs()
