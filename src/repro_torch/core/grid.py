"""In-device rank grid: the port's counterpart of the reference's
single-process device mesh and its ``lax`` collectives.

The reference runs every algorithm under ``shard_map`` over a
``(node, local)`` mesh of devices in one process; its operands are global
and row *d* belongs to device *d*. A :class:`RankGrid` keeps that
convention with the ranks resident on ONE device: every operand carries a
leading flat-rank dim in row-major ``(node, local)`` order, and each
primitive below is the ``lax`` collective of the same name applied to all
ranks at once. This is the paper's own premise — PiP ranks share one
address space, and a send is a copy out of a peer's buffer — so a
``ppermute`` round is one index gather over rows and a ``psum`` is an
ordered sum over the group's rows.

The row moves are the staging kernels (``kernels/staging.py``): ``roll``
is ``shift_blocks`` (the paper's step 6), and ``ppermute``, ``take`` and
``dynamic_slice`` are ``pack_blocks``. On the card they launch the
hand-written kernels; on the CPU they run the plain index gathers of
``kernels/ref.py``. A ``ppermute`` round gathers over flat ranks through a
``(world,)`` source map built once per ``(axes, pairs)`` and kept on the
grid's device, so a repeated round builds nothing on the host. ``psum``,
``psum_scatter``, ``all_gather``, ``all_to_all`` and ``where`` stay torch
ops: they are the reference's ``lax`` collectives, not Pallas kernels.

Under the work counter (``roofline/counter.py``) each collective
primitive counts once per call under the reference's HLO op name, with the
larger of its operand's and its result's bytes per held rank.

Sums run in rank order (``((x0 + x1) + x2) + ...``), the same order for
every element and every payload length, so a reduction is elementwise
deterministic: splitting a payload into buckets never changes a bit.

The algorithms in ``core.mcoll`` are written once against these
primitives. A :class:`ProcessGrid` has the same interface over several
processes: one process is one node, holding its ``n_local`` ranks' rows;
the local axis stays inside the process (the rows above), while the node
axis and the flat ``("node", "local")`` axis cross processes over a
``torch.distributed`` gloo process group.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import telemetry as _tm
from repro_torch.distributed import backend as _backend
from repro_torch.kernels import _dispatch, staging

Axes = Union[str, Sequence[str]]

#: unsigned types PyTorch's CPU kernels cover only in part (no index_put,
#: no where); the grid moves and sums them as the signed type of the same
#: width: the same bits, and two's-complement addition wraps alike
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _signed(fn):
    """Run a primitive on the signed view of an unsigned operand and view
    the result back."""
    def call(self, x, *args, **kw):
        dt = _SIGNED_VIEW.get(x.dtype)
        if dt is None:
            return fn(self, x, *args, **kw)
        return fn(self, x.view(dt), *args, **kw).view(x.dtype)
    call.__name__, call.__doc__ = fn.__name__, fn.__doc__
    return call


def _collective(op: str):
    """Count each call of a primitive under the work counter as one
    ``op`` of ``max(operand, result)`` bytes per held rank (a call made
    inside another primitive is part of it)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(self, x, *args, **kw):
            c = _dispatch.counter()
            if c is None:
                return fn(self, x, *args, **kw)
            with c.collective(op) as box:
                out = fn(self, x, *args, **kw)
                box[0] = max(_dispatch.nbytes(x), _dispatch.nbytes(out)) \
                    / self.rows
            return out
        return call
    return wrap


def resolve_device(device) -> torch.device:
    """``device`` as a tensor made on it reports it: where there is a card,
    ``"cuda"`` names the current one with its index, so two spellings of
    one card compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class RankGrid:
    """``n_nodes x n_local`` ranks, each a row of every operand.

    ``device`` defaults to ``"cuda"``: a grid places its ranks on the card
    unless the caller asks for the CPU, and holds it resolved (``cuda`` is
    the current card, ``cuda:0``), as its operands report it. Constructing
    a grid allocates nothing; operands and results live on ``device``.

    An operand's dim 0 holds the ``rows`` ranks this process holds, flat
    ranks ``offset .. offset + rows - 1``: all ``world`` of them here, one
    node's in a :class:`ProcessGrid`.
    """

    axis_names: Tuple[str, str] = ("node", "local")
    #: processes the grid's ranks live in
    process_count: int = 1

    def __init__(self, n_nodes: int = 1, n_local: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        if int(n_nodes) < 1 or int(n_local) < 1:
            raise ValueError(f"invalid rank grid {n_nodes}x{n_local}")
        self.n_nodes = int(n_nodes)
        self.n_local = int(n_local)
        self.device = resolve_device(device)
        self.rows, self.offset = self.world, 0
        # (axes, pairs) -> (world,) flat source map of a ppermute round
        self._src_maps: Dict[tuple, torch.Tensor] = {}

    def __repr__(self) -> str:
        return f"RankGrid({self.n_nodes}, {self.n_local}, {self.device})"

    def _key(self) -> tuple:
        return (self.n_nodes, self.n_local, self.device)

    def __eq__(self, other) -> bool:
        return isinstance(other, RankGrid) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    @property
    def world(self) -> int:
        return self.n_nodes * self.n_local

    @property
    def shape(self) -> Dict[str, int]:
        return {"node": self.n_nodes, "local": self.n_local}

    # -- group views --------------------------------------------------------

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        ax = (axes,) if isinstance(axes, str) else tuple(dict.fromkeys(axes))
        if ax not in (("node",), ("local",), ("node", "local")):
            raise ValueError(f"axes {axes!r} must name grid axes in "
                             f"{self.axis_names} order")
        return ax

    def _group_size(self, axes: Axes) -> int:
        return {("node",): self.n_nodes, ("local",): self.n_local,
                ("node", "local"): self.world}[self._axes(axes)]

    def _groups(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``(rows, *s)`` -> ``(n_groups, group_size, *s)``: ranks that
        differ only along ``axes`` share a group, members in row-major
        order over ``axes``. (A :class:`ProcessGrid` groups its rows here
        along the local axis only.)"""
        self._rows(x)
        ax = self._axes(axes)
        rest = tuple(x.shape[1:])
        if ax == ("node", "local"):
            return x.reshape((1, self.world) + rest)
        g = x.reshape((self.rows // self.n_local, self.n_local) + rest)
        return g if ax == ("local",) else g.transpose(0, 1)

    def _ungroup(self, g: torch.Tensor, axes: Axes) -> torch.Tensor:
        ax = self._axes(axes)
        rest = tuple(g.shape[2:])
        if ax == ("node",):
            g = g.transpose(0, 1)
        return g.reshape((self.rows,) + rest)

    def _sum_members(self, g: torch.Tensor) -> torch.Tensor:
        """Rank-ordered sum over dim 1 of a group view."""
        acc = g[:, 0].clone()
        for m in range(1, g.shape[1]):
            acc += g[:, m]
        return acc

    # -- the lax primitives -------------------------------------------------

    def axis_index(self, axes: Axes) -> torch.Tensor:
        """Each held rank's index within its group along ``axes``
        (``(rows,)`` int64 on the grid's device) — ``lax.axis_index`` for
        every rank."""
        ax = self._axes(axes)
        r = torch.arange(self.offset, self.offset + self.rows,
                         device=self.device)
        if ax == ("local",):
            return r % self.n_local
        if ax == ("node",):
            return r // self.n_local
        return r

    @_collective("all-reduce")
    @_signed
    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Every rank gets the sum of its group's rows."""
        g = self._groups(x, axes)
        s = self._sum_members(g)
        return self._ungroup(s.unsqueeze(1).expand_as(g), axes)

    @_collective("reduce-scatter")
    @_signed
    def psum_scatter(self, x: torch.Tensor, axes: Axes,
                     tiled: bool = True) -> torch.Tensor:
        """Reduce-scatter over dim 0 of each rank's payload: member m gets
        chunk m of the group sum (tiled: ``(n,)`` -> ``(n/G,)``; untiled:
        dim 0 must equal G and is consumed)."""
        g = self._groups(x, axes)
        G = g.shape[1]
        s = self._sum_members(g)
        if tiled:
            if s.shape[1] % G:
                raise ValueError(f"psum_scatter dim {s.shape[1]} not "
                                 f"divisible by group size {G}")
            s = s.reshape((s.shape[0], G, s.shape[1] // G) + s.shape[2:])
        elif s.shape[1] != G:
            raise ValueError(f"untiled psum_scatter needs dim0 == {G}")
        return self._ungroup(s, axes)

    @_collective("all-gather")
    def all_gather(self, x: torch.Tensor, axes: Axes,
                   tiled: bool = False) -> torch.Tensor:
        """Every rank gets its group's rows stacked on a new dim 0
        (``tiled``: concatenated along dim 0 instead)."""
        g = self._groups(x, axes)
        Go, G = g.shape[:2]
        out = g.unsqueeze(1).expand((Go, G) + tuple(g.shape[1:]))
        if tiled:
            out = out.reshape((Go, G, G * g.shape[2]) + tuple(g.shape[3:]))
        return self._ungroup(out, axes)

    @_collective("all-to-all")
    def all_to_all(self, x: torch.Tensor, axes: Axes, split_axis: int,
                   concat_axis: int, tiled: bool = False) -> torch.Tensor:
        """``lax.all_to_all``. Untiled: each rank's ``split_axis`` (size G)
        is split into G slices, slice j goes to member j, and the received
        slices stack along a new ``concat_axis`` in source order. Tiled
        (``split_axis == concat_axis`` only): the axis is cut into G equal
        chunks, chunk j goes to member j, and the received chunks are
        concatenated along the same axis in source order."""
        self._rows(x)
        G = self._group_size(axes)
        n = x.shape[1 + split_axis]
        if tiled:
            if split_axis != concat_axis:
                raise ValueError("tiled all_to_all needs split_axis == "
                                 "concat_axis")
            if n % G:
                raise ValueError(f"tiled all_to_all split dim {n} not "
                                 f"divisible by group size {G}")
            shape = tuple(x.shape)
            d = 1 + split_axis
            y = self.all_to_all(
                x.reshape(shape[:d] + (G, n // G) + shape[d + 1:]), axes,
                split_axis, split_axis)
            return y.reshape(shape)
        if n != G:
            raise ValueError(f"all_to_all split dim {n} != group size {G}")
        return self._exchange_slices(x, axes, split_axis, concat_axis)

    def _exchange_slices(self, x: torch.Tensor, axes: Axes, split_axis: int,
                         concat_axis: int) -> torch.Tensor:
        """The untiled all-to-all's exchange, its shapes already checked."""
        g = self._groups(x, axes)
        y = g.movedim(2 + split_axis, 2).transpose(1, 2)  # (Go, dst, src, ..)
        return self._ungroup(y.movedim(2, 2 + concat_axis), axes)

    def _round_key(self, axes: Axes, pairs) -> tuple:
        """One ppermute round's normalized ``(axes, pairs)``."""
        return (self._axes(axes),
                tuple((int(s), int(d)) for s, d in pairs))

    def _flat_src(self, key: tuple) -> torch.Tensor:
        """The ``(world,)`` flat source map of the ppermute round ``key``
        on the host: entry ``d`` is the flat rank whose row rank ``d``
        receives, -1 where no member sends."""
        ax, pairs = key
        # members[g, m]: flat rank of member m of group g
        flat = torch.arange(self.world).reshape(self.n_nodes, self.n_local)
        members = {("node", "local"): flat.reshape(1, self.world),
                   ("local",): flat, ("node",): flat.t()}[ax]
        src = torch.full((self.world,), -1, dtype=torch.long)
        for s, d in pairs:
            src[members[:, d]] = members[:, s]
        return src

    def _src_map(self, axes: Axes, pairs) -> torch.Tensor:
        """The flat source map of one ppermute round (:meth:`_flat_src`),
        built once per ``(axes, pairs)`` and kept on the grid's device."""
        key = self._round_key(axes, pairs)
        hit = self._src_maps.get(key)
        if hit is None:
            hit = self._src_maps[key] = self._flat_src(key).to(self.device)
        return hit

    @_collective("collective-permute")
    def ppermute(self, x: torch.Tensor, axes: Axes,
                 pairs: Iterable[Tuple[int, int]]) -> torch.Tensor:
        """Static permutation within each group: member ``dst`` receives
        member ``src``'s row for every ``(src, dst)`` pair; members with no
        sender get zeros. One row gather over the flat ranks
        (``pack_blocks``)."""
        self._rows(x)
        return staging.pack_blocks(x, self._src_map(axes, pairs))

    # -- per-rank row helpers -----------------------------------------------
    #
    # The reference computes rank-dependent offsets from ``lax.axis_index``
    # inside each device's body; here that index is a ``(world,)`` tensor
    # (``axis_index``) and each helper is one index gather over the rows of
    # every rank at once. "Row" is dim 0 of a rank's payload (tensor dim 1).

    def _rows(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.rows:
            raise ValueError(f"operand dim0 {x.shape[0]} != the grid's "
                             f"{self.rows} held ranks")

    def take(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``jnp.take(x_r, idx_r, axis=0)`` for every rank ``r``: ``idx``
        ``(rows,)`` takes one row per rank (the row dim is consumed);
        ``(rows, J)`` takes J rows per rank (``pack_blocks``). Every index
        must lie in ``[0, K)``: on the CPU one outside raises
        ``IndexError``; on the card it is not checked (that would read the
        index back to the host) and gives a zero row."""
        self._rows(x)
        idx = idx.to(x.device)
        if x.device.type == "cpu" and idx.numel() and (
                bool((idx < 0).any()) or bool((idx >= x.shape[1]).any())):
            raise IndexError(f"take: index outside [0, {x.shape[1]})")
        if idx.dim() == 1:
            return staging.pack_blocks(x, idx[:, None]).squeeze(1)
        return staging.pack_blocks(x, idx)

    def roll(self, x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
        """``jnp.roll(x_r, shift_r, axis=0)`` for every rank: row ``k`` of
        the result is row ``(k - shift_r) % K`` of the input
        (``shift_blocks``)."""
        self._rows(x)
        return staging.shift_blocks(x, shift.to(x.device))

    def dynamic_slice(self, x: torch.Tensor, start: torch.Tensor,
                      size: int) -> torch.Tensor:
        """``lax.dynamic_slice_in_dim(x_r, start_r, size, axis=0)`` for
        every rank, the start clamped into ``[0, K - size]`` as lax does."""
        K = x.shape[1]
        if not 0 <= size <= K:
            raise ValueError(f"slice size {size} outside [0, {K}]")
        s = start.to(x.device).clamp(0, K - size)
        return self.take(x, s[:, None]
                         + torch.arange(size, device=x.device)[None, :])

    def where(self, cond: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
        """``jnp.where(cond_r, a_r, b_r)`` with one boolean per rank: rank
        ``r`` gets ``a``'s row where ``cond[r]``, else ``b``'s. A select, so
        every bit (a signed zero too) comes through unchanged."""
        self._rows(a)
        if a.dtype in _SIGNED_VIEW and b.dtype == a.dtype:
            dt = _SIGNED_VIEW[a.dtype]
            return self.where(cond, a.view(dt), b.view(dt)).view(a.dtype)
        c = cond.to(a.device).reshape((self.rows,)
                                      + (1,) * (max(a.dim(), b.dim()) - 1))
        return torch.where(c, a, b)


class ProcessGrid(RankGrid):
    """An ``n_nodes x n_local`` grid over ``n_nodes`` processes of the
    initialized ``torch.distributed`` process group: one process is one
    node. This process is node ``rank`` and holds its ``n_local`` ranks'
    rows, flat ranks ``offset = rank * n_local`` on, in every operand and
    result; :meth:`axis_index` gives those rows' indices.

    The local axis never leaves the process: its primitives and the
    per-rank helpers (``take``, ``roll``, ``dynamic_slice``, ``where``)
    are :class:`RankGrid`'s on the held rows, the staging kernels on the
    card (the PiP shared-address-space side). The node axis and the flat
    ``("node", "local")`` axis cross processes:

      * ``ppermute`` gathers the rows whose source is in this process with
        one ``pack_blocks`` and receives the others by one
        ``dist.batch_isend_irecv``, one contiguous buffer to and from each
        peer process, each packed by ``pack_blocks``; a rank with no sender
        gets zeros. The split maps are built once per ``(axes, pairs)``;
      * ``all_gather`` and ``all_to_all`` exchange the held rows, or the
        slices bound for each peer, by one ``batch_isend_irecv``;
      * ``psum`` gathers the group's rows and ``psum_scatter`` each
        member's chunk of them, then both sum in rank order, as
        ``RankGrid`` does, never through ``dist.all_reduce``: a reduction
        stays elementwise deterministic and bitwise the one-process grid's.

    The transport is gloo, the process group's backend (any other raises
    ``NotImplementedError``, see ``distributed.backend``). Every payload
    travels as a contiguous byte view (``.view(torch.uint8)``), so gloo
    never sees a dtype and fp8 wire forms, unsigned and bool tensors pass
    bit for bit. gloo sends and receives host memory: on the card the
    transport copies each outgoing buffer to the host and each incoming
    one back to the grid's device (the rows, the kernels and the results
    stay on the card). With telemetry on, each exchange is one
    ``transport/<primitive>`` span tagged ``transport="gloo"`` with its
    bytes; ``bytes_sent`` counts what this process has sent.
    """

    def __init__(self, n_nodes: int = 1, n_local: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(n_nodes, n_local, device)
        be = _backend.current_backend()
        if be.process_count != self.n_nodes:
            raise ValueError(
                f"a ProcessGrid of {self.n_nodes} nodes needs as many "
                f"processes; the process group has {be.process_count}")
        self.rank = be.process_index
        self.rows, self.offset = self.n_local, self.rank * self.n_local
        self.bytes_sent = 0
        # (axes, pairs) -> (local map, {peer: send rows}, {peer: recv pos})
        self._routes: Dict[tuple, tuple] = {}

    def __repr__(self) -> str:
        return (f"ProcessGrid({self.n_nodes}, {self.n_local}, {self.device}, "
                f"rank={self.rank})")

    def _key(self) -> tuple:
        return super()._key() + ("process", self.rank)

    @property
    def process_count(self) -> int:
        return self.n_nodes

    # -- the wire ------------------------------------------------------------

    def _held(self, ax: Tuple[str, ...]) -> Tuple[int, int]:
        """``(groups, members)`` of a cross-process axis among the held
        rows: on the node axis each held row is this process's member of
        its own column group; on the flat axis they are ``n_local``
        consecutive members of the one group."""
        return (self.n_local, 1) if ax == ("node",) else (1, self.n_local)

    @staticmethod
    def _wire(t: torch.Tensor) -> torch.Tensor:
        """``t`` as contiguous bytes in host memory."""
        return t.contiguous().reshape(-1).view(torch.uint8).cpu()

    def _peers(self) -> List[int]:
        return [j for j in range(self.n_nodes) if j != self.rank]

    def _exchange(self, what: str, sends: Dict[int, torch.Tensor],
                  recv_bytes: Dict[int, int]) -> Dict[int, torch.Tensor]:
        """One ``dist.batch_isend_irecv``: the host bytes ``sends[j]`` to
        process ``j``, ``recv_bytes[j]`` bytes back from each ``j`` (host
        tensors). Empty buffers are not sent: both sides know the sizes."""
        sends = {j: b for j, b in sends.items() if b.numel()}
        bufs = {j: torch.empty(n, dtype=torch.uint8)
                for j, n in recv_bytes.items() if n}
        if not sends and not bufs:
            return {}
        nbytes = sum(b.numel() for b in sends.values())
        ops = [dist.P2POp(dist.isend, b, j) for j, b in sends.items()]
        ops += [dist.P2POp(dist.irecv, b, j) for j, b in bufs.items()]
        with _tm.span(f"transport/{what}", cat="transport",
                      transport=_backend.TRANSPORT, bytes_sent=nbytes,
                      bytes_received=sum(recv_bytes.values())):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.bytes_sent += nbytes
        return bufs

    def _receive(self, buf: Optional[torch.Tensor], shape, dtype
                 ) -> torch.Tensor:
        """Received bytes as a ``shape``/``dtype`` tensor on the grid's
        device."""
        if buf is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        return buf.view(dtype).reshape(shape).to(self.device)

    def _gather_members(self, x: torch.Tensor, ax) -> torch.Tensor:
        """``(groups, G, *s)``: every member's row of the held rows' groups
        along the cross-process axis ``ax``, in member order."""
        Gh, h = self._held(ax)
        mine = x.reshape((Gh, h) + tuple(x.shape[1:]))
        wire = self._wire(mine)
        got = self._exchange("all_gather", {j: wire for j in self._peers()},
                             {j: wire.numel() for j in self._peers()})
        return torch.cat([mine if j == self.rank else
                          self._receive(got.get(j), mine.shape, x.dtype)
                          for j in range(self.n_nodes)], dim=1)

    # -- the lax primitives across processes ----------------------------------

    @_collective("all-reduce")
    @_signed
    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        ax = self._axes(axes)
        if ax == ("local",):
            return super().psum(x, axes)
        self._rows(x)
        s = self._sum_members(self._gather_members(x, ax))
        Gh, h = self._held(ax)
        rest = tuple(s.shape[1:])
        return s.unsqueeze(1).expand((Gh, h) + rest).reshape(
            (self.rows,) + rest)

    @_collective("reduce-scatter")
    @_signed
    def psum_scatter(self, x: torch.Tensor, axes: Axes,
                     tiled: bool = True) -> torch.Tensor:
        ax = self._axes(axes)
        if ax == ("local",):
            return super().psum_scatter(x, axes, tiled)
        self._rows(x)
        G = self._group_size(ax)
        if not tiled:
            if x.shape[1] != G:
                raise ValueError(f"untiled psum_scatter needs dim0 == {G}")
            return self._sum_members(self.all_to_all(x, ax, 0, 0))
        if x.shape[1] % G:
            raise ValueError(f"psum_scatter dim {x.shape[1]} not divisible "
                             f"by group size {G}")
        y = self.all_to_all(x, ax, 0, 0, tiled=True)
        return self._sum_members(y.reshape(
            (self.rows, G, x.shape[1] // G) + tuple(x.shape[2:])))

    @_collective("all-gather")
    def all_gather(self, x: torch.Tensor, axes: Axes,
                   tiled: bool = False) -> torch.Tensor:
        ax = self._axes(axes)
        if ax == ("local",):
            return super().all_gather(x, axes, tiled)
        self._rows(x)
        g = self._gather_members(x, ax)
        Gh, h = self._held(ax)
        rest = tuple(g.shape[1:])
        out = g.unsqueeze(1).expand((Gh, h) + rest).reshape(
            (self.rows,) + rest)
        if tiled:
            out = out.reshape((self.rows, rest[0] * rest[1]) + rest[2:])
        return out

    def _exchange_slices(self, x: torch.Tensor, axes: Axes, split_axis: int,
                         concat_axis: int) -> torch.Tensor:
        ax = self._axes(axes)
        if ax == ("local",):
            return super()._exchange_slices(x, axes, split_axis,
                                            concat_axis)
        Gh, h = self._held(ax)
        # (groups, src members held, dst members, *rest)
        v = x.reshape((Gh, h) + tuple(x.shape[1:])).movedim(2 + split_axis,
                                                            2)

        def bound_for(j):  # the slices for process j's members
            return v.narrow(2, j * h, h)
        shape = tuple(bound_for(self.rank).shape)
        nbytes = math.prod(shape) * x.element_size()
        got = self._exchange(
            "all_to_all", {j: self._wire(bound_for(j)) for j in self._peers()},
            {j: nbytes for j in self._peers()})
        y = torch.cat([bound_for(j) if j == self.rank else
                       self._receive(got.get(j), shape, x.dtype)
                       for j in range(self.n_nodes)], dim=1)
        y = y.transpose(1, 2).movedim(2, 2 + concat_axis)  # (Gh, dst, ..)
        return y.reshape((self.rows,) + tuple(y.shape[2:]))

    def _route(self, axes: Axes, pairs) -> tuple:
        """``(local, sends, recvs)`` of one ppermute round, built once per
        ``(axes, pairs)`` on the grid's device: ``local`` ``(rows,)`` maps
        each held row to the held row it receives (-1 where its source is
        in another process or there is none); ``sends[j]`` lists the held
        rows process ``j`` receives, in the order of its rows; ``recvs[j]``
        the held rows that receive process ``j``'s buffer, in order."""
        key = self._round_key(axes, pairs)
        hit = self._routes.get(key)
        if hit is not None:
            return hit
        src = self._flat_src(key).tolist()
        n, lo = self.rows, self.offset
        mine = src[lo:lo + n]
        local = [s - lo if s >= 0 and s // n == self.rank else -1
                 for s in mine]
        sends, recvs = {}, {}
        for j in self._peers():
            pos = [i for i, s in enumerate(mine) if s >= 0 and s // n == j]
            idx = [s - lo for s in src[j * n:(j + 1) * n]
                   if s >= 0 and s // n == self.rank]
            if pos:
                recvs[j] = torch.tensor(pos, device=self.device)
            if idx:
                sends[j] = torch.tensor(idx, device=self.device)
        hit = self._routes[key] = (
            torch.tensor(local, device=self.device), sends, recvs)
        return hit

    @_collective("collective-permute")
    def ppermute(self, x: torch.Tensor, axes: Axes,
                 pairs: Iterable[Tuple[int, int]]) -> torch.Tensor:
        self._rows(x)
        local, sends, recvs = self._route(axes, pairs)
        out = staging.pack_blocks(x, local)
        row_bytes = math.prod(x.shape[1:]) * x.element_size()
        got = self._exchange(
            "ppermute",
            {j: self._wire(staging.pack_blocks(x, idx))
             for j, idx in sends.items()},
            {j: len(pos) * row_bytes for j, pos in recvs.items()})
        if got:
            # the received rows land in place as bytes: any dtype
            flat = out.view((self.rows, -1)).view(torch.uint8)
            for j, pos in recvs.items():
                flat.index_copy_(0, pos, got[j].view(len(pos), -1).to(
                    self.device))
        return out
