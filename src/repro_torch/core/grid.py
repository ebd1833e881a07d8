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
processes, each holding consecutive ranks of one node, down to one rank a
process: an axis whose group lies in one process runs on the rows above,
and any other axis crosses processes through the grid's transport
(``distributed/transport.py``: the shared slots of ``"shm"`` among
processes of one card, else gloo's host copies) beside a
``torch.distributed`` gloo process group.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.distributed import backend as _backend
from repro_torch.distributed import transport as _transport
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
    ranks ``held`` (``offset .. offset + rows - 1``): all ``world`` of them
    here, this process's share in a :class:`ProcessGrid`.
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
        self.held: Tuple[int, ...] = tuple(range(self.world))
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

    def held_of(self, rows: torch.Tensor) -> torch.Tensor:
        """This process's rows of a ``(world, ...)`` tensor."""
        return rows

    def all_rows(self, x: torch.Tensor, device=None) -> torch.Tensor:
        """Every rank's row of ``x``, ``(world, *s)`` in flat rank order, on
        every process, on ``device`` (the grid's by default): here ``x``
        itself, every row being held."""
        self._rows(x)
        return x if device is None else x.to(device)

    def crosses(self, axis: str) -> bool:
        """Whether ``axis``'s groups span processes: never here."""
        return False

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
    """An ``n_nodes x n_local`` grid over the processes of the initialized
    ``torch.distributed`` process group. Its layout comes from the group:
    each of the ``P`` processes holds ``r = world / P`` consecutive flat
    ranks, process ``p`` ranks ``p * r`` on, and ``r`` must divide
    ``n_local``, so that a process holds ranks of one node; a node is then
    ``n_local / r`` processes, down to one rank a process. Every operand
    and result holds this process's rows (``rows``, flat ranks ``held``,
    from ``offset``); :meth:`axis_index` gives their indices.

    Each axis exchanges only with its own group's processes: the local axis
    with the processes of this node (the row), the node axis with the
    processes that hold the same local indices in every node (the column),
    the flat ``("node", "local")`` axis with all of them. An axis whose
    group lies in this process runs in place: the local axis of a node
    that is one process keeps :class:`RankGrid`'s code on the held rows,
    the staging kernels on the card (the PiP shared-address-space side),
    as do the per-rank helpers (``take``, ``roll``, ``dynamic_slice``,
    ``where``) on every layout. Across processes:

      * ``ppermute`` gathers the rows whose source is in this process with
        one ``pack_blocks`` and receives the others by one exchange of the
        transport, one contiguous buffer to and from each peer process,
        each packed by ``pack_blocks`` (rows that arrive consecutive land
        in place); a rank with no sender gets zeros. The split maps are
        built once per ``(axes, pairs)``;
      * ``all_gather`` and ``all_to_all`` exchange the held rows, or the
        slices bound for each peer, by one exchange with the group's
        processes and place what comes back in member order;
      * ``psum`` gathers the group's rows and ``psum_scatter`` each
        member's chunk of them, then both sum in rank order, as
        ``RankGrid`` does, never through ``dist.all_reduce``: a reduction
        stays elementwise deterministic and bitwise the one-process grid's.

    A color group of ``Communicator.split`` that spans processes is a
    ``(1, G)`` grid of this class over the members' processes
    (:meth:`over`): there a process holds its members in the group's order,
    consecutive or not, and one that holds none raises on every collective.
    Point-to-point exchanges over the world group are all a group needs, so
    no ``dist.new_group`` is made.

    The process group is gloo (any other backend raises
    ``NotImplementedError``, see ``distributed.backend``). The payloads go
    through the grid's ``transport`` (``distributed/transport.py``) as
    contiguous byte views, so fp8 wire forms, unsigned and bool tensors
    pass bit for bit. A grid handed none takes ``transport.choose``'s, from
    what the process group shows:

      * ``ShmTransport`` when every process is on this card: each copies
        into slots it owns and the others read them in place, CUDA IPC
        device memory, so no payload touches host memory;
      * ``GlooTransport`` otherwise (processes on other hosts or cards, CPU
        ranks, one process): ``dist.batch_isend_irecv`` of host memory, so
        on the card every outgoing buffer is copied to the host and every
        incoming one back to the grid's device (the rows, the kernels and
        the results stay on the card).

    Either can be handed in as ``transport=`` (an instance on the grid's
    device type, else ``ValueError``): ``ShmTransport("cpu")`` runs the
    same protocol on CPU ranks over POSIX shared memory, and a
    ``ShmTransport`` whose processes are not all on one host (on the card:
    one card) raises ``ValueError`` when it is built. A color child
    (:meth:`over`) takes its parent's transport. With
    telemetry on, each exchange is one ``transport/<primitive>`` span
    tagged with the transport's name and its bytes; ``bytes_sent`` counts
    what this process has sent, ``host_bytes`` the payload bytes its
    transport moved through host memory (0 for ``"shm"`` on the card).
    """

    def __init__(self, n_nodes: int = 1, n_local: int = 1,
                 device: Union[str, torch.device] = "cuda",
                 transport: Optional[_transport.Transport] = None):
        super().__init__(n_nodes, n_local, device)
        be = _backend.current_backend()
        n = be.process_count
        r = self.world // n if self.world % n == 0 else 0
        if not r or self.n_local % r:
            raise ValueError(
                f"a ProcessGrid of {self.n_nodes}x{self.n_local} over {n} "
                f"processes: each process holds world / processes ranks of "
                f"one node, a count that must divide n_local={self.n_local}")
        self._place(tuple(f // r for f in range(self.world)),
                    be.process_index, transport)

    @classmethod
    def over(cls, owners: Sequence[int],
             device: Union[str, torch.device] = "cuda",
             transport: Optional[_transport.Transport] = None
             ) -> "ProcessGrid":
        """A ``(1, len(owners))`` grid whose member ``m`` lives in process
        ``owners[m]`` (a color group across processes); this process holds
        its members in member order, none if it owns none."""
        grid = cls.__new__(cls)
        RankGrid.__init__(grid, 1, len(owners), device)
        grid._place(tuple(int(o) for o in owners),
                    _backend.current_backend().process_index, transport)
        return grid

    def _place(self, owners: Tuple[int, ...], rank: int,
               transport: Optional[_transport.Transport]) -> None:
        if transport is None:
            transport = _transport.choose(self.device)
        elif not isinstance(transport, _transport.Transport):
            raise TypeError(f"transport={transport!r}: a Transport "
                            f"instance, or None for the grid's own choice")
        elif transport.device is not None and \
                transport.device.type != self.device.type:
            raise ValueError(
                f"a {transport.name} transport on {transport.device} under "
                f"a grid on {self.device}: it moves only "
                f"{transport.device.type} tensors")
        self.transport = transport
        self.owners, self.rank = owners, int(rank)
        by: Dict[int, List[int]] = {}
        for f, q in enumerate(owners):
            by.setdefault(q, []).append(f)
        self._held_by = {q: tuple(fs) for q, fs in by.items()}
        self.procs = tuple(sorted(by))
        self.held = self._held_by.get(self.rank, ())
        self.rows = len(self.held)
        self.offset = self.held[0] if self.held else 0
        self._contiguous = self.held == tuple(
            range(self.offset, self.offset + self.rows))
        self.bytes_sent = self.host_bytes = 0
        # (axes, pairs) -> (local map, {peer: send rows},
        #                   {peer: (recv pos, its first row if consecutive)})
        self._routes: Dict[tuple, tuple] = {}
        # axes -> (groups held, members held, processes, their members)
        self._layouts: Dict[tuple, tuple] = {}

    def __repr__(self) -> str:
        return (f"ProcessGrid({self.n_nodes}, {self.n_local}, {self.device}, "
                f"rank={self.rank}, held={list(self.held)}, "
                f"transport={self.transport.name!r})")

    def _key(self) -> tuple:
        return super()._key() + ("process", self.rank, self.owners,
                                 self.transport.name)

    @property
    def process_count(self) -> int:
        return len(self.procs)

    def _rows(self, x: torch.Tensor) -> None:
        if not self.rows:
            raise RuntimeError(
                f"process {self.rank} holds no rank of this grid (its ranks "
                f"live in processes {list(self.procs)}): it takes no part "
                f"in the group's collectives")
        super()._rows(x)

    def held_of(self, rows: torch.Tensor) -> torch.Tensor:
        if self._contiguous:
            return rows[self.offset:self.offset + self.rows]
        return rows[list(self.held)]

    def axis_index(self, axes: Axes) -> torch.Tensor:
        if self._contiguous:
            return super().axis_index(axes)
        ax = self._axes(axes)
        r = torch.tensor(self.held, dtype=torch.long, device=self.device)
        return {("local",): r % self.n_local, ("node",): r // self.n_local,
                ("node", "local"): r}[ax]

    # -- the layout of the groups --------------------------------------------

    def _members(self, f: int, ax: Tuple[str, ...]) -> List[int]:
        """The flat ranks of ``f``'s group along ``ax``, in member order."""
        node, local = divmod(f, self.n_local)
        if ax == ("local",):
            return [node * self.n_local + j for j in range(self.n_local)]
        if ax == ("node",):
            return [n * self.n_local + local for n in range(self.n_nodes)]
        return list(range(self.world))

    def crosses(self, axis: str) -> bool:
        """Whether ``axis``'s groups span more than one process (walked at
        the origin, as the reference's ``derive_link`` walks a mesh)."""
        return len({self.owners[f]
                    for f in self._members(0, self._axes(axis))}) > 1

    def _layout(self, ax: Tuple[str, ...]) -> tuple:
        """``(Gh, h, procs, pos)`` of ``ax``: the held rows are ``Gh``
        groups of ``h`` members each (row-major), ``procs`` the processes
        of those groups (each holds the same members of every one of them)
        and ``pos[q]`` the member indices process ``q`` holds, ascending."""
        hit = self._layouts.get(ax)
        if hit is None:
            members = self._members(self.held[0], ax)
            pos: Dict[int, List[int]] = {}
            for m, f in enumerate(members):
                pos.setdefault(self.owners[f], []).append(m)
            h = len(pos[self.rank])
            hit = self._layouts[ax] = (self.rows // h, h,
                                       sorted(pos, key=lambda q: pos[q][0]),
                                       pos)
        return hit

    def _in_process(self, ax: Tuple[str, ...]) -> bool:
        """The local axis of a node that is this one process: RankGrid's
        code on the held rows."""
        return ax == ("local",) and self.rows == self.n_local \
            and self._contiguous

    @staticmethod
    def _member_order(t: torch.Tensor, dim: int, procs, pos) -> torch.Tensor:
        """``t``, its ``dim`` concatenated over ``procs`` (each ``pos[q]``'s
        members), put in member order."""
        order = [m for q in procs for m in pos[q]]
        if order == sorted(order):
            return t
        inv = torch.tensor(sorted(range(len(order)), key=order.__getitem__),
                           device=t.device)
        return t.index_select(dim, inv)

    # -- the wire ------------------------------------------------------------

    def _exchange(self, what: str, sends: Dict[int, torch.Tensor],
                  recvs: Dict[int, torch.Tensor]) -> None:
        """One exchange of the transport: ``sends[j]``'s bytes to process
        ``j``, ``recvs[j]`` (contiguous bytes) filled from process ``j``."""
        self.bytes_sent += sum(t.numel() * t.element_size()
                               for t in sends.values())
        self.host_bytes += self.transport.exchange(what, sends, recvs)

    @staticmethod
    def _landing(nbytes: int, device) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, device=device)

    @staticmethod
    def _receive(buf: torch.Tensor, shape, dtype) -> torch.Tensor:
        """Received bytes as a ``shape``/``dtype`` tensor where they lie."""
        return buf.view(dtype).reshape(shape)

    def _gather_members(self, x: torch.Tensor, ax) -> torch.Tensor:
        """``(Gh, G, *s)``: every member's row of the held rows' groups
        along ``ax``, in member order."""
        Gh, h, procs, pos = self._layout(ax)
        rest = tuple(x.shape[1:])
        mine = x.reshape((Gh, h) + rest)
        if len(procs) == 1:
            return mine
        each = Gh * math.prod(rest) * x.element_size()
        peers = [q for q in procs if q != self.rank]
        got = {q: self._landing(each * len(pos[q]), self.device)
               for q in peers}
        self._exchange("all_gather", {q: mine for q in peers}, got)
        parts = [mine if q == self.rank else
                 self._receive(got[q], (Gh, len(pos[q])) + rest, x.dtype)
                 for q in procs]
        return self._member_order(torch.cat(parts, 1), 1, procs, pos)

    def all_rows(self, x: torch.Tensor, device=None) -> torch.Tensor:
        self._rows(x)
        device = self.device if device is None else device
        rest = tuple(x.shape[1:])
        if self.process_count == 1:
            return x.to(device)
        each = math.prod(rest) * x.element_size()
        peers = [q for q in self.procs if q != self.rank]
        got = {q: self._landing(each * len(self._held_by[q]), device)
               for q in peers}
        self._exchange("all_rows", {q: x for q in peers}, got)
        parts = [x.to(device) if q == self.rank else self._receive(
            got[q], (len(self._held_by[q]),) + rest, x.dtype)
            for q in self.procs]
        return self._member_order(torch.cat(parts), 0, self.procs,
                                  self._held_by)

    # -- the lax primitives across processes ----------------------------------

    @_collective("all-reduce")
    @_signed
    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        ax = self._axes(axes)
        if self._in_process(ax):
            return super().psum(x, axes)
        self._rows(x)
        s = self._sum_members(self._gather_members(x, ax))
        Gh, h = self._layout(ax)[:2]
        rest = tuple(s.shape[1:])
        return s.unsqueeze(1).expand((Gh, h) + rest).reshape(
            (self.rows,) + rest)

    @_collective("reduce-scatter")
    @_signed
    def psum_scatter(self, x: torch.Tensor, axes: Axes,
                     tiled: bool = True) -> torch.Tensor:
        ax = self._axes(axes)
        if self._in_process(ax):
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
        if self._in_process(ax):
            return super().all_gather(x, axes, tiled)
        self._rows(x)
        g = self._gather_members(x, ax)
        Gh, h = self._layout(ax)[:2]
        rest = tuple(g.shape[1:])
        out = g.unsqueeze(1).expand((Gh, h) + rest).reshape(
            (self.rows,) + rest)
        if tiled:
            out = out.reshape((self.rows, rest[0] * rest[1]) + rest[2:])
        return out

    def _exchange_slices(self, x: torch.Tensor, axes: Axes, split_axis: int,
                         concat_axis: int) -> torch.Tensor:
        ax = self._axes(axes)
        if self._in_process(ax):
            return super()._exchange_slices(x, axes, split_axis,
                                            concat_axis)
        Gh, h, procs, pos = self._layout(ax)
        # (groups, src members held, dst members, *rest)
        v = x.reshape((Gh, h) + tuple(x.shape[1:])).movedim(2 + split_axis,
                                                            2)

        def bound_for(q):  # the slices for process q's members
            p = pos[q]
            if p == list(range(p[0], p[0] + len(p))):
                return v.narrow(2, p[0], len(p))
            return v.index_select(2, torch.tensor(p, device=v.device))

        def shape_from(q):  # what q sends this process
            return (Gh, len(pos[q]), h) + tuple(v.shape[3:])
        peers = [q for q in procs if q != self.rank]
        got = {q: self._landing(math.prod(shape_from(q)) * x.element_size(),
                                self.device) for q in peers}
        self._exchange("all_to_all", {q: bound_for(q) for q in peers}, got)
        y = torch.cat([bound_for(q) if q == self.rank else
                       self._receive(got[q], shape_from(q), x.dtype)
                       for q in procs], dim=1)
        y = self._member_order(y, 1, procs, pos)  # (Gh, src, dst, ..)
        y = y.transpose(1, 2).movedim(2, 2 + concat_axis)  # (Gh, dst, ..)
        return y.reshape((self.rows,) + tuple(y.shape[2:]))

    def _route(self, axes: Axes, pairs) -> tuple:
        """``(local, sends, recvs)`` of one ppermute round, built once per
        ``(axes, pairs)`` on the grid's device: ``local`` ``(rows,)`` maps
        each held row to the held row it receives (-1 where its source is
        in another process or there is none); ``sends[j]`` lists the held
        rows process ``j`` receives, in the order of its rows; ``recvs[j]``
        the held rows that receive process ``j``'s buffer, in order, and
        the first of them where they are consecutive (else ``None``)."""
        key = self._round_key(axes, pairs)
        hit = self._routes.get(key)
        if hit is not None:
            return hit
        src = self._flat_src(key).tolist()
        own, me = self.owners, self.rank
        index = {f: i for i, f in enumerate(self.held)}

        def from_(q, f):  # f's source, if process q holds it
            return src[f] >= 0 and own[src[f]] == q
        local = [index[src[f]] if from_(me, f) else -1 for f in self.held]
        sends, recvs = {}, {}
        for j in self.procs:
            if j == me:
                continue
            pos = [i for i, f in enumerate(self.held) if from_(j, f)]
            idx = [index[src[f]] for f in self._held_by[j] if from_(me, f)]
            if pos:
                run = pos == list(range(pos[0], pos[0] + len(pos)))
                recvs[j] = (torch.tensor(pos, device=self.device),
                            pos[0] if run else None)
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
        # the received rows land in place as bytes, any dtype: straight
        # into consecutive rows, else through a buffer and index_copy_
        row_bytes = math.prod(x.shape[1:]) * x.element_size()
        flat = out.view(torch.uint8).reshape(self.rows, row_bytes)
        got = {j: flat[first:first + len(pos)].view(-1) if first is not None
               else self._landing(len(pos) * row_bytes, self.device)
               for j, (pos, first) in recvs.items()}
        self._exchange("ppermute", {j: staging.pack_blocks(x, idx)
                                    for j, idx in sends.items()}, got)
        for j, (pos, first) in recvs.items():
            if first is None:
                flat.index_copy_(0, pos, got[j].view(len(pos), -1))
        return out
