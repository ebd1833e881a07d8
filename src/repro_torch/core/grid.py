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

Sums run in rank order (``((x0 + x1) + x2) + ...``), the same order for
every element and every payload length, so a reduction is elementwise
deterministic: splitting a payload into buckets never changes a bit.

The algorithms in ``core.mcoll`` are written once against these
primitives; a ``torch.distributed`` transport with the same interface is
a later slice.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple, Union

import torch

from repro_torch.kernels import staging

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
    """

    axis_names: Tuple[str, str] = ("node", "local")

    def __init__(self, n_nodes: int = 1, n_local: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        if int(n_nodes) < 1 or int(n_local) < 1:
            raise ValueError(f"invalid rank grid {n_nodes}x{n_local}")
        self.n_nodes = int(n_nodes)
        self.n_local = int(n_local)
        self.device = resolve_device(device)
        # (axes, pairs) -> (world,) flat source map of a ppermute round
        self._src_maps: Dict[tuple, torch.Tensor] = {}

    def __repr__(self) -> str:
        return f"RankGrid({self.n_nodes}, {self.n_local}, {self.device})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, RankGrid)
                and (self.n_nodes, self.n_local, self.device)
                == (other.n_nodes, other.n_local, other.device))

    def __hash__(self) -> int:
        return hash((self.n_nodes, self.n_local, self.device))

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

    def _groups(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``(world, *s)`` -> ``(n_groups, group_size, *s)``: ranks that
        differ only along ``axes`` share a group, members in row-major
        order over ``axes``."""
        if x.shape[0] != self.world:
            raise ValueError(f"operand dim0 {x.shape[0]} != grid world "
                             f"{self.world}")
        ax = self._axes(axes)
        rest = tuple(x.shape[1:])
        if ax == ("node", "local"):
            return x.reshape((1, self.world) + rest)
        g = x.reshape((self.n_nodes, self.n_local) + rest)
        return g if ax == ("local",) else g.transpose(0, 1)

    def _ungroup(self, g: torch.Tensor, axes: Axes) -> torch.Tensor:
        ax = self._axes(axes)
        rest = tuple(g.shape[2:])
        if ax == ("node",):
            g = g.transpose(0, 1)
        return g.reshape((self.world,) + rest)

    def _sum_members(self, g: torch.Tensor) -> torch.Tensor:
        """Rank-ordered sum over dim 1 of a group view."""
        acc = g[:, 0].clone()
        for m in range(1, g.shape[1]):
            acc += g[:, m]
        return acc

    # -- the lax primitives -------------------------------------------------

    def axis_index(self, axes: Axes) -> torch.Tensor:
        """Each rank's index within its group along ``axes`` (``(world,)``
        int64 on the grid's device) — ``lax.axis_index`` for every rank."""
        ax = self._axes(axes)
        r = torch.arange(self.world, device=self.device)
        if ax == ("local",):
            return r % self.n_local
        if ax == ("node",):
            return r // self.n_local
        return r

    @_signed
    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Every rank gets the sum of its group's rows."""
        g = self._groups(x, axes)
        s = self._sum_members(g)
        return self._ungroup(s.unsqueeze(1).expand_as(g), axes)

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

    def all_to_all(self, x: torch.Tensor, axes: Axes, split_axis: int,
                   concat_axis: int, tiled: bool = False) -> torch.Tensor:
        """``lax.all_to_all``. Untiled: each rank's ``split_axis`` (size G)
        is split into G slices, slice j goes to member j, and the received
        slices stack along a new ``concat_axis`` in source order. Tiled
        (``split_axis == concat_axis`` only): the axis is cut into G equal
        chunks, chunk j goes to member j, and the received chunks are
        concatenated along the same axis in source order."""
        g = self._groups(x, axes)
        G = g.shape[1]
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
        y = g.movedim(2 + split_axis, 2).transpose(1, 2)  # (Go, dst, src, ..)
        return self._ungroup(y.movedim(2, 2 + concat_axis), axes)

    def _src_map(self, axes: Axes, pairs) -> torch.Tensor:
        """The ``(world,)`` flat source map of one ppermute round: entry
        ``d`` is the flat rank whose row rank ``d`` receives, -1 where no
        member sends. Built once per ``(axes, pairs)``, kept on the grid's
        device."""
        ax = self._axes(axes)
        pairs = tuple((int(s), int(d)) for s, d in pairs)
        key = (ax, pairs)
        hit = self._src_maps.get(key)
        if hit is not None:
            return hit
        # members[g, m]: flat rank of member m of group g
        flat = torch.arange(self.world).reshape(self.n_nodes, self.n_local)
        members = {("node", "local"): flat.reshape(1, self.world),
                   ("local",): flat, ("node",): flat.t()}[ax]
        src = torch.full((self.world,), -1, dtype=torch.long)
        for s, d in pairs:
            src[members[:, d]] = members[:, s]
        hit = self._src_maps[key] = src.to(self.device)
        return hit

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
        if x.shape[0] != self.world:
            raise ValueError(f"operand dim0 {x.shape[0]} != grid world "
                             f"{self.world}")

    def take(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``jnp.take(x_r, idx_r, axis=0)`` for every rank ``r``: ``idx``
        ``(world,)`` takes one row per rank (the row dim is consumed);
        ``(world, J)`` takes J rows per rank (``pack_blocks``). Every index
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
        c = cond.to(a.device).reshape((self.world,)
                                      + (1,) * (max(a.dim(), b.dim()) - 1))
        return torch.where(c, a, b)
