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

Axes = Union[str, Sequence[str]]


class RankGrid:
    """``n_nodes x n_local`` ranks, each a row of every operand.

    ``device`` defaults to ``"cuda"``: a grid places its ranks on the card
    unless the caller asks for the CPU. Constructing a grid allocates
    nothing; operands and results live on ``device``.
    """

    axis_names: Tuple[str, str] = ("node", "local")

    def __init__(self, n_nodes: int = 1, n_local: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        if int(n_nodes) < 1 or int(n_local) < 1:
            raise ValueError(f"invalid rank grid {n_nodes}x{n_local}")
        self.n_nodes = int(n_nodes)
        self.n_local = int(n_local)
        self.device = torch.device(device)

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

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Every rank gets the sum of its group's rows."""
        g = self._groups(x, axes)
        s = self._sum_members(g)
        return self._ungroup(s.unsqueeze(1).expand_as(g), axes)

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
                   concat_axis: int) -> torch.Tensor:
        """Untiled ``lax.all_to_all``: each rank's ``split_axis`` (size G)
        is split into G slices, slice j goes to member j, and the received
        slices stack along a new ``concat_axis`` in source order."""
        g = self._groups(x, axes)
        G = g.shape[1]
        if x.shape[1 + split_axis] != G:
            raise ValueError(f"all_to_all split dim {x.shape[1 + split_axis]}"
                             f" != group size {G}")
        y = g.movedim(2 + split_axis, 2).transpose(1, 2)  # (Go, dst, src, ..)
        return self._ungroup(y.movedim(2, 2 + concat_axis), axes)

    def ppermute(self, x: torch.Tensor, axes: Axes,
                 pairs: Iterable[Tuple[int, int]]) -> torch.Tensor:
        """Static permutation within each group: member ``dst`` receives
        member ``src``'s row for every ``(src, dst)`` pair; members with no
        sender get zeros. One index gather over rows."""
        g = self._groups(x, axes)
        G = g.shape[1]
        src_of = [-1] * G
        for s, d in pairs:
            src_of[int(d)] = int(s)
        if all(s >= 0 for s in src_of):
            idx = torch.tensor(src_of, device=g.device)
            return self._ungroup(g.index_select(1, idx), axes)
        out = torch.zeros_like(g)
        dst = [d for d in range(G) if src_of[d] >= 0]
        src = [src_of[d] for d in dst]
        out[:, dst] = g[:, src]
        return self._ungroup(out, axes)
