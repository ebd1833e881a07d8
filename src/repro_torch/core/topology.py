"""Two-level topology descriptor for multi-object collectives.

The paper's world is (nodes x processes-per-node). The port keeps the
reference's :class:`Topology` unchanged: it names the two rank-grid axes
the collective algorithms operate over, their sizes, and per-level link
metadata (a :class:`repro_torch.core.costmodel.NetParams` preset name or
instance) that the selector composes via ``costmodel.net_for(topo)``.

Links come from :func:`derive_link` on a grid. A :class:`repro_torch.core
.grid.RankGrid`'s ranks are rows of tensors in one process, so no axis
crosses a process boundary: on the CPU both levels are ``host_cpu``; on
CUDA both are ``h100_grid``, the preset fitted from calibration on an H100
(``costmodel.h100_grid``), as the reference maps its TPU onto its
``tpu_v5e_ici`` preset. On a :class:`~repro_torch.core.grid.ProcessGrid`
of several processes the node axis crosses the process boundary and is
``host_ipc``, the reference's link between host processes; its local axis
keeps the in-process link. Any other platform warns once and borrows the
``host_cpu`` constants, as the reference does for an unknown platform.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Set, Tuple

#: platforms already warned about in :func:`derive_link` fallback (warn once
#: per platform per process)
_FALLBACK_WARNED: Set[str] = set()


def _warn_fallback(platform: str, link: str) -> None:
    if platform in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(platform)
    warnings.warn(
        f"derive_link: no measured NetParams preset for platform "
        f"{platform!r}; falling back to {link!r} constants — calibration "
        f"rows keyed on this link class are folklore until a preset is "
        f"added to costmodel.NET_PRESETS", RuntimeWarning, stacklevel=3)


def derive_link(grid, axis: str, level: str) -> str:
    """Link-class name for one rank-grid axis.

    The reference classifies an axis by the process boundaries it crosses,
    then maps the platform onto a preset. Process boundaries classify
    first: the node axis of a grid over more than one process
    (``grid.process_count``, a ``ProcessGrid``'s) crosses them and is
    ``"host_ipc"`` on any platform (gloo between host processes). Every
    other axis is an in-process link:

      * cpu: ``"host_cpu"``;
      * cuda: ``"h100_grid"`` (ranks as rows of one card's memory);
      * anything else: ``"host_cpu"`` with a once-per-platform warning, so
        calibration tables record which rows rest on folklore constants.
    """
    del level  # the process boundary distinguishes levels, not the caller
    if axis == "node" and getattr(grid, "process_count", 1) > 1:
        return "host_ipc"
    platform = grid.device.type
    if platform == "cuda":
        return "h100_grid"
    if platform != "cpu":
        _warn_fallback(platform, "host_cpu")
    return "host_cpu"


@dataclasses.dataclass(frozen=True)
class Topology:
    """A two-level (inter, intra) communication topology.

    Attributes:
      n_nodes: number of groups along the inter ("node") axis.
      n_local: number of ranks per group along the intra ("local") axis.
      node_axis: grid axis name for the inter-group dimension.
      local_axis: grid axis name for the intra-group dimension.
      node_link: link metadata for the inter level — a NetParams preset name
        or a NetParams instance (None = selector default).
      local_link: link metadata for the intra level, same conventions.
      group: group tag for sub-communicator topologies (empty for the root);
        it namespaces tuning-table keys.
    """

    n_nodes: int
    n_local: int
    node_axis: str = "node"
    local_axis: str = "local"
    node_link: Optional[object] = None
    local_link: Optional[object] = None
    group: str = ""

    def __post_init__(self):
        if self.n_nodes < 1 or self.n_local < 1:
            raise ValueError(f"invalid topology {self.n_nodes}x{self.n_local}")

    @property
    def world(self) -> int:
        return self.n_nodes * self.n_local

    @property
    def axes(self) -> Tuple[str, str]:
        return (self.node_axis, self.local_axis)

    @property
    def active_axes(self) -> Tuple[str, ...]:
        """Grid axes this topology actually communicates over (size > 1).

        A fully degenerate 1x1 topology still names ``(local_axis,)``; a
        single-axis topology names the same axis at both levels, so the
        dict dedupes it."""
        sizes = {self.node_axis: self.n_nodes, self.local_axis: self.n_local}
        active = tuple({a: None for a in self.axes if sizes[a] > 1})
        return active or (self.local_axis,)

    @property
    def link_names(self) -> Tuple[str, str]:
        """(inter, intra) link names — stable key material for tuning tables."""
        def name(link, default):
            if link is None:
                return default
            return getattr(link, "name", None) or str(link)
        return (name(self.node_link, "default"),
                name(self.local_link, "default"))

    def with_links(self, node_link=None, local_link=None) -> "Topology":
        """Copy with link metadata filled in (None leaves a field as is)."""
        return dataclasses.replace(
            self,
            node_link=node_link if node_link is not None else self.node_link,
            local_link=(local_link if local_link is not None
                        else self.local_link))

    def flat(self, node: int, local: int) -> int:
        """Flat rank under row-major (node, local) ordering."""
        return node * self.n_local + local

    @classmethod
    def subset(cls, grid, axes, parent: Optional["Topology"] = None,
               group: Optional[str] = None) -> "Topology":
        """Derive a sub-communicator Topology from one or two grid axes.

        One axis -> a flat ``1 x size`` intra-only topology over that axis;
        two axes -> a full two-level topology. Links are inherited from
        ``parent`` where the axis matches one of its levels, else derived
        from the grid. ``group`` overrides the tag (default: the joined
        axis names)."""
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        if not 1 <= len(axes) <= 2:
            raise ValueError(f"subset takes 1 or 2 grid axes, got {axes!r}")
        for a in axes:
            if a not in grid.shape:
                raise ValueError(f"axis {a!r} not in grid axes "
                                 f"{tuple(grid.axis_names)}")

        def link_for(axis, level):
            if parent is not None:
                if axis == parent.node_axis and parent.node_link is not None:
                    return parent.node_link
                if axis == parent.local_axis and parent.local_link is not None:
                    return parent.local_link
            return derive_link(grid, axis, level)

        tag = group if group is not None else "x".join(axes)
        if len(axes) == 1:
            (ax,) = axes
            return cls(1, grid.shape[ax], node_axis=ax, local_axis=ax,
                       node_link=link_for(ax, "intra"),
                       local_link=link_for(ax, "intra"), group=tag)
        node_ax, local_ax = axes
        if node_ax == local_ax:
            raise ValueError(f"duplicate axis {node_ax!r} in subset axes")
        return cls(grid.shape[node_ax], grid.shape[local_ax],
                   node_axis=node_ax, local_axis=local_ax,
                   node_link=link_for(node_ax, "inter"),
                   local_link=link_for(local_ax, "intra"), group=tag)

    @classmethod
    def from_grid(cls, grid, node_link: Optional[object] = None,
                  local_link: Optional[object] = None) -> "Topology":
        """The root Topology of a ``RankGrid``, links derived when not
        passed (the counterpart of the reference's ``from_mesh``)."""
        node_ax, local_ax = grid.axis_names
        if node_link is None:
            node_link = derive_link(grid, node_ax, level="inter")
        if local_link is None:
            local_link = derive_link(grid, local_ax, level="intra")
        return cls(n_nodes=grid.shape[node_ax], n_local=grid.shape[local_ax],
                   node_axis=node_ax, local_axis=local_ax,
                   node_link=node_link, local_link=local_link)
