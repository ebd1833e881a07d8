"""Logical-axis sharding rules (port of ``repro.sharding.rules``): map the
named logical axes of an array to grid axes, replicating a dim that an
axis does not divide.

  batch  -> the axes the global batch is split over
  fsdp   -> the axes the weights' big dim is split over (ZeRO-3)
  tp     -> the one axis heads, experts and vocab are split over
  seq    -> the axis the sequence is split over (long-KV decode)

A spec is a plain tuple with one entry per dim: ``None`` (replicated), a
grid axis name, or a tuple of axis names; it equals ``tuple()`` of the
reference's ``PartitionSpec`` entry for entry. On a rank grid held by one
device a sharding constraint changes no value, so :func:`constrain` checks
its spec and returns the array; the launch layer (``launch/specs.py``)
reads the specs of every leaf. The expert-parallel MoE (``layers/moe.py``)
splits its batch over ``batch`` and its experts over ``tp``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Set, Tuple, Union

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
Logical = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    batch: Tuple[str, ...] = ()
    fsdp: Tuple[str, ...] = ()
    tp: Optional[str] = None
    seq: Optional[str] = None

    def mesh_axes(self) -> Set[str]:
        """Every grid axis the rules name."""
        out = set(self.batch) | set(self.fsdp)
        if self.tp:
            out.add(self.tp)
        if self.seq:
            out.add(self.seq)
        return out


# logical axis vocabulary
TP_AXES = {"heads", "kv_heads", "ff", "vocab", "experts", "inner"}
BATCH_AXES = {"batch"}
SEQ_AXES = {"seq"}
FSDP_AXES = {"fsdp"}  # the designated big dim of each weight


def grid_shape(grid) -> Dict[str, int]:
    """``{axis: size}`` of a rank grid (or of a ``Communicator``'s)."""
    grid = getattr(grid, "grid", grid)
    return dict(grid.shape)


def _prod(axes: Tuple[str, ...], shape: Mapping[str, int]) -> int:
    n = 1
    for a in axes:
        n *= shape.get(a, 1)
    return n


def spec_for(logical: Logical, dims: Tuple[int, ...], rules: Rules,
             shape: Mapping[str, int]) -> Spec:
    """The spec of one array of ``dims`` whose axes are named ``logical``
    on a grid of axis sizes ``shape``. A logical axis whose grid axes do
    not divide its dim is replicated instead."""
    if len(logical) != len(dims):
        raise ValueError(f"logical axes {logical} for dims {tuple(dims)}")
    parts = []
    for name, d in zip(logical, dims):
        if name is None:
            parts.append(None)
        elif name in BATCH_AXES or name in FSDP_AXES:
            names = rules.batch if name in BATCH_AXES else rules.fsdp
            ax = tuple(a for a in names if shape.get(a, 1) > 1)
            parts.append(ax if ax and d % _prod(ax, shape) == 0 else None)
        elif name in TP_AXES or name in SEQ_AXES:
            ax = rules.tp if name in TP_AXES else rules.seq
            ok = ax and shape.get(ax, 1) > 1 and d % shape[ax] == 0
            parts.append(ax if ok else None)
        else:
            raise ValueError(f"unknown logical axis {name}")
    return canonical(parts)


def canonical(parts) -> Spec:
    """Spec entries in ``PartitionSpec``'s canonical form: an empty tuple
    is replicated, a singleton tuple its bare axis name (the same
    sharding)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else
                 (None if p == () else p) for p in parts)


def constrain(x, logical: Logical, rules: Optional[Rules], grid):
    """``x`` unchanged: on a grid held by one device (or without a grid or
    rules) a sharding constraint moves nothing. With both, the spec is
    built, so a logical tuple that does not fit ``x`` raises as the
    reference's does."""
    if grid is not None and rules is not None:
        spec_for(logical, tuple(x.shape), rules, grid_shape(grid))
    return x


def is_logical(t) -> bool:
    """A logical tuple: a tuple of axis names and Nones (a tree's leaf)."""
    return isinstance(t, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in t)


def tree_specs(logical_tree, shape_tree, rules: Rules, grid):
    """Map a tree of logical tuples and the matching tree of shapes (dicts
    and lists, leaves a shape tuple or anything with ``.shape``) to a tree
    of specs."""
    shape = grid_shape(grid)

    def walk(lg, sh):
        if is_logical(lg):
            return spec_for(lg, tuple(getattr(sh, "shape", sh)), rules,
                            shape)
        if isinstance(lg, dict):
            if set(lg) != set(sh):
                raise ValueError(f"logical keys {sorted(lg)} != "
                                 f"{sorted(sh)}")
            return {k: walk(lg[k], sh[k]) for k in lg}
        if len(lg) != len(sh):
            raise ValueError("logical and shape trees differ in length")
        return type(lg)(walk(a, b) for a, b in zip(lg, sh))
    return walk(logical_tree, shape_tree)
