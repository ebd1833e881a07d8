"""Logical-axis sharding rules (port of ``repro.sharding.rules``' ``Rules``
alone): the names of the grid axes each parallelism runs over.

  batch  -> the axes the global batch is split over
  fsdp   -> the axes the weights' big dim is split over (ZeRO-3)
  tp     -> the one axis heads, experts and vocab are split over
  seq    -> the axis the sequence is split over (long-KV decode)

The reference also maps logical array axes to partition specs through
these names (``spec_for``, ``constrain``); on a rank grid held by one
device those change no value, and they come with the sharded train step
(ROADMAP.md, queue 1 item 8). Here the rules only name the axes: the
expert-parallel MoE (``layers/moe.py``) splits its batch over ``batch``
and its experts over ``tp``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Set, Tuple


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
