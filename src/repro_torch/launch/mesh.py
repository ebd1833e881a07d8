"""Rank grids of the launched runs and the default sharding rules per run
shape (port of ``repro.launch.mesh``).

The reference's production target is a TPU v5e pod (16 x 16 chips, a
second pod across DCN). Its H100 counterpart: nodes of 8 GPUs joined by
NVLink form the ``local`` axis, which takes tensor parallelism; nodes
joined by the network form the ``node`` axis, which takes data
parallelism and FSDP. ``make_production_grid()`` is 32 such nodes (256
GPUs) and ``multi_pod=True`` 64 (512), the reference's 256 and 512 chips.
The reference's axes map as {``pod``, ``data``} -> ``node`` and ``model``
-> ``local``. Constructing a grid allocates nothing.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.core.grid import ProcessGrid, RankGrid
from repro_torch.distributed import backend as _backend
from repro_torch.sharding.rules import Rules

#: GPUs a node holds over NVLink (the ``local`` axis)
GPUS_PER_NODE = 8

#: one card's memory: NVIDIA H100 80GB HBM3 (700 W power limit)
HBM_BYTES = 80e9


def make_production_grid(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda"
                         ) -> RankGrid:
    """``RankGrid(32, 8)`` (256 GPUs), or ``RankGrid(64, 8)`` (512) with
    ``multi_pod``."""
    return RankGrid(64 if multi_pod else 32, GPUS_PER_NODE, device)


def make_mesh(shape: Sequence[int], axes: Sequence[str] = RankGrid.axis_names,
              device: Union[str, torch.device] = "cuda") -> RankGrid:
    """A :class:`RankGrid` of ``shape`` over ``axes``: ``("node",
    "local")`` for two dims; one dim names either axis (the other is 1)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or not axes or \
            axes != tuple(a for a in RankGrid.axis_names if a in axes):
        raise ValueError(f"a rank grid of {shape} over {axes}: its axes "
                         f"are {RankGrid.axis_names}, in that order")
    sizes = dict(zip(axes, shape))
    return RankGrid(sizes.get("node", 1), sizes.get("local", 1), device)


def make_process_grid(device: Union[str, torch.device] = "cuda"
                      ) -> ProcessGrid:
    """The ``(process_count, ranks_per_process)`` :class:`ProcessGrid` of
    the initialized backend, whose node axis is exactly the process
    boundary: process ``p`` holds flat ranks ``p * ranks_per_process`` on.
    ``ranks_per_process`` is the launcher's (``--ranks-per-process``; 1
    when not launched). Its ranks live on ``device``, the card unless the
    caller passes ``"cpu"``. Its payloads across processes go through the
    transport the grid chooses (``distributed/transport.py``): the shared
    slots of ``"shm"`` when every process is on this card, where
    ``derive_link`` classifies the node axis ``h100_ipc``, else gloo,
    ``host_ipc``; the local axis takes the grid's in-process link."""
    return ProcessGrid(_backend.process_count(),
                       _backend.ranks_per_process(), device)


def default_rules(grid, kind: str, global_batch: int, seq_len: int,
                  param_bytes: float = 0.0) -> Rules:
    """The parallelism layout for a run shape (the reference's decisions).

    train/prefill: batch and FSDP over ``node``, TP over ``local``.
    decode: the weights stay TP-resident (no ZeRO-3: gathering them every
    token is the latency the reference's sweep exposed) whenever a TP
    shard fits in 0.75 of a card's memory; batch over ``node``; a batch
    smaller than the node axis switches to context parallelism, the KV
    sequence over ``node``. ``seq_len`` is not read, as in the reference.
    The reference's separate pod axis has no counterpart: its single-pod
    choice stands."""
    shape = dict(getattr(grid, "grid", grid).shape)
    dp_size, tp_size = shape["node"], shape["local"]
    if kind == "decode":
        fsdp = () if (param_bytes and
                      param_bytes / tp_size < 0.75 * HBM_BYTES) else ("node",)
        if global_batch < dp_size:
            return Rules(batch=(), fsdp=fsdp, tp="local", seq="node")
        return Rules(batch=("node",), fsdp=fsdp, tp="local", seq=None)
    return Rules(batch=("node",), fsdp=("node",), tp="local", seq=None)
