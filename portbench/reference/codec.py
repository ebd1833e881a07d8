"""Plain block codecs and the two-level compressed allreduce with error
feedback, in float32 PyTorch, rank by rank.

The int8 block codec: 256-element blocks of a slice (the last one padded
with zeros), one float32 scale a block, ``amax * f32(1/127)``, and
``q = clip(round_half_even(c / max(scale, 1e-12)), -127, 127)``; decoding
is ``q * scale``. int4 is the same with 7 for 127: it is the control, the
next precision down.

The allreduce over ``n_nodes x n_local`` ranks (rank ``r`` is node
``r // n_local``, local index ``r % n_local``), each rank's carried error
added to its input first:

  1. within a node, local index ``j`` sums slice ``j`` of every local
     peer's row (lossless);
  2. that slice splits into ``n_nodes`` sub-slices, each encoded;
  3. node ``w`` decodes and sums sub-slice ``w`` of its peers across
     nodes, and encodes the sum again;
  4. every rank decodes every node's re-encoded sub-slice and the local
     slices are put back together.

A rank's new error is the residual of both its encodes at the positions
it encoded (zero elsewhere). Imports nothing of the program.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BLOCK = 256
QMAX = {"int8": 127, "int4": 7}
_TINY = float(np.float32(1e-12))


def _recip(qmax: int) -> float:
    return float(np.float32(1.0 / qmax))


def encode(c: torch.Tensor, codec: str = "int8"
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``c`` (S, L) float32 -> (q (S, nb, 256) float32 integers, scale
    (S, nb), residual ``c - q*scale`` (S, L))."""
    qmax = QMAX[codec]
    S, L = c.shape
    nb = -(-L // BLOCK)
    blocks = torch.nn.functional.pad(c.float(), (0, nb * BLOCK - L)) \
        .reshape(S, nb, BLOCK)
    scale = blocks.abs().amax(dim=2) * _recip(qmax)
    q = torch.clamp(torch.round(blocks / torch.clamp_min(
        scale, _TINY)[..., None]), -qmax, qmax)
    res = (blocks.double() - q.double() * scale.double()[..., None]).float()
    return q, scale, res.reshape(S, nb * BLOCK)[:, :L]


def decode(q: torch.Tensor, scale: torch.Tensor, length: int
           ) -> torch.Tensor:
    """(S, nb, 256) integers and (S, nb) scales -> (S, length) float32."""
    return (q * scale[..., None]).reshape(q.shape[0], -1)[:, :length]


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def allreduce(x: torch.Tensor, err: torch.Tensor, n_nodes: int,
              n_local: int, codec: str = "int8"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x``, ``err``: (world, L) float32, row ``r`` rank ``r``'s. Returns
    (the sum every rank receives (world, L), the new error (world, L))."""
    world, L = x.shape
    if world != n_nodes * n_local:
        raise ValueError(f"{world} rows on a {n_nodes}x{n_local} grid")
    g = x.float() + err.float()
    Lp = -(-L // n_local)
    Ls = -(-Lp // n_nodes)
    g = _pad(g, n_local * Lp).reshape(n_nodes, n_local, n_local, Lp)
    # 1. rank (n, j) holds the sum over its node's rows of slice j
    s = g.double().sum(dim=1).float()               # (n, j, Lp)
    subs = _pad(s, n_nodes * Ls).reshape(n_nodes, n_local, n_nodes, Ls)
    # 2. each rank encodes its n_nodes sub-slices
    q1, sc1, r1 = encode(subs.reshape(-1, Ls), codec)
    dec1 = decode(q1, sc1, Ls).reshape(n_nodes, n_local, n_nodes, Ls)
    r1 = r1.reshape(n_nodes, n_local, n_nodes, Ls)
    # 3. rank (w, j) sums sub-slice w over the nodes and encodes the sum
    mine = dec1.permute(2, 1, 0, 3).double().sum(dim=2).float()  # (w, j, Ls)
    q2, sc2, r2 = encode(mine.reshape(-1, Ls), codec)
    red = decode(q2, sc2, Ls).reshape(n_nodes, n_local, Ls)
    r2 = r2.reshape(n_nodes, n_local, Ls)
    # 4. every rank: local slice j is the nodes' sub-slices in order
    slice_j = red.permute(1, 0, 2).reshape(n_local, n_nodes * Ls)[:, :Lp]
    out = slice_j.reshape(n_local * Lp)[:L].expand(world, L).clone()
    res = r1.clone()
    for w in range(n_nodes):
        res[w, :, w] += r2[w]
    res = res.reshape(n_nodes, n_local, n_nodes * Ls)[..., :Lp]
    new_err = torch.zeros((n_nodes, n_local, n_local, Lp),
                          dtype=torch.float32, device=x.device)
    for j in range(n_local):
        new_err[:, j, j] = res[:, j]
    return out, new_err.reshape(world, n_local * Lp)[:, :L]
