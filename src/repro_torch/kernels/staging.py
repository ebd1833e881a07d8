"""The staging kernels of the collectives: the row moves under every
``RankGrid`` round (port of ``repro.kernels.ops.shift_blocks`` and
``pack_blocks``, whose Pallas kernels are ``repro/kernels/staging.py``).

  * :func:`shift_blocks` is the paper's step 6, the per-rank roll of the
    block-major gather buffer into rank order (``RankGrid.roll``);
  * :func:`pack_blocks` is the multi-object send staging, a row gather:
    the flat form is a ``ppermute`` round over the grid's ranks (a PiP rank
    copying out of its peer's buffer), the per-rank form the per-rank row
    takes (``RankGrid.take``, ``dynamic_slice``).

Both dispatch on their operand's device: CUDA tensors launch the
hand-written kernels in ``csrc/staging.cu`` (built on first use by
``kernels/_build.py``); CPU tensors run the plain versions in
``kernels/ref.py``. Any other device, operands on several devices, a
shape the kernels do not take, a failed build or a refused launch raises —
nothing falls back. The kernels move bytes, so every dtype goes through
bit for bit. A source whose rows are strided (a slice such as
``V[:, :send_cnt]``) is gathered where it lies; only a source whose rows
are not themselves contiguous is made contiguous first. The shift and the
index stay on the card: a call reads nothing back to the host. The result
is a fresh tensor; a zero-size one returns at once, with no launch.

``launches`` counts kernel launches per kernel (the CPU path counts
nothing), so a run can show that its collectives went through the
kernels. Under the work counter a call counts its wrapper's cost
(:func:`shift_cost`, :func:`pack_cost`) once (``_dispatch.kernel_call``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._dispatch import (Cost, kernel_call, nbytes,
                                           on_card, raise_on, stream)

#: launches of each CUDA kernel
launches: Dict[str, int] = {"shift_blocks": 0, "pack_blocks": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _rows(src: torch.Tensor, lead: int) -> Tuple[torch.Tensor, int, int,
                                                 int]:
    """``(src, row bytes, rank stride, row stride)``: the byte layout of
    ``src``'s rows, each row its dims past ``lead`` (contiguous, or made
    so). ``lead`` is 1 (flat rows) or 2 (per-rank rows)."""
    inner = tuple(src.shape[lead:])
    want, step = [], 1
    for n in reversed(inner):
        want.append(step)
        step *= n
    got = tuple(st for st, n in zip(src.stride()[lead:], inner) if n != 1)
    if got != tuple(st for st, n in zip(reversed(want), inner) if n != 1):
        src = src.contiguous()
    size = src.element_size()
    row_bytes = step * size
    rank_stride = src.stride(0) * size if lead == 2 else 0
    return src, row_bytes, rank_stride, src.stride(lead - 1) * size


def _index(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
        raise TypeError(f"{what}: expected an integer tensor, got {t.dtype}")
    return t.to(torch.long).contiguous()


def shift_cost(v: torch.Tensor, shift: torch.Tensor) -> Cost:
    """Every row of ``v`` read once and written once, and the int64
    shifts; no arithmetic."""
    return Cost(2 * nbytes(v) + 8 * shift.numel(), 0)


def pack_cost(src: torch.Tensor, idx: torch.Tensor) -> Cost:
    """Every output row read once and written once, and the int64
    indices; no arithmetic."""
    row = math.prod(src.shape[idx.dim():])
    return Cost(2 * idx.numel() * row * src.element_size()
                + 8 * idx.numel(), 0)


def shift_blocks(v: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-rank roll: ``v`` ``(R, K, ...)``, ``shift`` ``(R,)`` integers on
    ``v``'s device; row ``k`` of rank ``r`` of the result is ``v[r, (k -
    shift[r]) mod K]``."""
    if v.dim() < 2 or tuple(shift.shape) != (v.shape[0],):
        raise ValueError(f"shift_blocks takes v (R, K, ...) and shift (R,); "
                         f"got {tuple(v.shape)}, {tuple(shift.shape)}")
    with kernel_call("shift_blocks", lambda: shift_cost(v, shift), v,
                     shift) as meta:
        if meta:
            return torch.empty(v.shape, dtype=v.dtype, device="meta")
        return _shift(v, shift)


def _shift(v: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU operands, else the kernel's launch."""
    if not on_card(v, shift):
        return ref.shift_blocks(v, shift)
    shift = _index(shift, "shift")
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    R, K = v.shape[0], v.shape[1]
    src, row_bytes, rank_stride, row_stride = _rows(v, 2)
    rc = _build.load("staging").staging_shift_blocks(
        src.data_ptr(), out.data_ptr(), shift.data_ptr(), R, K, row_bytes,
        rank_stride, row_stride, stream(out))
    raise_on(rc, "staging", "shift_blocks")
    launches["shift_blocks"] += 1
    return out


def pack_blocks(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather, a zero row where an index lies outside ``[0, N)``:

      * flat, ``idx`` ``(K,)``: ``src`` ``(N, ...)`` -> ``(K, ...)``,
        ``out[j] = src[idx[j]]``;
      * per rank, ``idx`` ``(R, J)``: ``src`` ``(R, N, ...)`` -> ``(R, J,
        ...)``, ``out[r, j] = src[r, idx[r, j]]``.

    ``idx`` holds integers on ``src``'s device."""
    if idx.dim() not in (1, 2) or src.dim() < idx.dim() or (
            idx.dim() == 2 and src.shape[0] != idx.shape[0]):
        raise ValueError(f"pack_blocks takes src (N, ...) with idx (K,), or "
                         f"src (R, N, ...) with idx (R, J); got "
                         f"{tuple(src.shape)}, {tuple(idx.shape)}")
    with kernel_call("pack_blocks", lambda: pack_cost(src, idx), src,
                     idx) as meta:
        if meta:
            return torch.empty(tuple(idx.shape)
                               + tuple(src.shape[idx.dim():]),
                               dtype=src.dtype, device="meta")
        return _pack(src, idx)


def _pack(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU operands, else the kernel's launch."""
    if not on_card(src, idx):
        return ref.pack_blocks(src, idx)
    idx = _index(idx, "idx")
    lead = idx.dim()
    out = torch.empty(tuple(idx.shape) + tuple(src.shape[lead:]),
                      dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    R, J = (1, idx.shape[0]) if lead == 1 else tuple(idx.shape)
    src, row_bytes, rank_stride, row_stride = _rows(src, lead)
    rc = _build.load("staging").staging_pack_blocks(
        src.data_ptr(), out.data_ptr(), idx.data_ptr(), R, J,
        src.shape[lead - 1], row_bytes, rank_stride, row_stride, stream(out))
    raise_on(rc, "staging", "pack_blocks")
    launches["pack_blocks"] += 1
    return out
