"""The WKV6 recurrence kernel of the rwkv layers (port of
``repro.kernels.ops.rwkv6_wkv``, whose Pallas kernel is
``repro/kernels/rwkv6_wkv.py``).

:func:`rwkv6_wkv` dispatches on its operands' device: CUDA tensors launch
the hand-written kernel in ``csrc/rwkv6_wkv.cu`` (built on first use by
``kernels/_build.py``); CPU tensors run the plain version in
``kernels/ref.py``. Any other device, operands on several devices, a wrong
dtype or shape, ``hd`` above ``MAX_HEAD_DIM``, a non-contiguous operand on
the card, a failed build or a refused launch raises — nothing falls back.
Unlike the reference's ``ops.rwkv6_wkv``, ``T`` need not be a multiple of
any chunk, and the final state may be written in place over ``s0``.

``launches`` counts kernel launches (the CPU path counts nothing), so a run
can show that its prefills and decode ticks went through the kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._dispatch import (check, on_card, overlaps_partly,
                                          raise_on, stream)

#: launches of the CUDA kernel
launches: Dict[str, int] = {"rwkv6_wkv": 0}

#: the kernel keeps one column of the (hd, hd) state per thread
#: (``csrc/rwkv6_wkv.cu``)
MAX_HEAD_DIM = 128


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check_operands(r, k, v, w, u, s0, state_out) -> None:
    if r.dim() != 4:
        raise ValueError(f"rwkv6_wkv takes r (B, T, H, hd); got "
                         f"{tuple(r.shape)}")
    B, _, H, hd = r.shape
    for t, what, shape in ((k, "k", r.shape), (v, "v", r.shape),
                           (w, "w", r.shape), (u, "u", (H, hd)),
                           (s0, "s0", (B, H, hd, hd))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: expected {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    if state_out is not None and state_out.shape != s0.shape:
        raise ValueError(f"state_out: expected {tuple(s0.shape)}, got "
                         f"{tuple(state_out.shape)}")
    if state_out is not None and overlaps_partly(state_out, s0):
        # each CTA writes its (b, h) state back while others may still be
        # reading theirs: only s0 itself or separate memory is safe
        raise ValueError("state_out overlaps s0 without being s0 itself")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_wkv takes hd <= {MAX_HEAD_DIM}, got {hd}")
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"r: expected bfloat16 or float32, got {r.dtype}")
    for t, what in ((k, "k"), (v, "v")):
        if t.dtype != r.dtype:
            raise TypeError(f"{what}: expected {r.dtype} as r, got "
                            f"{t.dtype}")
    for t, what in ((w, "w"), (u, "u"), (s0, "s0"), (state_out, "state_out")):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what}: expected torch.float32, got {t.dtype}")


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
              state_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence over ``T`` steps from the state ``s0``.

    r, k, v: ``(B, T, H, hd)``, all bfloat16 or all float32; w: ``(B, T,
    H, hd)`` float32 decay; u: ``(H, hd)`` float32; s0: ``(B, H, hd, hd)``
    float32. ``T`` may be 0 (an empty ``y``, the state unchanged).
    ``state_out`` (float32, the shape of ``s0``; may be ``s0`` itself, but
    may not partly overlap it) receives the final state; without it a new tensor does. Returns ``(y
    (B, T, H, hd) float32, final state)``."""
    _check_operands(r, k, v, w, u, s0, state_out)
    outs = () if state_out is None else (state_out,)
    if not on_card(r, k, v, w, u, s0, *outs):
        y, sT = ref.rwkv6_wkv(r, k, v, w, u, s0)
        return y, (sT if state_out is None else state_out.copy_(sT))
    for t, what in ((r, "r"), (k, "k"), (v, "v")):
        check(t, r.dtype, what)
    for t, what in ((w, "w"), (u, "u"), (s0, "s0"), (state_out, "state_out")):
        if t is not None:
            check(t, torch.float32, what)
    B, T, H, hd = r.shape
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    sT = torch.empty_like(s0) if state_out is None else state_out
    if y.numel() == 0:
        return y, (sT if sT is s0 else sT.copy_(s0))
    rc = _build.load("rwkv6_wkv").rwkv6_wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), sT.data_ptr(), B, T, H, hd,
        int(r.dtype == torch.bfloat16), stream(r))
    raise_on(rc, "rwkv6_wkv", "rwkv6_wkv")
    launches["rwkv6_wkv"] += 1
    return y, sT
