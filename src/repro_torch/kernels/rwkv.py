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

Three kernels compute the recurrence on the card, and :func:`rwkv6_wkv`
picks between two by the number of steps: the tick kernel (a (b, head)
state over ``4 * HD`` threads, each warp reading whole state rows, its
sums over rows joined by shuffles and one pass through shared memory;
``ref.rwkv6_wkv_tick_lanes`` is its order of operations in plain PyTorch)
for calls of fewer than ``CHUNKED_FROM`` steps, the decode tick among them,
and the chunked one (:func:`rwkv6_wkv_chunked`; ``ref.rwkv6_wkv_chunked``
is its algorithm in plain PyTorch) for longer ones, the prefill. The
recurrent kernel (:func:`rwkv6_wkv_recurrent`, one CTA per (b, head)
walking the steps) runs only when asked for by name; it and the chunked
one take any ``T``. ``launches`` counts each kernel under its own key (the
CPU path counts nothing): the tick kernel under ``rwkv6_wkv``, so a run can
show that its prefills and decode ticks went through the kernels. Under
the work counter a call of any of the three counts :func:`cost` once,
under ``rwkv6_wkv``, the function they compute
(``_dispatch.kernel_call``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._dispatch import (Cost, check, kernel_call,
                                          on_card, overlaps_partly, raise_on,
                                          refuse_grad, stream)

#: calls of each CUDA kernel: ``rwkv6_wkv`` the tick kernel's (through
#: :func:`rwkv6_wkv`), ``rwkv6_wkv_recurrent`` the recurrent kernel's, and
#: ``rwkv6_wkv_chunked`` the chunked one's (one call is two kernel
#: launches: its intra-chunk pass and its state pass)
launches: Dict[str, int] = {"rwkv6_wkv": 0, "rwkv6_wkv_recurrent": 0,
                            "rwkv6_wkv_chunked": 0}

#: the tick kernel keeps 4 columns of HD / 16 state rows per thread, the
#: recurrent one one column per thread, the chunked one 16-row tiles per
#: warp (``csrc/rwkv6_wkv.cu``)
MAX_HEAD_DIM = 128
#: steps per chunk of the chunked kernel, and the fewest steps a call needs
#: for ``rwkv6_wkv`` to take it: one whole chunk
CHUNK = CHUNKED_FROM = 16


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


def cost(r: torch.Tensor) -> Cost:
    """What one call must move and compute: r, k, v in their type, w and
    y in fp32, s0 read and sT written once, u once; 5 fp32 operations per
    (step, head, state element), 2 for y's sum over the state and 3 for
    the update, and 3 per (step, head, lane) for the bonus term's dot
    product."""
    B, T, H, hd = r.shape
    return Cost(B * T * H * hd * (3 * r.element_size() + 4 + 4)
                + 2 * B * H * hd * hd * 4 + H * hd * 4,
                5 * B * T * H * hd * hd + 3 * B * T * H * hd)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
              state_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence over ``T`` steps from the state ``s0``.

    r, k, v: ``(B, T, H, hd)``, all bfloat16 or all float32; w: ``(B, T,
    H, hd)`` float32 decay; u: ``(H, hd)`` float32; s0: ``(B, H, hd, hd)``
    float32. ``T`` may be 0 (an empty ``y``, the state unchanged).
    ``state_out`` (float32, the shape of ``s0``; may be ``s0`` itself, but
    may not partly overlap it) receives the final state; without it a new
    tensor does. On the card a call of ``CHUNKED_FROM`` steps or more runs
    the chunked kernel, a shorter one the tick kernel. Returns ``(y (B, T,
    H, hd) float32, final state)``."""
    return _run(r, k, v, w, u, s0, state_out, chunked=None)


def rwkv6_wkv_recurrent(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                        state_out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rwkv6_wkv` through the recurrent kernel at any ``T`` (on the
    CPU its plain version, ``ref.rwkv6_wkv``)."""
    return _run(r, k, v, w, u, s0, state_out, chunked=False)


def rwkv6_wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      state_out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rwkv6_wkv` through the chunked kernel at any ``T`` (on the
    CPU its plain version, ``ref.rwkv6_wkv_chunked``)."""
    return _run(r, k, v, w, u, s0, state_out, chunked=True)


def _run(r, k, v, w, u, s0, state_out, chunked):
    """``chunked``: True or False picks a kernel, None picks by ``T``.
    Raises under grad mode when an operand requires grad (no backward)."""
    refuse_grad("rwkv6_wkv", r, k, v, w, u, s0)
    _check_operands(r, k, v, w, u, s0, state_out)
    outs = () if state_out is None else (state_out,)
    with kernel_call("rwkv6_wkv", lambda: cost(r), r, k, v, w, u, s0,
                     *outs) as meta:
        if meta:
            return (torch.empty(r.shape, dtype=torch.float32, device="meta"),
                    torch.empty_like(s0) if state_out is None else state_out)
        return _launch(r, k, v, w, u, s0, state_out, outs, chunked)


def _launch(r, k, v, w, u, s0, state_out, outs, chunked):
    """The plain version for CPU operands, else the kernel's launch."""
    if not on_card(r, k, v, w, u, s0, *outs):
        plain = ref.rwkv6_wkv_chunked if chunked else ref.rwkv6_wkv
        y, sT = plain(r, k, v, w, u, s0)
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
    lib = _build.load("rwkv6_wkv")
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr())
    shape = (B, T, H, hd, int(r.dtype == torch.bfloat16), stream(r))
    if chunked is None and T < CHUNKED_FROM:
        entry = "rwkv6_wkv"
        rc = lib.rwkv6_wkv_tick(*ptrs, *shape)
    elif chunked is False:
        entry = "rwkv6_wkv_recurrent"
        rc = lib.rwkv6_wkv(*ptrs, *shape)
    else:
        entry = "rwkv6_wkv_chunked"
        # the intra pass's blocks for the state pass (y's intra part, v,
        # the decayed r and k, the chunks' decays), in rows of the
        # kernel's width (hd rounded up to 32, 64 or 128)
        width = 32 if hd <= 32 else 64 if hd <= 64 else 128
        ws = torch.empty(B * H * -(-T // CHUNK) * width * (4 * CHUNK + 1),
                         dtype=torch.float32, device=r.device)
        rc = lib.rwkv6_wkv_chunked(*ptrs, ws.data_ptr(), *shape)
    raise_on(rc, "rwkv6_wkv", entry)
    launches[entry] += 1
    return y, sT
