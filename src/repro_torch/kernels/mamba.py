"""The selective-scan kernel of the mamba layers (port of
``repro.kernels.ops.mamba_scan``, whose Pallas kernel is
``repro/kernels/mamba_scan.py``).

:func:`mamba_scan` dispatches on its operands' device: CUDA tensors launch
the hand-written kernel in ``csrc/mamba_scan.cu`` (built on first use by
``kernels/_build.py``); CPU tensors run the plain version in
``kernels/ref.py``. Any other device, operands on several devices, a wrong
dtype or shape, ``N`` above ``MAX_STATE``, a non-contiguous operand on the
card, a failed build or a refused launch raises — nothing falls back.
Unlike the reference's Pallas kernel, the scan starts from a carried state
``h0`` (the reference's serving path runs its plain scan for that), ``T``
and ``Di`` need not be multiples of any chunk, and the final state may be
written in place over ``h0``.

``launches`` counts kernel launches (the CPU path counts nothing), so a run
can show that its prefills and decode ticks went through the kernel. Under
the work counter a call counts :func:`cost` once
(``_dispatch.kernel_call``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._dispatch import (Cost, check, kernel_call,
                                           on_card, overlaps_partly,
                                           raise_on, refuse_grad, stream)

#: launches of the CUDA kernel
launches: Dict[str, int] = {"mamba_scan": 0}

#: modeled fp32 operations of the scan per (step, channel, state): dt*A,
#: dA*h, (dt*x)*B, their add, h*C and its sum (the exponential apart)
OPS_PER_STATE = 6

#: the kernel spreads a channel's N states (padded to 4, 8, 16 or 32) over
#: up to 8 lanes of one warp, four in each thread's registers
#: (``csrc/mamba_scan.cu``)
MAX_STATE = 32


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check_operands(dt, A, Bm, Cm, x, h0, state_out) -> None:
    if dt.dim() != 3 or A.dim() != 2:
        raise ValueError(f"mamba_scan takes dt (B, T, Di) and A (Di, N); "
                         f"got {tuple(dt.shape)}, {tuple(A.shape)}")
    B, T, Di = dt.shape
    N = A.shape[1]
    for t, what, shape in ((A, "A", (Di, N)), (x, "x", (B, T, Di)),
                           (Bm, "Bm", (B, T, N)), (Cm, "Cm", (B, T, N)),
                           (h0, "h0", (B, Di, N)),
                           (state_out, "state_out", (B, Di, N))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what}: expected {shape}, got "
                             f"{tuple(t.shape)}")
    if h0 is not None and state_out is not None and \
            overlaps_partly(state_out, h0):
        # each thread writes its channel's state back while others may
        # still be reading theirs: only h0 itself or separate memory is safe
        raise ValueError("state_out overlaps h0 without being h0 itself")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"mamba_scan takes 1 <= N <= {MAX_STATE}, got {N}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: expected bfloat16 or float32, got {x.dtype}")
    for t, what in ((dt, "dt"), (A, "A"), (Bm, "Bm"), (Cm, "Cm"),
                    (h0, "h0"), (state_out, "state_out")):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what}: expected torch.float32, got {t.dtype}")


def cost(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor) -> Cost:
    """What one call from a carried state must move and compute: dt and y
    in fp32 and x in its type over (B, T, Di), Bm and Cm in fp32, A once,
    h0 read and hT written once; ``OPS_PER_STATE`` fp32 operations per
    (step, channel, state) plus dt*x per (step, channel). Its B*T*Di*N
    exponentials, the SFU's work, are not among them."""
    B, T, Di = dt.shape
    N = A.shape[1]
    return Cost(B * T * Di * (4 + x.element_size() + 4) + 2 * B * T * N * 4
                + Di * N * 4 + 2 * B * Di * N * 4,
                OPS_PER_STATE * B * T * Di * N + B * T * Di)


def mamba_scan(dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               state_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective SSM scan over ``T`` steps from the state ``h0`` (zeros
    without one).

    dt: ``(B, T, Di)`` float32 step sizes; A: ``(Di, N)`` float32; Bm, Cm:
    ``(B, T, N)`` float32; x: ``(B, T, Di)`` bfloat16 or float32; h0:
    ``(B, Di, N)`` float32. ``T`` may be 0 (an empty ``y``, the state
    unchanged). ``state_out`` (float32, ``(B, Di, N)``; may be ``h0``
    itself, but may not partly overlap it) receives the final state;
    without it a new tensor does. Returns ``(y (B, T, Di) float32, final
    state)``. Raises under grad mode when an operand requires grad (the
    kernel has no backward)."""
    refuse_grad("mamba_scan", dt, A, Bm, Cm, x, h0)
    _check_operands(dt, A, Bm, Cm, x, h0, state_out)
    extra = tuple(t for t in (h0, state_out) if t is not None)
    with kernel_call("mamba_scan", lambda: cost(dt, A, x), dt, A, Bm, Cm,
                     x, *extra) as meta:
        if meta:
            B, T, Di = dt.shape
            return (torch.empty((B, T, Di), dtype=torch.float32,
                                device="meta"),
                    torch.empty((B, Di, A.shape[1]), dtype=torch.float32,
                                device="meta")
                    if state_out is None else state_out)
        return _launch(dt, A, Bm, Cm, x, h0, state_out, extra)


def _launch(dt, A, Bm, Cm, x, h0, state_out, extra):
    """The plain version for CPU operands, else the kernel's launch."""
    if not on_card(dt, A, Bm, Cm, x, *extra):
        y, hT = ref.mamba_scan(dt, A, Bm, Cm, x, h0)
        return y, (hT if state_out is None else state_out.copy_(hT))
    check(x, x.dtype, "x")
    for t, what in ((dt, "dt"), (A, "A"), (Bm, "Bm"), (Cm, "Cm"),
                    (h0, "h0"), (state_out, "state_out")):
        if t is not None:
            check(t, torch.float32, what)
    B, T, Di = dt.shape
    N = A.shape[1]
    y = torch.empty((B, T, Di), dtype=torch.float32, device=dt.device)
    hT = (torch.empty((B, Di, N), dtype=torch.float32, device=dt.device)
          if state_out is None else state_out)
    if y.numel() == 0:
        if h0 is None:
            return y, hT.zero_()
        return y, (hT if hT is h0 else hT.copy_(h0))
    rc = _build.load("mamba_scan").mamba_scan(
        dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        x.data_ptr(), 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
        hT.data_ptr(), B, T, Di, N, int(x.dtype == torch.bfloat16),
        stream(dt))
    raise_on(rc, "mamba_scan", "mamba_scan")
    launches["mamba_scan"] += 1
    return y, hT
