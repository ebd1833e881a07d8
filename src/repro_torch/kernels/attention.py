"""The flash-decode kernel for the serving tick (port of
``repro.kernels.ops.flash_decode``, whose Pallas kernel is
``repro/kernels/flash_decode.py``).

:func:`flash_decode` dispatches on its operands' device: CUDA tensors
launch the hand-written kernel in ``csrc/flash_decode.cu`` (built on first
use by ``kernels/_build.py``); CPU tensors run the plain version in
``kernels/ref.py``. Any other device, operands on several devices, a wrong
dtype, a non-contiguous operand, a shape the kernel does not take, a failed
build or a refused launch raises — nothing falls back. Unlike the
reference's ``ops.flash_decode``, the length may be a ``(B,)`` vector (row
``b`` masked at ``lengths[b]``, what the reference kernel computes row by
row with a scalar) and ``S`` need not be a multiple of any chunk.

``launches`` counts kernel launches (the CPU path counts nothing), so a run
can show that its decode ticks went through the kernel.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._dispatch import check, on_card, raise_on, stream

#: launches of the CUDA kernel
launches: Dict[str, int] = {"flash_decode": 0}

#: limits of the kernel (``csrc/flash_decode.cu``)
MAX_GROUP, MAX_HEAD_DIM = 8, 128


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: Union[int, torch.Tensor]) -> torch.Tensor:
    """One-token GQA attention. q: ``(B, 1, H, hd)``; k, v: ``(B, S, KV,
    hd)``, all bfloat16 or all float32; positions below ``lengths`` (a
    scalar or a ``(B,)`` integer tensor on the operands' device) are valid.
    Returns ``(B, 1, H*hd)`` float32."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if T != 1 or tuple(k.shape) != (B, S, KV, hd) or k.shape != v.shape \
            or KV < 1 or H % KV:
        raise ValueError(f"flash_decode takes q (B, 1, KV*G, hd) and k, v "
                         f"(B, S, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if S < 1:
        raise ValueError("flash_decode over an empty cache")
    vec = torch.is_tensor(lengths)
    if vec and tuple(lengths.shape) not in ((), (B,)):
        raise ValueError(f"lengths {tuple(lengths.shape)} is neither a "
                         f"scalar nor ({B},)")
    if vec and (lengths.is_floating_point() or lengths.is_complex()):
        raise TypeError(f"lengths: expected an integer tensor, got "
                        f"{lengths.dtype}")
    if not on_card(q, k, v, *((lengths,) if vec else ())):
        return ref.flash_decode(q, k, v, lengths)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q: the kernel takes bfloat16 or float32, got "
                        f"{q.dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        check(t, q.dtype, what)
    G, esize = H // KV, q.element_size()
    if G > MAX_GROUP or hd > MAX_HEAD_DIM or (hd * esize) % 16 \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"flash_decode kernel takes G <= {MAX_GROUP}, hd <= "
                         f"{MAX_HEAD_DIM}, 16-byte rows and 16-byte aligned "
                         f"k, v; got G={G}, hd={hd}, {q.dtype}")
    if B == 0:
        return torch.empty((0, 1, H * hd), dtype=torch.float32,
                           device=q.device)
    lens = (lengths.to(torch.int32).expand(B).contiguous() if vec
            else torch.full((B,), int(lengths), dtype=torch.int32,
                            device=q.device))
    out = torch.empty((B, 1, H * hd), dtype=torch.float32, device=q.device)
    rc = _build.load("flash_decode").flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, S, KV, G, hd, int(q.dtype == torch.bfloat16),
        1.0 / hd ** 0.5, stream(q))
    raise_on(rc, "flash_decode", "flash_decode")
    launches["flash_decode"] += 1
    return out
