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

The kernel cuts each row's cache into :func:`split_count` spans, one CTA
each, and merges their partials in the same launch (``ref.flash_decode_split``
is its algorithm in plain PyTorch). It takes any group size ``G = H / KV``,
as the reference's kernel does: a CTA holds at most :data:`HEADS_PER_CTA`
query heads, so a larger group is cut into :func:`head_groups` equal
groups, each a CTA over the same K/V rows (each head's arithmetic is the
same whichever CTA holds it). ``launches`` counts kernel launches (the
CPU path counts nothing), so a run can show that its decode ticks went
through the kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._dispatch import (check, on_card, raise_on,
                                          refuse_grad, stream)

#: launches of the CUDA kernel
launches: Dict[str, int] = {"flash_decode": 0}

#: the most query heads one CTA holds, and the largest head dim
#: (``csrc/flash_decode.cu``)
HEADS_PER_CTA, MAX_HEAD_DIM = 8, 128
#: the kernel's CTA width and staged tile (``csrc/flash_decode.cu``)
_WARPS, _TILE_BYTES, _MAX_ROWS = 4, 9216, 128
#: CTAs per SM the split rule aims for
CTAS_PER_SM = 2

#: the combine tickets per (device, stream): one int32 per (b, kv, head
#: group) triple, zero between launches (the kernel's last split of a
#: triple resets its own)
_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def tile_rows(hd: int, esize: int) -> int:
    """Rows of K (or V) per tile the kernel stages: ``_TILE_BYTES`` of rows
    padded by 16 bytes, at most ``_MAX_ROWS``, a multiple of the rows one
    pass of the CTA scores (``launch`` in ``csrc/flash_decode.cu``)."""
    cpr = hd * esize // 16
    lpr = 1 << max(0, (cpr - 1).bit_length())  # lanes per row
    per_pass = 32 // lpr * _WARPS
    rows = min(_TILE_BYTES // (hd * esize + 16), _MAX_ROWS)
    return max(per_pass, rows // per_pass * per_pass)


def head_groups(G: int) -> int:
    """CTAs per ``(b, kv)`` pair: the least count from ``ceil(G /
    HEADS_PER_CTA)`` that cuts a group of ``G`` query heads into equal
    groups (``launch`` in ``csrc/flash_decode.cu`` computes the same)."""
    n = -(-G // HEADS_PER_CTA)
    while G % n:
        n += 1
    return n


def split_count(B: int, KV: int, S: int, hd: int, esize: int,
                n_sm: int, G: int = 1) -> int:
    """The kernel's splits per row: enough CTAs (``B * KV *
    head_groups(G)`` per split) for ``CTAS_PER_SM`` on each of ``n_sm``
    SMs, but no span shorter than one staged tile."""
    want = -(-CTAS_PER_SM * n_sm // (B * KV * head_groups(G)))
    return max(1, min(want, S // tile_rows(hd, esize), 65535))


def _tickets_for(device: torch.device, st: int, pairs: int) -> torch.Tensor:
    t = _tickets.get((device, st))
    if t is None or t.numel() < pairs:
        t = torch.zeros(max(pairs, 1024), dtype=torch.int32, device=device)
        _tickets[(device, st)] = t
    return t


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: Union[int, torch.Tensor]) -> torch.Tensor:
    """One-token GQA attention. q: ``(B, 1, H, hd)``; k, v: ``(B, S, KV,
    hd)``, all bfloat16 or all float32; positions below ``lengths`` (a
    scalar or a ``(B,)`` integer tensor on the operands' device) are valid.
    Returns ``(B, 1, H*hd)`` float32. Raises under grad mode when an
    operand requires grad (the kernel has no backward)."""
    refuse_grad("flash_decode", q, k, v)
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
    if hd > MAX_HEAD_DIM or (hd * esize) % 16 \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"flash_decode kernel takes hd <= {MAX_HEAD_DIM}, "
                         f"16-byte rows and 16-byte aligned k, v; got "
                         f"hd={hd}, {q.dtype}")
    if B == 0:
        return torch.empty((0, 1, H * hd), dtype=torch.float32,
                           device=q.device)
    lens = (lengths.to(torch.int32).expand(B).contiguous() if vec
            else torch.full((B,), int(lengths), dtype=torch.int32,
                            device=q.device))
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = split_count(B, KV, S, hd, esize, n_sm, G)
    out = torch.empty((B, 1, H * hd), dtype=torch.float32, device=q.device)
    part = torch.empty(B * KV * n_split * G * (hd + 2), dtype=torch.float32,
                       device=q.device)
    st = stream(q)
    tickets = _tickets_for(q.device, st, B * KV * head_groups(G))
    rc = _build.load("flash_decode").flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, S, KV, G, hd,
        n_split, int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5, st)
    raise_on(rc, "flash_decode", "flash_decode")
    launches["flash_decode"] += 1
    return out
