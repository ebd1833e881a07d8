"""Plain PyTorch versions of the codec kernels.

Each function computes exactly what its CUDA kernel in
``kernels/csrc/codec_int8.cu`` computes, with ordinary tensor ops. The
wrappers in ``kernels/codec.py`` use these only for tensors on the CPU; the
tests hold them against the reference's Pallas kernels (interpret mode),
and ``chip_smoke.py`` holds each kernel against them on the card.

Every function takes an optional leading rank dim: ``x`` is ``(S, L)`` or
``(R, S, L)``; wire leaves and outputs carry the same leading dims.

Rounding contract shared with the kernels (see ``core/compress.py``):
scale ``amax * f32(1/127)``, round half to even, residual ``c - q*scale``
and the decode accumulation ``acc + q*scale`` each rounded once (fused
multiply-add), accumulated over peers ``w = 0..W-1`` in order from 0.

NaN: a NaN in a block makes its amax and scale NaN, so the block's
residual and every decoded sum that includes the block are NaN. The int8
value written for that block is not specified (the kernel writes -127).
"""
from __future__ import annotations

import torch

from repro_torch.core.compress import (BLOCK, _RECIP127, _blocks,
                                       _fma_residual, _quantize)


def _encode(c):
    lead, L = tuple(c.shape[:-1]), c.shape[-1]
    blocks = _blocks(c.reshape(-1, L))
    q, scale = _quantize(blocks, _RECIP127, 127)
    res = _fma_residual(blocks, q, scale[..., None])
    nb = blocks.shape[1]
    return ({"q": q.to(torch.int8).reshape(lead + (nb, BLOCK)),
             "scale": scale.reshape(lead + (nb,))},
            res.reshape(-1, nb * BLOCK)[:, :L].reshape(lead + (L,)))


def int8_encode_feedback(x, err):
    """Encode ``x + err`` (float32 add) -> ({"q", "scale"}, residual)."""
    return _encode(x.float() + err.float())


def int8_encode_residual(x):
    """Encode ``x`` -> ({"q", "scale"}, residual)."""
    return _encode(x.float())


def int8_decode_reduce(comp, length: int):
    """Sum over the peer axis W of ``q * scale``: ``q`` is
    ``(*B, W, nb, 256)`` int8, ``scale`` ``(*B, W, nb)`` -> ``(*B, length)``
    float32. Float64 holds each ``acc + q*scale`` exactly for payloads whose
    peer scales lie within 2**29 of each other, so the cast back is the
    fused multiply-add's single rounding."""
    q, scale = comp["q"], comp["scale"]
    W, nb = scale.shape[-2:]
    acc = torch.zeros(tuple(q.shape[:-3]) + (nb * BLOCK,),
                      dtype=torch.float32, device=q.device)
    for w in range(W):
        term = (q[..., w, :, :].double().flatten(-2)
                * scale[..., w, :].double().repeat_interleave(BLOCK, dim=-1))
        acc = (acc.double() + term).float()
    return acc[..., :length]
