"""Shared building blocks: initializers, norms, rotary embeddings (RoPE
and Qwen2-VL's M-RoPE) and the vocab padding (port of
``repro.layers.common``)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.grid import resolve_device

Compute = torch.bfloat16
Accum = torch.float32


def weights_device(generator: Optional[torch.Generator], device
                   ) -> torch.device:
    """The device a module's weights are made on: ``device``, the card
    unless the caller asks for another. A generator that draws them must
    sit on that device; one on another device raises."""
    dev = torch.device(device)
    if generator is not None:
        gen = generator.device
        if gen.type != dev.type or resolve_device(gen) != resolve_device(dev):
            raise ValueError(f"generator on {gen}, weights requested on "
                             f"{dev}")
    return resolve_device(dev)


def param(generator: Optional[torch.Generator], shape, device, init,
          dtype=Compute) -> nn.Parameter:
    """A frozen weight (``DecoderLM.trainable`` thaws it) drawn by
    ``init()`` with a generator, else left uninitialised (``dtype`` on
    ``device``) for loading."""
    t = (init() if generator is not None
         else torch.empty(shape, dtype=dtype, device=device))
    return nn.Parameter(t, requires_grad=False)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, dtype=Compute) -> torch.Tensor:
    """A ``(d_in, d_out)`` weight drawn from N(0, scale^2) in float32 on the
    generator's device, then cast; ``scale`` defaults to ``1/sqrt(d_in)``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """fp32 variance, normalised in fp32, cast back, then times scale."""
    h = x.to(Accum)
    var = (h * h).mean(-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * scale


def init_rmsnorm(d: int, dtype=Compute, device="cuda") -> torch.Tensor:
    """The norm's scale vector (ones)."""
    return torch.ones((d,), dtype=dtype, device=device)


class RMSNorm(nn.Module):
    """The reference's ``{"scale": (d,)}`` norm subtree as a module."""

    def __init__(self, d: int, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(init_rmsnorm(d, device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps)


def pad_vocab(vocab: int, multiple: int) -> int:
    """Pad the vocab so the embedding/logits dims shard over TP cleanly."""
    return -(-vocab // multiple) * multiple


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=Accum,
                                         device=device) / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., T) int -> cos/sin (..., T, head_dim//2) fp32."""
    ang = positions[..., None].to(Accum) * rope_freqs(
        head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, T, H, hd); cos/sin: (B, T, hd//2) (broadcast over heads).
    Rotates in fp32 and casts back."""
    x1, x2 = x.to(Accum).chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """M-RoPE's (temporal, height, width) frequency sections, which fill
    ``head_dim // 2`` slots: (16, 24, 24) at head dim 128."""
    half = head_dim // 2
    return half // 4, half * 3 // 8, half * 3 // 8


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, int, int]):
    """Qwen2-VL M-RoPE: three position streams (temporal, height, width)
    fill disjoint frequency sections. positions3: (B, 3, T) int ->
    cos/sin (B, T, head_dim//2) fp32; frequency slot ``f`` takes its angle
    from the stream whose section holds ``f``."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"sections {sections} do not fill {half} slots")
    freqs = rope_freqs(head_dim, theta, positions3.device)
    ang_all = positions3[..., None].to(Accum) * freqs   # (B, 3, T, half)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=positions3.device),
        torch.tensor(sections, device=positions3.device),
        output_size=half)  # (half,)
    B, _, T, _ = ang_all.shape
    ang = torch.gather(ang_all, 1, sec_id.expand(B, 1, T, half))[:, 0]
    return torch.cos(ang), torch.sin(ang)


def text_positions3(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE: three equal streams, (B, T) -> (B, 3, T)."""
    return torch.stack([positions] * 3, dim=1)
