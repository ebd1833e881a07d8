"""Mixture-of-Experts with token-choice top-k routing (port of
``repro.layers.moe``'s single-device path, ``_moe_local``).

Each token is routed by float32 router logits (softmax, top-k, the k
weights renormalised), its k copies are sorted by expert (a stable sort),
each expert's SwiGLU runs as plain matrix products over its own group of
rows (the reference's ``ragged_dot``, an XLA product, not a Pallas
kernel), and the outputs come back to their tokens weighted and summed.
The group sizes are read to the host once per call to cut the groups.

Expert weights are stored ``(E, D, F)`` and ``(E, F, D)`` as the
reference stores them; the router is float32. Drawing them is done expert
by expert, so the float32 transient is one expert's matrix, not all of
them (at jamba's width the whole ``(16, 8192, 24576)`` array is 12.9 GB in
float32).

Not ported yet: the expert-parallel path (``_moe_ep_shard``: dispatch and
combine all-to-alls over a TP group of ``comm.split``), ROADMAP.md, queue
1 item 7.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.layers import common
from repro_torch.layers.common import Accum, Compute


def _expert_stack(generator, shape, scale, device) -> torch.Tensor:
    """``(E, d_in, d_out)`` drawn from N(0, scale^2) in float32 one expert
    at a time, each cast on its own."""
    w = torch.empty(shape, dtype=Compute, device=device)
    for e in range(shape[0]):
        w[e] = (torch.randn(shape[1:], generator=generator, device=device)
                * scale).to(Compute)
    return w


class MoE(nn.Module):
    """Weights on ``device`` (the card unless the caller asks for another),
    drawn by ``generator`` (on that device) as the reference's ``init``
    draws them, or left uninitialised for loading."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        dev = common.weights_device(generator, device)
        self.cfg = cfg
        D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
        g = generator
        self.router = common.param(g, (D, E), dev, lambda: common.dense_init(
            g, D, E, dtype=Accum), Accum)
        for name, shape, fan_in in (("w_gate", (E, D, F), D),
                                    ("w_up", (E, D, F), D),
                                    ("w_down", (E, F, D), F)):
            setattr(self, name, common.param(
                g, shape, dev, lambda: _expert_stack(
                    g, shape, 1.0 / math.sqrt(fan_in), dev)))

    def _experts(self, x_sorted: torch.Tensor, counts: torch.Tensor
                 ) -> torch.Tensor:
        """Each expert's SwiGLU over its group of the expert-sorted rows
        (``counts[e]`` rows for expert ``e``, read to the host once)."""
        out = torch.empty_like(x_sorted)
        start = 0
        for e, n in enumerate(counts.tolist()):
            if n:
                rows = x_sorted[start:start + n]
                h = nn.functional.silu(rows @ self.w_gate[e]) \
                    * (rows @ self.w_up[e])
                out[start:start + n] = h.to(rows.dtype) @ self.w_down[e]
            start += n
        return out

    def forward(self, x: torch.Tensor, grid=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, D) -> (y (B, S, D), the load-balance loss, a float32
        scalar). ``grid`` asks for the expert-parallel path, which is not
        ported yet."""
        if grid is not None:
            raise NotImplementedError(
                "expert-parallel MoE (dispatch and combine all-to-alls over "
                "a TP group) is not ported yet (ROADMAP.md, queue 1 item 7)")
        B, S, D = x.shape
        moe = self.cfg.moe
        E, k = moe.n_experts, moe.top_k
        tokens = x.reshape(-1, D)
        probs = torch.softmax(tokens.to(Accum) @ self.router.to(Accum), -1)
        w, ids = torch.topk(probs, k, dim=-1)
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        x_sorted = tokens.repeat_interleave(k, dim=0)[order]
        counts = torch.bincount(flat, minlength=E)
        out = self._experts(x_sorted, counts)
        unsorted = torch.empty_like(out)
        unsorted[order] = out
        y = (unsorted.reshape(-1, k, D) * w[..., None].to(out.dtype)).sum(1)
        # Switch-style load balance: E * sum_e f_e * P_e, f_e the share of
        # the k * tokens routings that went to expert e
        f = counts.to(Accum) / tokens.shape[0]
        aux = E * torch.sum(f / k * probs.mean(0))
        return y.reshape(B, S, D), aux
