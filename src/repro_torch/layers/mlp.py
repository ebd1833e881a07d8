"""SwiGLU MLP (llama family), port of ``repro.layers.mlp``. Weights are
stored ``(d_in, d_out)`` as the reference stores them, so ``x @ W`` needs
no transpose when weights are carried across."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.layers import common


class MLP(nn.Module):
    """Weights on ``device`` (the card unless the caller asks for another),
    drawn by ``generator`` (on that device) or left uninitialised for
    loading."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda", d_ff: Optional[int] = None):
        super().__init__()
        dev = common.weights_device(generator, device)
        D, F = cfg.d_model, d_ff or cfg.d_ff
        shapes = {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
        for name, (i, o) in shapes.items():
            w = (common.dense_init(generator, i, o) if generator is not None
                 else torch.empty((i, o), dtype=common.Compute, device=dev))
            setattr(self, name, nn.Parameter(w, requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = nn.functional.silu(x @ self.w_gate) * (x @ self.w_up)
        return h @ self.w_down
