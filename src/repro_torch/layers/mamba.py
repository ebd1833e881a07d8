"""Mamba-1 selective SSM block, as interleaved in jamba (port of
``repro.layers.mamba``).

Weights are stored ``(d_in, d_out)`` and in the reference's dtypes:
``A_log`` and ``D_skip`` in float32, the rest in the compute dtype; names
follow the reference's tree, so ``interop.params_from_reference`` carries
it across key for key. The rounding points are the reference's: the
causal depthwise conv is its sum of ``K`` shifted products in the compute
dtype (not ``conv1d``, which would round elsewhere and, in float32, run
TF32 on the card), ``x`` is in the compute dtype after ``silu``, and
``dt``, ``B``, ``C`` and the scan are float32.

Unlike the reference's immutable arrays, a state passed to
:meth:`Mamba.forward` is written in place (``conv`` takes the last ``K -
1`` inputs of the conv, ``ssm`` the final scan state): the serving engine
holds one state buffer per layer for its whole life. With ``use_kernel``
the scan goes through ``kernels.mamba.mamba_scan``, with or without a
carried state (the reference takes its kernel only without a state, so
never while serving); without it, through the plain scan.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import mamba as kmamba
from repro_torch.kernels import ref
from repro_torch.layers import common
from repro_torch.layers.common import Accum, Compute

State = Dict[str, torch.Tensor]


def dims(cfg) -> Tuple[int, int, int, int]:
    """``(Di, dt_rank, N, K)``: inner width, rank of the step-size
    projection, state size and conv width."""
    Di = cfg.mamba_expand * cfg.d_model
    dt_rank = -(-cfg.d_model // 16)
    return Di, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


def logical_axes(cfg=None):
    """The weights' logical axes (the reference's ``logical_axes``)."""
    return {"in_proj": ("fsdp", "inner"), "conv_w": (None, "inner"),
            "conv_b": ("inner",), "x_proj": ("inner", None),
            "dt_proj": (None, "inner"), "dt_bias": ("inner",),
            "A_log": ("inner", None), "D_skip": ("inner",),
            "out_proj": ("inner", "fsdp")}


def state_logical():
    return {"conv": ("batch", None, "inner"),
            "ssm": ("batch", "inner", None)}


def init_state(cfg, batch: int, dtype=Compute, device="cuda") -> State:
    """A zeroed decode state: the conv's last ``K - 1`` inputs ``(batch,
    K - 1, Di)`` in ``dtype``, the scan state ``(batch, Di, N)`` in
    float32."""
    Di, _, N, K = dims(cfg)
    return {"conv": torch.zeros((batch, K - 1, Di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, Di, N), dtype=Accum, device=device)}


class Mamba(nn.Module):
    """Weights on ``device`` (the card unless the caller asks for another),
    drawn by ``generator`` (on that device) as the reference's ``init``
    draws them, or left uninitialised for loading."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        dev = common.weights_device(generator, device)
        self.cfg = cfg
        D = cfg.d_model
        Di, R, N, K = dims(cfg)
        g = generator

        def param(name, shape, init, dtype=Compute):
            setattr(self, name, common.param(g, shape, dev, init, dtype))

        def dense(name, i, o):
            param(name, (i, o), lambda: common.dense_init(g, i, o))

        dense("in_proj", D, 2 * Di)
        param("conv_w", (K, Di), lambda: (torch.randn(
            (K, Di), generator=g, device=dev) / math.sqrt(K)).to(Compute))
        param("conv_b", (Di,), lambda: torch.zeros((Di,), dtype=Compute,
                                                   device=dev))
        dense("x_proj", Di, R + 2 * N)
        dense("dt_proj", R, Di)
        # softplus(-4.6) ~ 0.01: the initial step size
        param("dt_bias", (Di,), lambda: torch.full((Di,), -4.6,
                                                   dtype=Compute, device=dev))
        param("A_log", (Di, N), lambda: torch.log(torch.arange(
            1, N + 1, dtype=Accum, device=dev)).expand(Di, N).contiguous(),
            Accum)
        param("D_skip", (Di,), lambda: torch.ones((Di,), dtype=Accum,
                                                  device=dev), Accum)
        dense("out_proj", Di, D)

    def forward(self, u: torch.Tensor, state: Optional[State] = None,
                use_kernel: bool = False, remat: bool = False
                ) -> torch.Tensor:
        """u: (B, T, D). With ``state`` the conv starts from its ``conv``
        history and the scan from its ``ssm``, and both are written in
        place; without one both start from zeros. ``remat`` recomputes the
        plain scan in the backward instead of keeping its steps."""
        B, T, _ = u.shape
        Di, R, N, K = dims(self.cfg)
        x, z = (u @ self.in_proj).split(Di, dim=-1)
        # causal depthwise conv over time; the carried history stands in
        # for the zero padding at t < 0
        carry = (torch.zeros((B, K - 1, Di), dtype=x.dtype, device=x.device)
                 if state is None else state["conv"].to(x.dtype))
        xp = torch.cat([carry, x], dim=1)
        if state is not None and K > 1:
            state["conv"].copy_(xp[:, -(K - 1):])
        x = sum(xp[:, i:i + T] * self.conv_w[i] for i in range(K))
        x = nn.functional.silu(x + self.conv_b)

        dt, Bm, Cm = (x @ self.x_proj).split([R, N, N], dim=-1)
        dt = nn.functional.softplus((dt @ self.dt_proj).to(Accum)
                                    + self.dt_bias.to(Accum))
        Bm, Cm = (t.to(Accum).contiguous() for t in (Bm, Cm))
        A = -torch.exp(self.A_log)
        h0 = None if state is None else state["ssm"]
        if use_kernel:
            y, _ = kmamba.mamba_scan(dt, A, Bm, Cm, x, h0, state_out=h0)
        else:
            y, hT = (checkpoint(ref.mamba_scan, dt, A, Bm, Cm, x, h0,
                                use_reentrant=False) if remat
                     else ref.mamba_scan(dt, A, Bm, Cm, x, h0))
            if h0 is not None:
                h0.copy_(hT)
        y = y + x.to(Accum) * self.D_skip
        y = y.to(u.dtype) * nn.functional.silu(z)
        return y @ self.out_proj
