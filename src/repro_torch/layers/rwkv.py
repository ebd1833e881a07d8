"""RWKV-6 (Finch) block: time mixing with data-dependent decay, and channel
mixing (port of ``repro.layers.rwkv``). Attention-free: a layer's decode
state is ``O(1)`` in the context length.

Weights are stored ``(d_in, d_out)`` and in the reference's dtypes: the
decay's ``w0``, ``w1``, ``w2`` and the bonus ``u`` in float32, the rest in
the compute dtype. Parameter names follow the reference's tree (``tm/mu``,
``tm/ln_x/scale``, ``cm/wk``, ...), so ``interop.params_from_reference``
carries it across key for key.

Unlike the reference's immutable arrays, a state passed to
:meth:`TimeMix.forward` or :meth:`ChannelMix.forward` is written in place
(``tm_shift`` and ``cm_shift`` take the last position's input, ``wkv`` the
final WKV state): the serving engine holds one state buffer per layer for
its whole life. With ``use_kernel`` the WKV recurrence goes through
``kernels.rwkv.rwkv6_wkv`` on the carried state (the reference takes its
kernel only without a state, so never while serving); without it, through
the plain recurrence.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ref
from repro_torch.kernels import rwkv as krwkv
from repro_torch.layers import common
from repro_torch.layers.common import Accum, Compute

#: rank of the decay's low-rank projection (``repro.layers.rwkv``)
DECAY_LORA = 64

State = Dict[str, torch.Tensor]


def n_heads(cfg) -> int:
    if cfg.d_model % cfg.rwkv_head_dim:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                         f"rwkv_head_dim {cfg.rwkv_head_dim}")
    return cfg.d_model // cfg.rwkv_head_dim


def init_state(cfg, batch: int, dtype=Compute, device="cuda") -> State:
    """A zeroed decode state: the two token-shift carries in ``dtype``, the
    ``(batch, H, hd, hd)`` WKV state in float32."""
    D, H, hd = cfg.d_model, n_heads(cfg), cfg.rwkv_head_dim
    return {"tm_shift": torch.zeros((batch, D), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, H, hd, hd), dtype=Accum,
                               device=device),
            "cm_shift": torch.zeros((batch, D), dtype=dtype, device=device)}


def _shift(x: torch.Tensor, carry: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: ``x_{t-1}``, with ``carry`` (zeros without one) at
    ``t = 0``. x: (B, T, D), carry: (B, D)."""
    first = (torch.zeros_like(x[:, :1]) if carry is None
             else carry[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


class TimeMix(nn.Module):
    """Weights on ``device`` (the card unless the caller asks for another),
    drawn by ``generator`` (on that device) as the reference's ``init``
    draws them, or left uninitialised for loading."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        dev = common.weights_device(generator, device)
        self.cfg = cfg
        D, H, hd = cfg.d_model, n_heads(cfg), cfg.rwkv_head_dim
        g = generator

        def param(shape, init, dtype=Compute):
            return common.param(g, shape, dev, init, dtype)

        def dense(i, o, dtype=Compute):
            return param((i, o), lambda: common.dense_init(
                g, i, o, dtype=dtype), dtype)

        self.mu = param((5, D), lambda: torch.full((5, D), 0.5, dtype=Compute,
                                                   device=dev))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, dense(D, D))
        # the data-dependent decay w = exp(-exp(w0 + tanh(x @ w1) @ w2))
        self.w0 = param((D,), lambda: torch.full((D,), -2.0, dtype=Accum,
                                                 device=dev), Accum)
        self.w1 = dense(D, DECAY_LORA, Accum)
        self.w2 = dense(DECAY_LORA, D, Accum)
        self.u = param((H, hd), lambda: torch.randn(
            (H, hd), generator=g, device=dev) * 0.1, Accum)
        self.ln_x = common.RMSNorm(D, dev)

    def forward(self, x: torch.Tensor, state: Optional[State] = None,
                use_kernel: bool = False, remat: bool = False
                ) -> torch.Tensor:
        """x: (B, T, D). With ``state`` the token shift starts from its
        ``tm_shift`` and the recurrence from its ``wkv``, and both are
        written in place; without one both start from zeros. ``remat``
        recomputes the plain recurrence in the backward instead of keeping
        its steps."""
        B, T, D = x.shape
        H, hd = n_heads(self.cfg), self.cfg.rwkv_head_dim
        if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the rwkv decay is a float32 product: "
                               "torch.backends.cuda.matmul.allow_tf32 must "
                               "be False")
        xprev = _shift(x, None if state is None else state["tm_shift"])
        mu = self.mu
        xr, xk, xv, xw, xg = (x + (xprev - x) * mu[i] for i in range(5))
        r = (xr @ self.wr).reshape(B, T, H, hd)
        k = (xk @ self.wk).reshape(B, T, H, hd)
        v = (xv @ self.wv).reshape(B, T, H, hd)
        g = nn.functional.silu(xg @ self.wg)
        dd = self.w0 + torch.tanh(xw.to(Accum) @ self.w1) @ self.w2
        w = torch.exp(-torch.exp(dd)).reshape(B, T, H, hd)  # in (0, 1)
        if state is None:
            s0 = torch.zeros((B, H, hd, hd), dtype=Accum, device=x.device)
            out = None
        else:
            s0 = out = state["wkv"]
        if use_kernel:
            y, _ = krwkv.rwkv6_wkv(r, k, v, w, self.u, s0, state_out=out)
        else:
            y, sT = (checkpoint(ref.rwkv6_wkv, r, k, v, w, self.u, s0,
                                use_reentrant=False) if remat
                     else ref.rwkv6_wkv(r, k, v, w, self.u, s0))
            if out is not None:
                out.copy_(sT)
        if state is not None:
            state["tm_shift"].copy_(x[:, -1])
        y = self.ln_x(y.reshape(B, T, D).to(x.dtype), self.cfg.norm_eps) * g
        return y @ self.wo


class ChannelMix(nn.Module):
    """Weights as :class:`TimeMix`'s."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        dev = common.weights_device(generator, device)
        D, F = cfg.d_model, cfg.d_ff
        self.mu = common.param(generator, (2, D), dev, lambda: torch.full(
            (2, D), 0.5, dtype=Compute, device=dev))
        for name, (i, o) in (("wk", (D, F)), ("wv", (F, D)), ("wr", (D, D))):
            setattr(self, name, common.param(
                generator, (i, o), dev,
                lambda: common.dense_init(generator, i, o)))

    def forward(self, x: torch.Tensor, state: Optional[State] = None
                ) -> torch.Tensor:
        """x: (B, T, D). With ``state`` the token shift starts from its
        ``cm_shift``, which is written in place."""
        xprev = _shift(x, None if state is None else state["cm_shift"])
        xk = x + (xprev - x) * self.mu[0]
        xr = x + (xprev - x) * self.mu[1]
        k = torch.square(torch.relu(xk @ self.wk))
        out = torch.sigmoid(xr @ self.wr) * (k @ self.wv)
        if state is not None:
            state["cm_shift"].copy_(x[:, -1])
        return out
