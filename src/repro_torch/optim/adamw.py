"""AdamW with gradient clipping and learning-rate schedules (port of
``repro.optim.adamw``).

The reference maps its update over parameter trees; here every tensor of
the update is one flat float32 buffer in the reference's flatten order
(``models.params.FlatParams``): the gradient, AdamW's ``m`` and ``v`` and,
with ``master_fp32``, the float32 master weights. The update is then a few
elementwise passes over those buffers, and the weights (bf16, some leaves
float32) are written back from the new float32 values, each cast to its
own dtype.

Rounding: the passes are the reference's expressions in its order, in
float32; the reference's XLA contracts some ``a*b + c`` into fused
multiply-adds and sums the global norm in another order, so the results
agree within a few float32 ulps, not bitwise (``tests/test_torch_train.py``
states the tolerance). ``state_logical`` (sharding metadata for the
launcher) has no counterpart yet: ROADMAP.md, queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    master_fp32: bool = False
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"


_f32 = np.float32


def schedule_lr(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step`` (warmup, then cosine, linear or
    constant decay), computed in float32 as the reference computes it."""
    if cfg.schedule not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    step = _f32(step)
    warm = min(step / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    if cfg.schedule == "constant":
        decay = _f32(1.0)
    else:
        t = (step - _f32(cfg.warmup_steps)) / _f32(
            max(cfg.total_steps - cfg.warmup_steps, 1))
        t = min(max(t, _f32(0.0)), _f32(1.0))
        lo = _f32(cfg.min_lr_ratio)
        if cfg.schedule == "cosine":
            decay = lo + (_f32(1.0) - lo) * _f32(0.5) * (
                _f32(1.0) + np.cos(_f32(math.pi) * t))
        else:
            decay = lo + (_f32(1.0) - lo) * (_f32(1.0) - t)
    return float(_f32(cfg.lr) * _f32(warm) * _f32(decay))


def init(params, cfg: AdamWConfig) -> Dict:
    """Zero ``m`` and ``v`` (float32, one ``(n,)`` buffer each on the
    weights' device), step 0 and, with ``master_fp32``, the float32 master
    copy of ``params`` (a ``FlatParams``)."""
    zeros = lambda: torch.zeros(params.n, dtype=torch.float32,
                                device=params.device)
    state = {"step": 0, "m": zeros(), "v": zeros()}
    if cfg.master_fp32:
        state["master"] = params.read()
    return state


def global_norm(flat: torch.Tensor, spans) -> torch.Tensor:
    """The float32 L2 norm of a flat buffer, summed leaf by leaf over
    ``spans`` (``FlatParams.spans``), as the reference sums its leaves."""
    total = torch.zeros((), dtype=torch.float32, device=flat.device)
    for _, s, e, _ in spans:
        seg = flat[s:e].float()
        total = total + torch.dot(seg, seg)
    return torch.sqrt(total)


def clip_by_global_norm(flat: torch.Tensor, max_norm: float, spans):
    """``(flat * min(1, max_norm / (norm + 1e-9)), norm)``; a float32
    ``flat`` is scaled in place."""
    norm = global_norm(flat, spans)
    scale = torch.clamp(max_norm / (norm + _f32(1e-9)), max=1.0)
    return flat.float().mul_(scale), norm


_NO_DECAY_SUBSTR = ("ln", "norm", "bias", "scale", "mu", "A_log", "D_skip",
                    "dt_bias", "w0", "u")


def decays(path: str) -> bool:
    """Whether weight decay applies to the leaf at ``path`` (the
    reference's ``_decay_mask``: no listed substring in the lower-cased
    path)."""
    joined = path.lower()
    return not any(s in joined for s in _NO_DECAY_SUBSTR)


def update(params, grads: torch.Tensor, state: Dict, cfg: AdamWConfig
           ) -> Dict[str, torch.Tensor]:
    """One AdamW step on ``params`` (a ``FlatParams``) from the float32
    ``(n,)`` gradient ``grads`` (clipped in place). ``state`` (from
    :func:`init`) and the weights are updated in place. Returns the
    metrics ``{"grad_norm", "lr"}``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, params.spans)
    step = int(state["step"]) + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(_f32(1.0) - _f32(b1) ** _f32(step))
    bc2 = float(_f32(1.0) - _f32(b2) ** _f32(step))
    m, v = state["m"], state["v"]
    m.mul_(b1).add_(grads * (1 - b1))
    v.mul_(b2).add_(torch.square(grads).mul_(1 - b2))
    base = state["master"] if "master" in state else params.read()
    u = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
    if cfg.weight_decay:
        for path, s, e, _ in params.spans:
            if decays(path):
                u[s:e].add_(base[s:e] * cfg.weight_decay)
    new = base.sub_(u.mul_(lr))  # the master, or a fresh float32 copy
    params.assign(new)
    state["step"] = step
    return {"grad_norm": gnorm,
            "lr": torch.tensor(lr, dtype=torch.float32)}
