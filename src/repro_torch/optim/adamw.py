"""AdamW with gradient clipping and learning-rate schedules (port of
``repro.optim.adamw``).

The reference maps its update over parameter trees; here every tensor of
the update is one flat float32 buffer in the reference's flatten order
(``models.params.FlatParams``): the gradient, AdamW's ``m`` and ``v`` and,
with ``master_fp32``, the float32 master weights. The update is then a few
elementwise passes over those buffers, run leaf by leaf in pieces of at
most :data:`CHUNK` elements, so its float32 temporaries are a piece's and
not the buffer's (at qwen3-moe's width a buffer is 14.8 GB); the weights
(bf16, some leaves float32) are written back from the new float32 values,
each cast to its own dtype. Every element goes through the same
operations in the same order whatever the pieces, so the bits do not
depend on them.

Rounding: the passes are the reference's expressions in its order, in
float32; the reference's XLA contracts some ``a*b + c`` into fused
multiply-adds and sums the global norm in another order, so the results
agree within a few float32 ulps, not bitwise (``tests/test_torch_train.py``
states the tolerance). :func:`state_logical` gives the launcher the
state's logical axes, keyed as the weights' (``FlatParams.tree`` views the
flat ``m`` and ``v`` leaf by leaf in those shapes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.core import telemetry as _tm


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

#: elements of one piece of the update's elementwise passes
CHUNK = 1 << 24


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
    metrics ``{"grad_norm", "lr"}``. Runs in a ``train/optimizer``
    profiler range (``core.telemetry``)."""
    with _tm.span("train/optimizer", cat="train"):
        return _update(params, grads, state, cfg)


def _update(params, grads: torch.Tensor, state: Dict, cfg: AdamWConfig
            ) -> Dict[str, torch.Tensor]:
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, params.spans)
    step = int(state["step"]) + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(_f32(1.0) - _f32(b1) ** _f32(step))
    bc2 = float(_f32(1.0) - _f32(b2) ** _f32(step))
    m, v, master = state["m"], state["v"], state.get("master")
    for path, s, e, _ in params.spans:
        decay = cfg.weight_decay and decays(path)
        for a in range(s, e, CHUNK):
            b = min(e, a + CHUNK)
            g = grads[a:b]
            m_, v_ = m[a:b], v[a:b]
            m_.mul_(b1).add_(g * (1 - b1))
            v_.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            base = master[a:b] if master is not None else \
                params.read_range(a, b)
            u = (m_ / bc1).div_(torch.sqrt(v_ / bc2).add_(cfg.eps))
            if decay:
                u.add_(base * cfg.weight_decay)
            # the master in place, or a fresh float32 copy of the piece
            params.assign_range(a, b, base.sub_(u.mul_(lr)))
    state["step"] = step
    return {"grad_norm": gnorm,
            "lr": torch.tensor(lr, dtype=torch.float32)}


def state_logical(param_logical, cfg: AdamWConfig) -> Dict:
    """The optimizer state's logical axes (the reference's
    ``state_logical``): ``m``, ``v`` and the master shard exactly like the
    weights (ZeRO), the step is a scalar. ``param_logical`` is a model's
    ``logical(cfg)``."""
    out = {"step": (), "m": param_logical, "v": param_logical}
    if cfg.master_fp32:
        out["master"] = param_logical
    return out
