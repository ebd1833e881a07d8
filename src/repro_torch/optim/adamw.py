"""AdamW with gradient clipping and learning-rate schedules (port of
``repro.optim.adamw``).

The reference maps its update over parameter trees; here every tensor of
the update is one flat float32 buffer in the reference's flatten order
(``models.params.FlatParams``): the gradient, AdamW's ``m`` and ``v`` and,
with ``master_fp32``, the float32 master weights. :func:`update` takes the
global norm leaf by leaf, then hands the clip's scale (a 0-d tensor on the
buffers' device) and the step's constants to ``kernels.adamw``, which
takes one of two routes by the buffers' device:

  * on the card, the fused kernel (``kernels/csrc/adamw.cu``), one launch
    per weight tensor: it reads the gradient, ``m``, ``v`` and the weight
    (or the master) once, clips in registers, and writes ``m``, ``v``, the
    master and the weight (bf16, some leaves float32, each cast to its own
    dtype) once; no float32 temporary and no host read;
  * on the CPU, the plain passes (``kernels/ref.py`` ``adamw_update``): the
    gradient scaled in place, then a few elementwise passes leaf by leaf in
    pieces of at most ``ADAMW_CHUNK`` elements, so the float32 temporaries
    are a piece's and not the buffer's.

The two give the same bits on the card: the kernel runs the passes'
float32 operations in their order, each rounded as its PyTorch op rounds.

Rounding against the reference: the operations are the reference's
expressions in its order, in float32; the reference's XLA contracts some
``a*b + c`` into fused multiply-adds and sums the global norm in another
order, so the results agree within a few float32 ulps, not bitwise
(``tests/test_torch_train.py`` states the tolerance). :func:`state_logical`
gives the launcher the state's logical axes, keyed as the weights'
(``FlatParams.tree`` views the flat ``m`` and ``v`` leaf by leaf in those
shapes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.core import telemetry as _tm
from repro_torch.kernels import adamw as _kernel


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


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The clip's factor ``min(1, max_norm / (norm + 1e-9))``, a 0-d
    tensor on ``norm``'s device."""
    return torch.clamp(max_norm / (norm + _f32(1e-9)), max=1.0)


def clip_by_global_norm(flat: torch.Tensor, max_norm: float, spans):
    """``(flat * clip_scale(norm, max_norm), norm)``; a float32 ``flat`` is
    scaled in place."""
    norm = global_norm(flat, spans)
    return flat.float().mul_(clip_scale(norm, max_norm)), norm


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
    ``(n,)`` gradient ``grads``, clipped by its global norm. ``state``
    (from :func:`init`) and the weights are updated in place; ``grads`` is
    consumed: on the card it is only read, on the CPU it is scaled in
    place, and no caller reads it after. Returns the metrics
    ``{"grad_norm", "lr"}``. Runs in a ``train/optimizer`` profiler range
    (``core.telemetry``)."""
    with _tm.span("train/optimizer", cat="train"):
        return _update(params, grads, state, cfg)


def _update(params, grads: torch.Tensor, state: Dict, cfg: AdamWConfig
            ) -> Dict[str, torch.Tensor]:
    gnorm = global_norm(grads, params.spans)
    step = int(state["step"]) + 1
    lr = schedule_lr(cfg, step)
    h = _kernel.Hyper(
        lr=lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
        weight_decay=cfg.weight_decay,
        bc1=float(_f32(1.0) - _f32(cfg.b1) ** _f32(step)),
        bc2=float(_f32(1.0) - _f32(cfg.b2) ** _f32(step)))
    decay = [bool(cfg.weight_decay and decays(path))
             for path, _, _, _ in params.spans]
    _kernel.adamw_update(params, grads, state["m"], state["v"],
                         state.get("master"), clip_scale(gnorm, cfg.grad_clip),
                         h, decay)
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
