"""The training step: loss, gradient, AdamW update, with microbatch
gradient accumulation (port of ``repro.train.step``).

The reference's ``train_step`` is a pure function of parameter and
optimizer-state trees, which ``make_jitted_train_step`` jits under pjit
over the production mesh. Here :func:`train_step` runs on one device and
is that function's counterpart: the model's weights and the AdamW state
(flat float32 buffers, ``optim.adamw``) are updated in place. The
data-parallel steps over a rank grid are in ``train/manual_step.py``.

The sharded step is ``train_step(..., rules=, grid=)``, the reference's
``rules=`` and ``mesh=``: they reach the model's forward, so with a grid
whose TP axis splits the experts every MoE block runs expert parallel,
forward and backward (``layers/moe.py``); every other block computes as on
one device (on a grid held by one device a sharding constraint changes no
value). ``make_jitted_train_step`` has no counterpart (ROADMAP.md).

Gradients are taken with ``torch.autograd.grad`` with respect to the
model's weights in the reference's flatten order (``models.params.
FlatParams``) and land, cast to float32, in one flat ``(n,)`` buffer: the
reference's gradients of bf16 leaves are bf16 and are cast at its flatten,
the same point.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.layers.common import Accum
from repro_torch.models.decoder import RunFlags
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1
    z_loss: float = 1e-4
    flags: RunFlags = RunFlags()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, S, V) any dtype, labels (B, S) integers (-1 = masked).
    fp32 log-softmax; returns ``(mean loss, n_tokens)``."""
    mask = labels >= 0
    labels = labels.clamp_min(0).long()
    lg = logits.to(Accum)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    n = mask.sum().clamp_min(1)
    return torch.where(mask, nll, 0.0).sum() / n, n


def loss_fn(model, batch: Batch, tcfg: TrainConfig, rules=None, grid=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(ce + moe_weight * aux, {"ce", "aux", "tokens"})`` of the model on
    ``batch``: ``tokens`` and ``labels`` ``(B, T)``, plus ``frames`` (B,
    S_enc, D) for the encoder-decoder, or optional ``embeds`` (B, T_p, D)
    put before the decoder's tokens, whose positions the loss skips (they
    are inputs). ``rules`` and ``grid`` reach the model's forward."""
    cfg = model.cfg
    flags = tcfg.flags
    if cfg.family == "encdec":
        logits, aux, _ = model.forward_train(batch["frames"],
                                             batch["tokens"], flags,
                                             rules=rules, grid=grid)
    else:
        embeds = batch.get("embeds")
        logits, aux, _ = model(batch["tokens"], flags=flags, rules=rules,
                               grid=grid, embeds=embeds)
        if embeds is not None:
            logits = logits[:, embeds.shape[1]:]
    ce, n = cross_entropy(logits, batch["labels"], tcfg.z_loss)
    moe_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return ce + moe_w * aux, {"ce": ce, "aux": aux, "tokens": n}


def value_and_grad(model, flat: FlatParams, batch: Batch, tcfg: TrainConfig,
                   rules=None, grid=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              List[Optional[torch.Tensor]]]:
    """``(loss, metrics, grads)``: the gradients one per weight in
    ``flat.tensors``' order, in the weights' dtypes (None for a weight the
    loss does not reach)."""
    with torch.enable_grad():
        loss, metrics = loss_fn(model, batch, tcfg, rules, grid)
        grads = torch.autograd.grad(loss, flat.tensors, allow_unused=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            list(grads))


def split_batch(batch: Batch, n: int) -> List[Batch]:
    """``n`` equal slices of dim 0 (which ``n`` must divide), in order."""
    B = batch["tokens"].shape[0]
    if B % n:
        raise ValueError(f"batch of {B} does not split into {n}")
    b = B // n
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()
             if v is not None} for i in range(n)]


def train_step(model, opt_state: Dict, batch: Batch, tcfg: TrainConfig,
               flat: Optional[FlatParams] = None, rules=None, grid=None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step of ``model`` (made trainable), optionally over
    ``tcfg.microbatches`` gradient-accumulation slices of the batch (its
    dim 0 must divide): float32 accumulators take ``g / nmb`` and ``loss /
    nmb``, the other metrics are the last microbatch's. Updates the weights
    and ``opt_state`` in place; returns the metrics (``ce``, ``aux``,
    ``tokens``, ``grad_norm``, ``lr``, ``loss``) as 0-d tensors. With
    ``rules`` and ``grid`` it is the sharded step. Autograd's gradients are
    dropped once they are in the flat float32 buffer, before the update."""
    model.trainable()
    flat = flat if flat is not None else FlatParams.of(model)
    nmb = tcfg.microbatches
    if nmb == 1:
        loss, metrics, grads = value_and_grad(model, flat, batch, tcfg,
                                              rules, grid)
        g = flat.gather(grads)
        del grads
    else:
        g = torch.zeros(flat.n, dtype=torch.float32, device=flat.device)
        loss = torch.zeros((), dtype=Accum, device=flat.device)
        for mb in split_batch(batch, nmb):
            mb_loss, metrics, grads = value_and_grad(model, flat, mb, tcfg,
                                                     rules, grid)
            flat.accumulate(grads, g, nmb)
            loss = loss + mb_loss / nmb
            del grads
    om = adamw.update(flat, g, opt_state, tcfg.optimizer)
    return dict(metrics, **om, loss=loss)
