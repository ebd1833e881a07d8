"""The fused AdamW update of the train steps (``optim.adamw.update``): one
pass over the flat float32 gradient, ``m``, ``v`` and the weights.

There is no TPU kernel behind it: the reference's AdamW is plain ``jnp``,
which XLA fuses. The port's plain version, ``kernels/ref.py``
:func:`~repro_torch.kernels.ref.adamw_update`, runs the update as about 16
elementwise passes a piece, each writing a float32 temporary.

:func:`adamw_update` dispatches on its operands' device: CUDA tensors
launch the hand-written kernel in ``csrc/adamw.cu`` (built on first use by
``kernels/_build.py``), one launch per weight tensor in
``FlatParams.pieces`` order, each reading the gradient, ``m``, ``v`` and
the weight (or the master) once and writing ``m``, ``v`` and the weight
(and the master) once, bitwise what the plain passes give on the card; CPU
tensors run the plain passes. Any other device, a wrong dtype, a
non-contiguous operand, a failed build or a refused launch raises —
nothing falls back. On the card the clip's scale is read from its 0-d
tensor by the kernel, so a call reads nothing back to the host, and the
gradient is only read (the plain passes scale it in place).

``launches`` counts kernel launches (the CPU path counts nothing), so a
run can show that its optimizer went through the kernel. Under the work
counter a call counts :func:`update_cost` once
(``_dispatch.kernel_call``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._dispatch import (Cost, check, kernel_call, on_card,
                                           raise_on, stream)

#: launches of the CUDA kernel
launches: Dict[str, int] = {"adamw_update": 0}

#: fp32 operations per element of the passes the kernel replaces: the
#: clip's multiply, m's three, v's four, the bias corrections, square
#: root, eps and division (five), the learning rate and the subtraction;
#: a decayed leaf's elements two more
OPS = 15
DECAY_OPS = 2

_WEIGHT_DTYPES = (torch.bfloat16, torch.float32)


class Hyper(NamedTuple):
    """One step's hyperparameters, as the plain passes take them (Python
    floats): the learning rate, the moments' decays, eps, the weight decay
    and the bias corrections ``1 - b1**step`` and ``1 - b2**step``."""

    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    bc1: float
    bc2: float


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def update_cost(params, master: bool, decay: Sequence[bool]) -> Cost:
    """What one update must move and compute: the gradient read, ``m`` and
    ``v`` read and written (20 bytes an element), the weights read and
    written or, with a master, the master read and written and the
    weights written, and the clip's scale; ``OPS`` per element plus
    ``DECAY_OPS`` per element of a decayed leaf."""
    n = params.n
    wbytes = sum(t.numel() * t.element_size() for t in params.tensors)
    moved = 8 * n + wbytes if master else 2 * wbytes
    decayed = sum(e - s for (_, s, e, _), d in zip(params.spans, decay) if d)
    return Cost(20 * n + moved + 4, OPS * n + DECAY_OPS * decayed)


def adamw_update(params, grads: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, master, scale: torch.Tensor, h: Hyper,
                 decay: Sequence[bool]) -> None:
    """One AdamW step in place on ``params`` (a ``FlatParams``), ``m``,
    ``v`` and ``master`` (float32 ``(n,)``; ``master`` None without
    ``master_fp32``) from the float32 ``(n,)`` gradient ``grads``, clipped
    by the float32 0-d ``scale``; ``decay`` says per leaf of
    ``params.spans`` whether it decays. ``grads`` is left as it was on the
    card and scaled in place on the CPU: callers do not read it after."""
    extra = () if master is None else (master,)
    with kernel_call("adamw_update",
                     lambda: update_cost(params, master is not None, decay),
                     grads, m, v, *extra) as meta:
        if meta:
            return
        if not on_card(grads, m, v, scale, *extra):
            ref.adamw_update(params, grads, m, v, master, scale, h, decay)
            return
        _launch(params, grads, m, v, master, scale, h, decay)


def _launch(params, grads, m, v, master, scale, h, decay) -> None:
    for t, what in ((grads, "grads"), (m, "m"), (v, "v"), (scale, "scale")) \
            + (() if master is None else ((master, "master"),)):
        check(t, torch.float32, what)
    if scale.numel() != 1:
        raise ValueError(f"scale: expected one element, got "
                         f"{tuple(scale.shape)}")
    if not grads.numel() == m.numel() == v.numel() == params.n or (
            master is not None and master.numel() != params.n):
        raise ValueError(f"adamw_update: {params.n} weights, buffers of "
                         f"{grads.numel()}, {m.numel()}, {v.numel()}")
    for w in params.tensors:
        if w.device != grads.device or w.dtype not in _WEIGHT_DTYPES \
                or not w.is_contiguous():
            raise TypeError(f"adamw_update: a weight of {w.dtype} on "
                            f"{w.device}; the kernel takes contiguous "
                            f"{_WEIGHT_DTYPES} on {grads.device}")
    f = np.float32
    consts = [float(x) for x in (
        f(h.b1), f(1 - h.b1), f(h.b2), f(1 - h.b2),
        # PyTorch divides by a Python float as a multiplication by its
        # float32 reciprocal, taken on the host
        f(1.0) / f(h.bc1), f(1.0) / f(h.bc2),
        f(h.eps), f(h.weight_decay), f(h.lr))]
    lib = _build.load("adamw")
    st = stream(grads)
    gp, mp, vp = grads.data_ptr(), m.data_ptr(), v.data_ptr()
    sp = scale.data_ptr()
    for (_, s, e, _), dec in zip(params.spans, decay):
        for w, lo, hi in params.pieces(s, e):
            at = 4 * (s + lo)
            rc = lib.adamw_update(
                gp + at, mp + at, vp + at,
                None if master is None else master.data_ptr() + at,
                w.data_ptr(), int(w.dtype == torch.float32), int(dec),
                hi - lo, sp, *consts, st)
            raise_on(rc, "adamw", "adamw_update")
            launches["adamw_update"] += 1
