"""Device dispatch shared by the kernel wrappers: a CUDA operand launches
the hand-written kernel, a CPU operand runs the plain version, anything
else raises. Nothing here falls back.

The model kernels have no backward (nor have the reference's Pallas
kernels), so their wrappers refuse, on every device, an operand that
would need one (:func:`refuse_grad`): a kernel's output has no ``grad_fn``,
and a gradient through it would be zero without a word.

Under the work counter (``roofline/counter.py``) each wrapper counts one
call through :func:`kernel_call`: the :class:`Cost` registered beside it
(the bytes and operations of the function it computes, whichever device
computes it), and none of the aten ops beneath (the plain version's on the
CPU, the launch's allocations on the card). There, and only there, a
``meta`` operand is taken too: the wrapper returns outputs of the kernel's
shapes on ``meta`` without computing them. Outside a count nothing
changes: :func:`on_card` raises for ``meta`` as for any other device."""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build


class Cost(NamedTuple):
    """The work of one kernel call: the bytes its function must move (each
    input read once, each output written once) and its fp32 operations,
    the terms of its roofline bound (PERF.md §6)."""

    nbytes: int
    ops: int


#: the work counters in effect, innermost last: ``roofline.counter``
#: pushes one for the span of its ``with`` (empty outside a count)
COUNTERS: List = []


def counter():
    """The work counter in effect, or None."""
    return COUNTERS[-1] if COUNTERS else None


@contextlib.contextmanager
def kernel_call(name: str, cost: Callable[[], Cost],
                *tensors: torch.Tensor) -> Iterator[bool]:
    """One call of the kernel ``name``. Under the work counter: records
    ``cost()`` once and hides the aten ops run inside the ``with`` from
    the count; yields whether the operands lie on ``meta``, where the
    wrapper returns outputs of the kernel's shapes instead of computing.
    Outside a count it yields False and does nothing else."""
    c = counter()
    if c is None:
        yield False
        return
    with c.kernel(name, cost()):
        yield all(t.device.type == "meta" for t in tensors)


def nbytes(*tensors) -> int:
    """The bytes of ``tensors``' elements (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises on any other
    device or on operands split across devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on several devices: {devs}")
    (dev,) = devs
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if grad mode is on and an operand requires grad: the kernel
    would cut the autograd graph. Train with the kernel flags off (the
    plain versions are differentiable) or call it under ``torch.no_grad``.
    """
    if torch.is_grad_enabled() and any(
            t is not None and torch.is_tensor(t) and t.requires_grad
            for t in tensors):
        raise RuntimeError(f"{kernel} has no backward: an operand requires "
                           f"grad under grad mode (train with the kernel "
                           f"flags off, or call it under torch.no_grad)")


def check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the kernel takes contiguous tensors")


def raise_on(rc: int, lib: str, kernel: str) -> None:
    """Raise with the CUDA error string if a launch returned non-zero."""
    if rc:
        msg = getattr(_build.load(lib), f"{lib}_error_string")(rc)
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({msg.decode() if msg else '?'})")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _span(t: torch.Tensor) -> Tuple[int, int]:
    """The bytes ``[lo, hi)`` that ``t``'s elements lie in."""
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def overlaps_partly(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` shares bytes with ``b`` without being the same view of them
    (a kernel that writes its final state over its initial state takes
    only the state itself or separate memory)."""
    if a.device != b.device or a.device.type == "meta" or \
            a.numel() == 0 or b.numel() == 0:
        return False
    if (a.data_ptr(), a.shape, a.stride()) == (b.data_ptr(), b.shape,
                                               b.stride()):
        return False
    (lo_a, hi_a), (lo_b, hi_b) = _span(a), _span(b)
    return lo_a < hi_b and lo_b < hi_a
