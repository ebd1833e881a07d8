"""Device dispatch shared by the kernel wrappers: a CUDA operand launches
the hand-written kernel, a CPU operand runs the plain version, anything
else raises. Nothing here falls back."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


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
