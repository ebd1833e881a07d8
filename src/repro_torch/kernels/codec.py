"""Fused codec kernels for the compressed-collective hot path (port of
``repro.kernels.codec``).

Each wrapper dispatches on its operand's device: a CUDA tensor launches
the hand-written kernel in ``csrc/codec_int8.cu`` (built on first use by
``kernels/_build.py``); a CPU tensor runs the plain version in
``kernels/ref.py``. Any other device, a wrong dtype, a non-contiguous
operand, a failed build or a refused launch raises — nothing falls back.

  encode + error feedback   read x (and the carried residual) once; write
                            the int8 wire blocks, the scales and the new
                            residual from registers.
  decode + reduce           accumulate the W incoming wire slices in
                            registers and write the f32 sum once.

``launches`` counts kernel launches per CUDA kernel (the CPU path counts
nothing), so a run can show that its path went through the kernels.

The :class:`CodecLowering` registry holds ``int8_block``; ``int4_block``
and ``fp8_sim`` have no lowering yet and run their plain codec paths.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.compress import BLOCK
from repro_torch.kernels import _build, ref

#: launches per CUDA kernel; both encode wrappers launch int8_block_encode
launches: Dict[str, int] = {"int8_block_encode": 0, "int8_decode_reduce": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises on anything else
    or on operands split across devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"codec operands on several devices: {devs}")
    (dev,) = devs
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no codec kernel for device {dev}")


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the kernel takes contiguous tensors")


def _raise_on(rc: int, kernel: str) -> None:
    if rc:
        msg = _build.load("codec_int8").codec_int8_error_string(rc)
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({msg.decode() if msg else '?'})")


def _encode_launch(x: torch.Tensor, err: Optional[torch.Tensor]):
    _check(x, torch.float32, "x")
    if err is not None:
        _check(err, torch.float32, "err")
        if err.shape != x.shape:
            raise ValueError(f"err {tuple(err.shape)} != x {tuple(x.shape)}")
    lead, L = tuple(x.shape[:-1]), int(x.shape[-1])
    S = 1
    for d in lead:
        S *= int(d)
    nb = -(-L // BLOCK)
    q = torch.empty(lead + (nb, BLOCK), dtype=torch.int8, device=x.device)
    scale = torch.empty(lead + (nb,), dtype=torch.float32, device=x.device)
    res = torch.empty_like(x)
    if S * nb:
        lib = _build.load("codec_int8")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.codec_int8_encode(
            x.data_ptr(), None if err is None else err.data_ptr(),
            q.data_ptr(), scale.data_ptr(), res.data_ptr(), S, L, nb, stream)
        _raise_on(rc, "int8_block_encode")
        launches["int8_block_encode"] += 1
    return {"q": q, "scale": scale}, res


def int8_encode_feedback(x: torch.Tensor, err: torch.Tensor):
    """Encode ``x + err``: ``(*B, L)`` f32 -> ({"q" (*B, nb, 256) int8,
    "scale" (*B, nb) f32}, residual (*B, L) f32)."""
    if not _on_card(x, err):
        return ref.int8_encode_feedback(x, err)
    return _encode_launch(x, err)


def int8_encode_residual(x: torch.Tensor):
    """Encode ``x`` -> (wire form, round-trip residual); as above without
    the carried error."""
    if not _on_card(x):
        return ref.int8_encode_residual(x)
    return _encode_launch(x, None)


def int8_decode_reduce(comp, length: int) -> torch.Tensor:
    """Sum the ``(*B, W, nb, 256)`` int8 wire slices times their
    ``(*B, W, nb)`` scales over W -> ``(*B, length)`` f32 (at most one
    leading batch dim)."""
    q, scale = comp["q"], comp["scale"]
    if not _on_card(q, scale):
        return ref.int8_decode_reduce(comp, length)
    _check(q, torch.int8, "q")
    _check(scale, torch.float32, "scale")
    if q.dim() not in (3, 4) or tuple(q.shape[:-1]) != tuple(scale.shape) \
            or q.shape[-1] != BLOCK:
        raise ValueError(f"wire form q {tuple(q.shape)} / scale "
                         f"{tuple(scale.shape)} is not (*B, W, nb, 256) / "
                         f"(*B, W, nb)")
    W, nb = int(scale.shape[-2]), int(scale.shape[-1])
    if not 0 <= int(length) <= nb * BLOCK:
        raise ValueError(f"length {length} outside [0, {nb * BLOCK}]")
    lead = tuple(q.shape[:-3])
    R = int(lead[0]) if lead else 1
    out = torch.empty(lead + (int(length),), dtype=torch.float32,
                      device=q.device)
    if R * int(length):
        lib = _build.load("codec_int8")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.codec_int8_decode_reduce(q.data_ptr(), scale.data_ptr(),
                                          out.data_ptr(), R, W, nb,
                                          int(length), stream)
        _raise_on(rc, "int8_decode_reduce")
        launches["int8_decode_reduce"] += 1
    return out


# ---------------------------------------------------------------------------
# per-codec lowering registry (what CodecMeta.fused points at)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CodecLowering:
    """The fused entry points for one codec's wire form.

    encode_feedback(x2d, err) -> (comp, new_err)   one pass over x + err
    encode_residual(x2d)      -> (comp, residual)  one pass over x
    decode_reduce(comp, L)    -> (*B, L) f32       one pass over the wire
    """

    name: str
    encode_feedback: Callable
    encode_residual: Callable
    decode_reduce: Callable


LOWERINGS: Dict[str, CodecLowering] = {}


def _register(lw: CodecLowering) -> CodecLowering:
    LOWERINGS[lw.name] = lw
    return lw


_register(CodecLowering(
    "int8_block",
    lambda x, err: int8_encode_feedback(x.contiguous(), err.contiguous()),
    lambda x: int8_encode_residual(x.contiguous()),
    lambda comp, length: int8_decode_reduce(
        {k: v.contiguous() for k, v in comp.items()}, length)))


def lowering(name: str) -> Optional[CodecLowering]:
    """The registered fused lowering for one codec name (None = plain)."""
    return LOWERINGS.get(name)


def fused_codec_names() -> Tuple[str, ...]:
    return tuple(sorted(LOWERINGS))
