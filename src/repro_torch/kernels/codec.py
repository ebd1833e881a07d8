"""Fused codec kernels for the compressed-collective hot path (port of
``repro.kernels.codec``).

Each wrapper dispatches on its operand's device: a CUDA tensor launches
the hand-written kernel in ``csrc/codec_{int8,int4,fp8}.cu`` (built on
first use by ``kernels/_build.py``); a CPU tensor runs the plain version
in ``kernels/ref.py``. Any other device, a wrong dtype, a non-contiguous
operand, a failed build or a refused launch raises — nothing falls back.

  encode + error feedback   read x (and the carried residual) once; write
                            the wire form, the scales and the new residual
                            from registers (fp8: one amax pass, then one
                            element pass, since its scale spans a slice).
  decode + reduce           accumulate the W incoming wire slices in
                            registers and write the f32 sum once.

``launches`` counts kernel launches per CUDA kernel (the CPU path counts
nothing), so a run can show that its path went through the kernels. An
encode's error-feedback variant (``HAS_ERR``) counts under its kernel's
name plus ``_feedback``, apart from the residual-only variant; one fp8
encode counts one ``fp8_amax`` and one ``fp8_encode`` launch (with the
suffix under feedback).

The :class:`CodecLowering` registry holds ``int8_block``, ``int4_block``
and ``fp8_sim``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.compress import BLOCK
from repro_torch.kernels import _build, ref
from repro_torch.kernels._dispatch import (check as _check,
                                           on_card as _on_card,
                                           raise_on as _raise_on,
                                           stream as _stream)

#: launches per CUDA kernel; an encode kernel's error-feedback variant
#: counts under its name plus ``_feedback``
launches: Dict[str, int] = {
    "int8_block_encode": 0, "int8_block_encode_feedback": 0,
    "int8_decode_reduce": 0,
    "int4_block_encode": 0, "int4_block_encode_feedback": 0,
    "int4_decode_reduce": 0,
    "fp8_amax": 0, "fp8_encode": 0, "fp8_amax_feedback": 0,
    "fp8_encode_feedback": 0, "fp8_decode_reduce": 0,
}


def _variant(kernel: str, err: Optional[torch.Tensor]) -> str:
    """The ``launches`` key of one encode launch: the feedback variant
    (``err`` given) apart from the residual-only one."""
    return kernel if err is None else kernel + "_feedback"


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_encode(x: torch.Tensor, err: Optional[torch.Tensor]):
    """Checks both encode operands; returns (lead dims, S, L)."""
    _check(x, torch.float32, "x")
    if err is not None:
        _check(err, torch.float32, "err")
        if err.shape != x.shape:
            raise ValueError(f"err {tuple(err.shape)} != x {tuple(x.shape)}")
    lead, L = tuple(x.shape[:-1]), int(x.shape[-1])
    S = 1
    for d in lead:
        S *= int(d)
    return lead, S, L


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _block_encode_launch(lib: str, kernel: str, wire_dtype, wire_cols: int,
                         x: torch.Tensor, err: Optional[torch.Tensor]):
    """One launch of a block codec's encode: wire ``(*B, nb, wire_cols)``,
    scales ``(*B, nb)``, residual like ``x``."""
    lead, S, L = _check_encode(x, err)
    nb = -(-L // BLOCK)
    q = torch.empty(lead + (nb, wire_cols), dtype=wire_dtype,
                    device=x.device)
    scale = torch.empty(lead + (nb,), dtype=torch.float32, device=x.device)
    res = torch.empty_like(x)
    if S * nb:
        rc = getattr(_build.load(lib), f"{lib}_encode")(
            x.data_ptr(), _ptr(err), q.data_ptr(), scale.data_ptr(),
            res.data_ptr(), S, L, nb, _stream(x))
        _raise_on(rc, lib, kernel)
        launches[_variant(kernel, err)] += 1
    return {"q": q, "scale": scale}, res


def _block_decode_launch(lib: str, kernel: str, wire_dtype, wire_cols: int,
                         comp, length: int, align: int = 1) -> torch.Tensor:
    """One launch of a block codec's decode-reduce over ``(*B, W, nb,
    wire_cols)`` wire slices and ``(*B, W, nb)`` scales -> ``(*B,
    length)`` f32 (at most one leading batch dim). ``align``: the bytes
    the kernel's vector loads of ``q`` need its address to be a multiple
    of; any other address raises."""
    q, scale = comp["q"], comp["scale"]
    _check(q, wire_dtype, "q")
    _check(scale, torch.float32, "scale")
    if q.data_ptr() % align:
        raise ValueError(f"q: the {kernel} kernel reads the wire in "
                         f"{align}-byte vectors; its address is not "
                         f"{align}-byte aligned")
    if q.dim() not in (3, 4) or tuple(q.shape[:-1]) != tuple(scale.shape) \
            or q.shape[-1] != wire_cols:
        raise ValueError(f"wire form q {tuple(q.shape)} / scale "
                         f"{tuple(scale.shape)} is not (*B, W, nb, "
                         f"{wire_cols}) / (*B, W, nb)")
    W, nb = int(scale.shape[-2]), int(scale.shape[-1])
    if not 0 <= int(length) <= nb * BLOCK:
        raise ValueError(f"length {length} outside [0, {nb * BLOCK}]")
    lead = tuple(q.shape[:-3])
    R = int(lead[0]) if lead else 1
    out = torch.empty(lead + (int(length),), dtype=torch.float32,
                      device=q.device)
    if R * int(length):
        rc = getattr(_build.load(lib), f"{lib}_decode_reduce")(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), R, W, nb,
            int(length), _stream(q))
        _raise_on(rc, lib, kernel)
        launches[kernel] += 1
    return out


# ---------------------------------------------------------------------------
# int8_block
# ---------------------------------------------------------------------------


def _int8_encode_launch(x, err):
    return _block_encode_launch("codec_int8", "int8_block_encode",
                                torch.int8, BLOCK, x, err)


def int8_encode_feedback(x: torch.Tensor, err: torch.Tensor):
    """Encode ``x + err``: ``(*B, L)`` f32 -> ({"q" (*B, nb, 256) int8,
    "scale" (*B, nb) f32}, residual (*B, L) f32)."""
    if not _on_card(x, err):
        return ref.int8_encode_feedback(x, err)
    return _int8_encode_launch(x, err)


def int8_encode_residual(x: torch.Tensor):
    """Encode ``x`` -> (wire form, round-trip residual); as above without
    the carried error."""
    if not _on_card(x):
        return ref.int8_encode_residual(x)
    return _int8_encode_launch(x, None)


def int8_decode_reduce(comp, length: int) -> torch.Tensor:
    """Sum the ``(*B, W, nb, 256)`` int8 wire slices times their
    ``(*B, W, nb)`` scales over W -> ``(*B, length)`` f32 (at most one
    leading batch dim)."""
    if not _on_card(comp["q"], comp["scale"]):
        return ref.int8_decode_reduce(comp, length)
    return _block_decode_launch("codec_int8", "int8_decode_reduce",
                                torch.int8, BLOCK, comp, length, align=8)


# ---------------------------------------------------------------------------
# int4_block
# ---------------------------------------------------------------------------


def _int4_encode_launch(x, err):
    return _block_encode_launch("codec_int4", "int4_block_encode",
                                torch.uint8, BLOCK // 2, x, err)


def int4_encode_feedback(x: torch.Tensor, err: torch.Tensor):
    """Encode ``x + err``: ``(*B, L)`` f32 -> ({"q" (*B, nb, 128) uint8
    nibble pairs, "scale" (*B, nb) f32}, residual (*B, L) f32)."""
    if not _on_card(x, err):
        return ref.int4_encode_feedback(x, err)
    return _int4_encode_launch(x, err)


def int4_encode_residual(x: torch.Tensor):
    """Encode ``x`` -> (wire form, round-trip residual); as above without
    the carried error."""
    if not _on_card(x):
        return ref.int4_encode_residual(x)
    return _int4_encode_launch(x, None)


def int4_decode_reduce(comp, length: int) -> torch.Tensor:
    """Sum the ``(*B, W, nb, 128)`` packed wire slices times their
    ``(*B, W, nb)`` scales over W -> ``(*B, length)`` f32 (at most one
    leading batch dim)."""
    if not _on_card(comp["q"], comp["scale"]):
        return ref.int4_decode_reduce(comp, length)
    return _block_decode_launch("codec_int4", "int4_decode_reduce",
                                torch.uint8, BLOCK // 2, comp, length)


# ---------------------------------------------------------------------------
# fp8_sim
# ---------------------------------------------------------------------------


def _fp8_encode_launch(x: torch.Tensor, err: Optional[torch.Tensor]):
    lead, S, L = _check_encode(x, err)
    q = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    scale = torch.empty(lead, dtype=torch.float32, device=x.device)
    res = torch.empty_like(x)
    if S and not L:
        raise ValueError("fp8 encode of empty slices: no amax to scale by")
    if S:
        amax = torch.empty((S,), dtype=torch.int32, device=x.device)
        rc = _build.load("codec_fp8").codec_fp8_encode(
            x.data_ptr(), _ptr(err), amax.data_ptr(), q.data_ptr(),
            scale.data_ptr(), res.data_ptr(), S, L, _stream(x))
        _raise_on(rc, "codec_fp8", "fp8_encode")
        launches[_variant("fp8_amax", err)] += 1
        launches[_variant("fp8_encode", err)] += 1
    return {"q": q, "scale": scale}, res


def fp8_encode_feedback(x: torch.Tensor, err: torch.Tensor):
    """Encode ``x + err``: ``(*B, L)`` f32 -> ({"q" (*B, L) uint8 e4m3
    bits, "scale" (*B,) f32}, residual (*B, L) f32)."""
    if not _on_card(x, err):
        return ref.fp8_encode_feedback(x, err)
    return _fp8_encode_launch(x, err)


def fp8_encode_residual(x: torch.Tensor):
    """Encode ``x`` -> (wire form, round-trip residual); as above without
    the carried error."""
    if not _on_card(x):
        return ref.fp8_encode_residual(x)
    return _fp8_encode_launch(x, None)


def fp8_decode_reduce(comp, length: int) -> torch.Tensor:
    """Sum the ``(*B, W, Lq)`` e4m3 wire slices times their ``(*B, W)``
    scales over W -> ``(*B, length)`` f32 (at most one leading batch
    dim). The kernel takes the wire at any address and any ``Lq``: it
    reads 8-byte vectors where ``q``'s address and ``Lq`` are multiples of
    8, single bytes elsewhere."""
    q, scale = comp["q"], comp["scale"]
    if not _on_card(q, scale):
        return ref.fp8_decode_reduce(comp, length)
    _check(q, torch.uint8, "q")
    _check(scale, torch.float32, "scale")
    if q.dim() not in (2, 3) or tuple(q.shape[:-1]) != tuple(scale.shape):
        raise ValueError(f"wire form q {tuple(q.shape)} / scale "
                         f"{tuple(scale.shape)} is not (*B, W, Lq) / "
                         f"(*B, W)")
    W, Lq = int(q.shape[-2]), int(q.shape[-1])
    if not 0 <= int(length) <= Lq:
        raise ValueError(f"length {length} outside [0, {Lq}]")
    lead = tuple(q.shape[:-2])
    R = int(lead[0]) if lead else 1
    out = torch.empty(lead + (int(length),), dtype=torch.float32,
                      device=q.device)
    if R * int(length):
        rc = _build.load("codec_fp8").codec_fp8_decode_reduce(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), R, W, Lq,
            int(length), _stream(q))
        _raise_on(rc, "codec_fp8", "fp8_decode_reduce")
        launches["fp8_decode_reduce"] += 1
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


def _lowering(name, encode_feedback, encode_residual, decode_reduce):
    """Register one codec's wrappers, taking any operand layout (the
    collectives hand over views; the kernels read contiguous rows)."""
    return _register(CodecLowering(
        name,
        lambda x, err: encode_feedback(x.contiguous(), err.contiguous()),
        lambda x: encode_residual(x.contiguous()),
        lambda comp, length: decode_reduce(
            {k: v.contiguous() for k, v in comp.items()}, length)))


_lowering("int8_block", int8_encode_feedback, int8_encode_residual,
          int8_decode_reduce)
_lowering("int4_block", int4_encode_feedback, int4_encode_residual,
          int4_decode_reduce)
_lowering("fp8_sim", fp8_encode_feedback, fp8_encode_residual,
          fp8_decode_reduce)


def lowering(name: str) -> Optional[CodecLowering]:
    """The registered fused lowering for one codec name (None = plain)."""
    return LOWERINGS.get(name)


def fused_codec_names() -> Tuple[str, ...]:
    return tuple(sorted(LOWERINGS))
