"""Fused codec kernels for the compressed-collective hot path (port of
``repro.kernels.codec``).

Each wrapper dispatches on its operand's device: a CUDA tensor launches
the hand-written kernel in ``csrc/codec_{int8,int4,fp8}.cu`` (built on
first use by ``kernels/_build.py``); a CPU tensor runs the plain version
in ``kernels/ref.py``. Any other device, a wrong dtype, a non-contiguous
operand, a failed build or a refused launch raises — nothing falls back.

  encode + error feedback   read x (and the carried residual) once; write
                            the wire form, the scales and the new residual
                            from registers (fp8: one launch, a slice a
                            thread-block cluster, whose CTAs share the
                            slice's amax through distributed shared memory
                            before any element is scaled).
  decode + reduce           accumulate the W incoming wire slices in
                            registers and write the f32 sum once.

``launches`` counts kernel launches per CUDA kernel (the CPU path counts
nothing), so a run can show that its path went through the kernels. An
encode's error-feedback variant (``HAS_ERR``) counts under its kernel's
name plus ``_feedback``, apart from the residual-only variant; every
encode call is one launch, fp8's too (``fp8_encode``, or
``fp8_encode_feedback``).

The :class:`CodecLowering` registry holds ``int8_block``, ``int4_block``
and ``fp8_sim``.

Under the work counter a call of any of the nine functions counts its
cost (:func:`encode_cost`, :func:`decode_cost`) once, under the function's
name (``_dispatch.kernel_call``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.compress import BLOCK
from repro_torch.kernels import _build, ref
from repro_torch.kernels._dispatch import (Cost, kernel_call, nbytes,
                                           check as _check,
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
    "fp8_encode": 0, "fp8_encode_feedback": 0, "fp8_decode_reduce": 0,
}


#: modeled fp32 operations per element: the block encodes (add, abs, max,
#: mul, div, rint, 2 clips, fma), the fp8 encode (add, abs, max, mul, max,
#: div, 2 clips, 2 converts, fma) and one fma per peer in decode-reduce
ENCODE_OPS = {"int8": 9, "int4": 9, "fp8": 11}
DECODE_OPS_PER_PEER = 2
#: wire bytes per 256-element block of the block codecs
_BLOCK_WIRE = {"int8": BLOCK, "int4": BLOCK // 2}


def encode_cost(codec: str, x: torch.Tensor,
                err: Optional[torch.Tensor] = None) -> Cost:
    """What one encode of ``codec`` ("int8", "int4" or "fp8") must move
    and compute: x (and the carried error) read, the wire, the scales and
    the f32 residual written; ``ENCODE_OPS`` per element."""
    L = int(x.shape[-1]) if x.dim() else 1
    S = x.numel() // max(L, 1)
    if codec == "fp8":
        wire, scales = S * L, 4 * S
    else:
        nb = -(-L // BLOCK)
        wire, scales = S * nb * _BLOCK_WIRE[codec], 4 * S * nb
    return Cost(nbytes(x, err) + wire + scales + 4 * S * L,
                ENCODE_OPS[codec] * S * L)


def decode_cost(codec: str, comp, length: int) -> Cost:
    """What one decode-reduce of ``codec`` must move and compute: the wire
    and the scales read, the f32 sum written per rank; one fma per (rank,
    peer, element)."""
    q, scale = comp["q"], comp["scale"]
    fp8 = codec == "fp8"
    slices = scale.numel() if fp8 else \
        scale.numel() // max(int(scale.shape[-1]), 1)  # ranks x peers
    R = int(q.shape[0]) if q.dim() == (3 if fp8 else 4) else 1
    return Cost(nbytes(q, scale) + 4 * R * int(length),
                DECODE_OPS_PER_PEER * slices * int(length))


def _encode_meta(codec: str, x: torch.Tensor):
    """An encode's outputs on ``meta``, shaped as the kernel's."""
    lead, L = tuple(x.shape[:-1]), int(x.shape[-1])
    if codec == "fp8":
        comp = {"q": torch.empty(x.shape, dtype=torch.uint8, device="meta"),
                "scale": torch.empty(lead, dtype=torch.float32,
                                     device="meta")}
    else:
        nb = -(-L // BLOCK)
        comp = {"q": torch.empty(lead + (nb, _BLOCK_WIRE[codec]),
                                 dtype=torch.int8 if codec == "int8"
                                 else torch.uint8, device="meta"),
                "scale": torch.empty(lead + (nb,), dtype=torch.float32,
                                     device="meta")}
    return comp, torch.empty_like(x)


def _encode(codec: str, plain, launch, x: torch.Tensor,
            err: Optional[torch.Tensor] = None):
    """One encode call: counted under the work counter, the plain
    version for CPU operands, else ``launch``."""
    operands = (x,) if err is None else (x, err)
    name = f"{codec}_encode_{'residual' if err is None else 'feedback'}"
    with kernel_call(name, lambda: encode_cost(codec, x, err),
                     *operands) as meta:
        if meta:
            return _encode_meta(codec, x)
        if not _on_card(*operands):
            return plain(*operands)
        return launch(x, err)


def _decode(codec: str, plain, launch, comp, length: int) -> torch.Tensor:
    """One decode-reduce call: counted under the work counter, the plain
    version for CPU operands, else ``launch``."""
    q, scale = comp["q"], comp["scale"]
    with kernel_call(f"{codec}_decode_reduce",
                     lambda: decode_cost(codec, comp, length), q, scale) as meta:
        if meta:
            lead = tuple(q.shape[:-2 if codec == "fp8" else -3])
            return torch.empty(lead + (int(length),), dtype=torch.float32,
                               device="meta")
        if not _on_card(q, scale):
            return plain(comp, length)
        return launch(comp, length)


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
    return _encode("int8", ref.int8_encode_feedback, _int8_encode_launch, x,
                   err)


def int8_encode_residual(x: torch.Tensor):
    """Encode ``x`` -> (wire form, round-trip residual); as above without
    the carried error."""
    return _encode("int8", ref.int8_encode_residual, _int8_encode_launch, x)


def int8_decode_reduce(comp, length: int) -> torch.Tensor:
    """Sum the ``(*B, W, nb, 256)`` int8 wire slices times their
    ``(*B, W, nb)`` scales over W -> ``(*B, length)`` f32 (at most one
    leading batch dim)."""
    return _decode("int8", ref.int8_decode_reduce, lambda c, n:
                   _block_decode_launch("codec_int8", "int8_decode_reduce",
                                        torch.int8, BLOCK, c, n, align=8),
                   comp, length)


# ---------------------------------------------------------------------------
# int4_block
# ---------------------------------------------------------------------------


def _int4_encode_launch(x, err):
    return _block_encode_launch("codec_int4", "int4_block_encode",
                                torch.uint8, BLOCK // 2, x, err)


def int4_encode_feedback(x: torch.Tensor, err: torch.Tensor):
    """Encode ``x + err``: ``(*B, L)`` f32 -> ({"q" (*B, nb, 128) uint8
    nibble pairs, "scale" (*B, nb) f32}, residual (*B, L) f32)."""
    return _encode("int4", ref.int4_encode_feedback, _int4_encode_launch, x,
                   err)


def int4_encode_residual(x: torch.Tensor):
    """Encode ``x`` -> (wire form, round-trip residual); as above without
    the carried error."""
    return _encode("int4", ref.int4_encode_residual, _int4_encode_launch, x)


def int4_decode_reduce(comp, length: int) -> torch.Tensor:
    """Sum the ``(*B, W, nb, 128)`` packed wire slices times their
    ``(*B, W, nb)`` scales over W -> ``(*B, length)`` f32 (at most one
    leading batch dim)."""
    return _decode("int4", ref.int4_decode_reduce, lambda c, n:
                   _block_decode_launch("codec_int4", "int4_decode_reduce",
                                        torch.uint8, BLOCK // 2, c, n),
                   comp, length)


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
        rc = _build.load("codec_fp8").codec_fp8_encode(
            x.data_ptr(), _ptr(err), q.data_ptr(), scale.data_ptr(),
            res.data_ptr(), S, L, _stream(x))
        _raise_on(rc, "codec_fp8", "fp8_encode")
        launches[_variant("fp8_encode", err)] += 1
    return {"q": q, "scale": scale}, res


def fp8_encode_plan(S: int, L: int, feedback: bool = False) -> dict:
    """How the fp8 encode kernel runs over aligned ``(S, L)`` operands on
    the current card: its thread-block cluster size, float4 a thread,
    whether it walks each row twice (rows longer than the cluster's
    registers hold), and ``cudaOccupancyMaxActiveClusters`` at that
    size."""
    out = (ctypes.c_int * 4)()
    rc = _build.load("codec_fp8").codec_fp8_encode_plan(
        int(S), int(L), int(feedback), 1, out)
    _raise_on(rc, "codec_fp8", "fp8_encode")
    return {"cluster": out[0], "vectors_per_thread": out[1],
            "walk": bool(out[2]), "max_active_clusters": out[3]}


def fp8_encode_feedback(x: torch.Tensor, err: torch.Tensor):
    """Encode ``x + err``: ``(*B, L)`` f32 -> ({"q" (*B, L) uint8 e4m3
    bits, "scale" (*B,) f32}, residual (*B, L) f32)."""
    return _encode("fp8", ref.fp8_encode_feedback, _fp8_encode_launch, x,
                   err)


def fp8_encode_residual(x: torch.Tensor):
    """Encode ``x`` -> (wire form, round-trip residual); as above without
    the carried error."""
    return _encode("fp8", ref.fp8_encode_residual, _fp8_encode_launch, x)


def fp8_decode_reduce(comp, length: int) -> torch.Tensor:
    """Sum the ``(*B, W, Lq)`` e4m3 wire slices times their ``(*B, W)``
    scales over W -> ``(*B, length)`` f32 (at most one leading batch
    dim). The kernel takes the wire at any address and any ``Lq``: it
    reads 8-byte vectors where ``q``'s address and ``Lq`` are multiples of
    8, single bytes elsewhere."""
    return _decode("fp8", ref.fp8_decode_reduce, _fp8_decode_launch, comp,
                   length)


def _fp8_decode_launch(comp, length: int) -> torch.Tensor:
    q, scale = comp["q"], comp["scale"]
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
