"""Error-bounded compression codecs for collective payloads (port of
``repro.core.compress``).

A registry of codecs (:func:`codec`, :func:`codecs`, :func:`register`),
each with ``encode``/``decode`` over ``(S, L)`` slice batches, error
feedback (:meth:`Codec.encode_with_feedback`), the residual-producing
encode and the fused decode+reduce of the compressed-collective hot path,
and :class:`CodecMeta` — wire ratio, flop cost and the stated
relative-error bound the selector checks against ``error_budget``. At the
end, the int8 tree codecs (``quantize``, ``compress_tree``, ...) that
``optim/compress.py`` re-exports.

  ===========  =========  ============  =====================================
  name         ratio      error bound   mechanism
  ===========  =========  ============  =====================================
  none         1.0x       0.0           identity (lossless)
  int8_block   ~3.9x      0.5/127       int8 blocks + per-256-block fp32 scale
  int4_block   ~7.8x      0.5/7         int4 nibble pairs packed two-per-byte
                                        + per-256-block fp32 scale
  fp8_sim      ~4.0x      2^-4          e4m3 cast against a per-slice scale
  topk         ~8.0x      1.0           keep the top 1/16 by magnitude
  zlib_sim     ~2x (meas) 0.0 (int)     per-slice int32 base + uint16 offsets;
                                        wire bytes measured by a byte-entropy
                                        / run-length stage
  ===========  =========  ============  =====================================

Wire forms are bitwise those of the reference's *jitted* jnp codecs. Two
places where eager PyTorch would differ are fixed on purpose:

  * **scales** multiply by the float32 reciprocal (``amax * f32(1/127)``):
    XLA rewrites a division by a constant into that multiply under ``jit``,
    and the interpret-mode Pallas body compiles to the same form;
  * **residuals** ``c - q*scale`` are rounded once, as the fused
    multiply-add XLA contracts them into (:func:`_fma_residual`); the
    product is exact in float64, so float64 arithmetic rounded to float32
    gives that single rounding.

Codecs whose meta sets ``fused=True`` (``int8_block``, ``int4_block``,
``fp8_sim``) route the hot-path methods through their registered lowering
in ``repro_torch.kernels.codec`` (the hand-written CUDA kernels, or their
plain versions for CPU tensors) while :func:`fused_enabled`; the
lowerings decode-reduce as the reference's kernels do, accumulating peer
by peer from 0 with single-rounding multiply-adds. :func:`reference_paths`
switches them off for A/B checks: the plain path decodes, then sums.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

#: quantization block length for the block codecs (elements per scale)
BLOCK = 256

#: density kept by the ``topk`` codec (fraction of elements per slice)
TOPK_DENSITY = 1.0 / 16.0

NONE = "none"

# float32 constants as exact Python floats, so no path re-rounds them
_RECIP127 = float(np.float32(1.0 / 127.0))
_RECIP7 = float(np.float32(1.0 / 7.0))
_RECIP448 = float(np.float32(1.0 / 448.0))
_TINY = float(np.float32(1e-12))
_FP8_TINY = float(np.float32(1e-30))


def _fma_residual(c: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """``c - q*scale`` rounded once to float32 (a fused multiply-add).

    ``q`` holds at most 8 significant bits and ``scale`` 24, so ``q*scale``
    is exact in float64, and so is the difference (both operands sit within
    a few binades of the block max). One rounding to float32 follows."""
    return (c.double() - q.double() * scale.double()).float()


# ---------------------------------------------------------------------------
# codec metadata + base class
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CodecMeta:
    """Selection-facing metadata for one codec (see the reference's
    ``CodecMeta``: wire ratio, modeled flops per element, stated
    elementwise error bound relative to the slice max, integer-only
    domain, fused lowering advertised, fused-path flops)."""

    name: str
    wire_ratio: float
    flops_per_elem: float
    error_bound: float
    integer_only: bool = False
    fused: bool = False
    fused_flops_per_elem: Optional[float] = None

    @property
    def lossless(self) -> bool:
        return self.error_bound == 0.0


# ---------------------------------------------------------------------------
# fused-lowering toggle (the A/B switch)
# ---------------------------------------------------------------------------

_FUSED_ENABLED = True


def fused_enabled() -> bool:
    """Whether registered fused lowerings are routed (module-level switch)."""
    return _FUSED_ENABLED


def set_fused(enabled: bool) -> bool:
    """Set the fused-lowering switch; returns the previous value."""
    global _FUSED_ENABLED
    prev = _FUSED_ENABLED
    _FUSED_ENABLED = bool(enabled)
    return prev


@contextlib.contextmanager
def reference_paths():
    """Force the plain codec paths (fusion off) inside the block; the
    runtime keys its caches on :func:`fused_enabled`."""
    prev = set_fused(False)
    try:
        yield
    finally:
        set_fused(prev)


class Codec:
    """Base codec: subclasses set ``meta`` and implement encode/decode.

    ``encode(x2d)``: ``(S, L)`` -> dict of tensors, leading dim S.
    ``decode(comp, length)``: inverse, -> ``(S, length)`` float32.
    ``slice_dims`` maps each wire leaf to its number of dims after S, so
    :meth:`decode_reduce` can find the peer axis under leading batch dims.
    """

    meta: CodecMeta
    slice_dims: Dict[str, int]

    def encode(self, x2d):
        raise NotImplementedError

    def decode(self, comp, length: int):
        raise NotImplementedError

    def residual(self, x2d, comp):
        """``x2d - decode(encode(x2d))`` for the wire form ``comp``."""
        return x2d - self.decode(comp, x2d.shape[-1])

    def _lowering(self):
        """The registered fused lowering, or None (plain path)."""
        if not (self.meta.fused and _FUSED_ENABLED):
            return None
        from repro_torch.kernels import codec as _kernels  # no import cycle
        return _kernels.lowering(self.meta.name)

    # -- error feedback -----------------------------------------------------

    def encode_with_feedback(self, x2d, err):
        """Encode ``x2d + err``; return (wire form, new feedback state)."""
        lw = self._lowering()
        if lw is not None:
            return lw.encode_feedback(x2d.float(), err)
        corrected = x2d.float() + err
        comp = self.encode(corrected)
        return comp, self.residual(corrected, comp)

    def encode_residual(self, x2d):
        """Encode ``x2d``; return (wire form, round-trip residual) — the
        encode sites of the compressed allreduce."""
        lw = self._lowering()
        if lw is not None:
            return lw.encode_residual(x2d.float())
        x2d = x2d.float()
        comp = self.encode(x2d)
        return comp, self.residual(x2d, comp)

    def decode_reduce(self, comp, length: int):
        """Decode a ``(*B, W, ...)`` wire form and sum over the peer axis W
        -> ``(*B, length)``."""
        lw = self._lowering()
        if lw is not None:
            return lw.decode_reduce(comp, length)
        k0 = next(iter(comp))
        lead = tuple(comp[k0].shape[:comp[k0].dim() - self.slice_dims[k0]])
        flat = {k: v.reshape((-1,) + tuple(v.shape[len(lead):]))
                for k, v in comp.items()}
        dec = self.decode(flat, length).reshape(lead + (length,))
        return dec.sum(dim=-2)

    def wire_bytes(self, comp) -> int:
        """Actual bytes of the wire form."""
        return sum(v.numel() * v.element_size() for v in comp.values())

    def achieved_ratio(self, x2d) -> float:
        """Measured compression ratio on one payload: float32 payload bytes
        over actual wire bytes of ``encode(x2d)`` (>= 1 means the codec
        shrinks the wire). Runs an encode (the fused one where registered,
        whose wire form is the plain one's), so callers sample it (the
        telemetry error-feedback probe) rather than calling it per
        collective."""
        x2d = torch.as_tensor(x2d).float()
        lw = self._lowering()
        comp = lw.encode_residual(x2d)[0] if lw is not None \
            else self.encode(x2d)
        return float(x2d.numel() * 4.0) / max(1, self.wire_bytes(comp))


# ---------------------------------------------------------------------------
# block codecs
# ---------------------------------------------------------------------------


def _blocks(x2d):
    """``(S, L)`` -> zero-padded ``(S, nb, BLOCK)`` float32 blocks."""
    S, L = x2d.shape
    nb = -(-L // BLOCK)
    padded = torch.nn.functional.pad(x2d.float(), (0, nb * BLOCK - L))
    return padded.reshape(S, nb, BLOCK)


def _quantize(blocks, recip: float, qmax: int):
    """Per-block scale ``amax * f32(1/qmax)`` and the clipped
    round-half-even quantization against it (clamped divisor)."""
    scale = blocks.abs().amax(dim=2) * recip
    q = torch.clamp(torch.round(
        blocks / torch.clamp_min(scale, _TINY)[..., None]), -qmax, qmax)
    return q, scale


class Int8BlockCodec(Codec):
    """Per-block int8 quantization: 256-element blocks, one fp32 scale each
    (stated bound 0.5/127; all-zero blocks get scale 0 and q 0)."""

    meta = CodecMeta("int8_block", wire_ratio=BLOCK * 4 / (BLOCK + 4.0),
                     flops_per_elem=3.0, error_bound=0.5 / 127.0,
                     fused=True, fused_flops_per_elem=1.5)
    slice_dims = {"q": 2, "scale": 1}

    def encode(self, x2d):
        q, scale = _quantize(_blocks(x2d), _RECIP127, 127)
        return {"q": q.to(torch.int8), "scale": scale}

    def decode(self, comp, length: int):
        q, scale = comp["q"], comp["scale"]
        deq = q.float() * scale[..., None]
        return deq.reshape(q.shape[0], -1)[:, :length]

    def residual(self, x2d, comp):
        S, L = x2d.shape
        r = _fma_residual(_blocks(x2d), comp["q"], comp["scale"][..., None])
        return r.reshape(S, -1)[:, :L]


class Int4BlockCodec(Codec):
    """Per-block int4 quantization against ``blockmax/7``, packed two per
    wire byte (+8 bias, even element in the low nibble); bound 0.5/7."""

    meta = CodecMeta("int4_block", wire_ratio=BLOCK * 4 / (BLOCK / 2 + 4.0),
                     flops_per_elem=4.0, error_bound=0.5 / 7.0,
                     fused=True, fused_flops_per_elem=2.0)
    slice_dims = {"q": 2, "scale": 1}

    def encode(self, x2d):
        q, scale = _quantize(_blocks(x2d), _RECIP7, 7)
        S, nb, _ = q.shape
        pairs = (q.to(torch.int32) + 8).reshape(S, nb, BLOCK // 2, 2)
        packed = (pairs[..., 0] | (pairs[..., 1] << 4)).to(torch.uint8)
        return {"q": packed, "scale": scale}

    @staticmethod
    def _unpack(packed):
        b = packed.to(torch.int32)
        q = torch.stack([(b & 0xF) - 8, (b >> 4) - 8], dim=-1)
        return q.reshape(packed.shape[0], packed.shape[1], BLOCK)

    def decode(self, comp, length: int):
        q = self._unpack(comp["q"])
        deq = q.float() * comp["scale"][..., None]
        return deq.reshape(q.shape[0], -1)[:, :length]

    def residual(self, x2d, comp):
        S, L = x2d.shape
        r = _fma_residual(_blocks(x2d), self._unpack(comp["q"]),
                          comp["scale"][..., None])
        return r.reshape(S, -1)[:, :L]


_FP8_MAX = 448.0  # e4m3 finite max
_HAVE_FP8 = hasattr(torch, "float8_e4m3fn")


class Fp8SimCodec(Codec):
    """e4m3 cast against a per-slice scale ``amax/448`` (bound 2^-4); the
    wire carries the fp8 payload bitcast to uint8 plus one fp32 scale."""

    meta = CodecMeta("fp8_sim",
                     wire_ratio=4.0 * (1.0 - 1e-3) if _HAVE_FP8 else 1.0,
                     flops_per_elem=2.0, error_bound=2.0 ** -4,
                     fused=_HAVE_FP8, fused_flops_per_elem=1.0)
    slice_dims = {"q": 1, "scale": 0}

    def encode(self, x2d):
        if not _HAVE_FP8:
            raise NotImplementedError("fp8_sim needs torch.float8_e4m3fn")
        x2d = x2d.float()
        scale = torch.clamp_min(x2d.abs().amax(dim=1) * _RECIP448,
                                _FP8_TINY)
        q = torch.clamp(x2d / scale[:, None], -_FP8_MAX, _FP8_MAX)
        return {"q": q.to(torch.float8_e4m3fn).view(torch.uint8),
                "scale": scale}

    def decode(self, comp, length: int):
        q = comp["q"].view(torch.float8_e4m3fn).float()
        return q[:, :length] * comp["scale"][:, None]

    def residual(self, x2d, comp):
        q = comp["q"].view(torch.float8_e4m3fn).float()
        return _fma_residual(x2d, q, comp["scale"][:, None])


class TopKCodec(Codec):
    """Keep the ``TOPK_DENSITY`` largest-magnitude elements per slice
    (stated bound 1.0). ``torch.topk`` and ``lax.top_k`` may order equal
    magnitudes differently, so wire forms agree on tie-free payloads; on
    ties the kept set may differ and so may the residual."""

    meta = CodecMeta("topk", wire_ratio=1.0 / (2.0 * TOPK_DENSITY),
                     flops_per_elem=6.0, error_bound=1.0)
    slice_dims = {"v": 1, "i": 1}

    def encode(self, x2d):
        x2d = x2d.float()
        k = max(1, int(math.ceil(x2d.shape[1] * TOPK_DENSITY)))
        idx = torch.topk(x2d.abs(), k, dim=1, sorted=True).indices
        return {"v": torch.gather(x2d, 1, idx), "i": idx.to(torch.int32)}

    def decode(self, comp, length: int):
        vals, idx = comp["v"], comp["i"]
        out = torch.zeros((vals.shape[0], length), dtype=torch.float32,
                          device=vals.device)
        return out.scatter(1, idx.long(), vals)


class NoneCodec(Codec):
    """Identity: the ``codec`` plan dimension's lossless value."""

    meta = CodecMeta(NONE, wire_ratio=1.0, flops_per_elem=0.0,
                     error_bound=0.0)
    slice_dims = {"x": 1}

    def encode(self, x2d):
        return {"x": x2d.float()}

    def decode(self, comp, length: int):
        return comp["x"][:, :length]


# ---------------------------------------------------------------------------
# lossless integer bit-width packing (zlib_sim)
# ---------------------------------------------------------------------------


def _entropy_wire_bytes(raw: np.ndarray) -> int:
    """Measured byte estimate for one packed byte stream: the better of an
    order-0 entropy coder and a run-length coder, never above raw."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    n = int(raw.size)
    if n == 0:
        return 0
    hist = np.bincount(raw, minlength=256).astype(np.float64)
    p = hist[hist > 0] / n
    entropy_bits = float(-(p * np.log2(p)).sum())
    entropy_bytes = int(math.ceil(n * entropy_bits / 8.0))
    runs = int(1 + np.count_nonzero(raw[1:] != raw[:-1]))
    rle_bytes = 2 * runs
    return max(1, min(n, entropy_bytes, rle_bytes))


class ZlibSimCodec(Codec):
    """Lossless bit-width packing for small-range integer payloads: per
    slice one int32 ``base`` (the slice min) plus uint16 offsets. Exact iff
    every slice's range fits 16 bits; integer payloads on non-reducing
    collectives only (:func:`admissible`). Wire bytes are measured."""

    meta = CodecMeta("zlib_sim", wire_ratio=2.0 * (1.0 - 1e-3),
                     flops_per_elem=2.0, error_bound=0.0, integer_only=True)
    slice_dims = {"lo": 1, "base": 0}

    def __init__(self):
        ids = (np.arange(4096, dtype=np.int64) * 2654435761) % 50257
        self.meta = dataclasses.replace(
            type(self).meta,
            wire_ratio=self._measured_ratio_np(ids.astype(np.int32)
                                               .reshape(1, -1)))

    @staticmethod
    def _measured_ratio_np(v2d: np.ndarray) -> float:
        base = v2d.min(axis=1, keepdims=True)
        lo = (v2d - base).astype(np.uint16)
        wire = _entropy_wire_bytes(lo.view(np.uint8)) + 4 * v2d.shape[0]
        return float(v2d.size * 4.0 / wire)

    def wire_bytes(self, comp) -> int:
        lo = comp["lo"].cpu().numpy().astype(np.uint16)
        return _entropy_wire_bytes(lo.view(np.uint8)) + 4 * comp["base"].numel()

    def refresh_ratio(self, x2d) -> float:
        """Re-measure ``meta.wire_ratio`` on a sample payload."""
        v = torch.as_tensor(x2d).cpu().numpy().astype(np.int32)
        if v.ndim == 1:
            v = v.reshape(1, -1)
        ratio = self._measured_ratio_np(v)
        self.meta = dataclasses.replace(self.meta, wire_ratio=ratio)
        return ratio

    def encode(self, x2d):
        v = x2d.to(torch.int32)
        base = v.amin(dim=1)
        # int32 -> uint16 wraps modulo 2**16, as the reference's astype does
        lo = (v - base[:, None]).to(torch.int64).remainder(1 << 16) \
            .to(torch.uint16)
        return {"lo": lo, "base": base}

    def decode(self, comp, length: int):
        lo, base = comp["lo"], comp["base"]
        return (base[:, None] + lo.to(torch.int32))[:, :length]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Codec] = {}


def register(c: Codec) -> Codec:
    _REGISTRY[c.meta.name] = c
    return c


register(NoneCodec())
register(Int8BlockCodec())
register(Int4BlockCodec())
register(Fp8SimCodec())
register(TopKCodec())
register(ZlibSimCodec())


def codecs() -> Tuple[str, ...]:
    """All registered codec names, ``"none"`` first, rest sorted."""
    rest = sorted(n for n in _REGISTRY if n != NONE)
    return (NONE, *rest)


def lossy() -> Tuple[str, ...]:
    """Registered lossy codec names (sorted)."""
    return tuple(n for n in codecs() if not _REGISTRY[n].meta.lossless)


def codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; one of {codecs()}") \
            from None


def meta(name: str) -> CodecMeta:
    return codec(name).meta


def fused_codecs() -> Tuple[str, ...]:
    """Registered codec names advertising fused lowerings."""
    return tuple(n for n in codecs() if _REGISTRY[n].meta.fused)


def effective_flops_per_elem(name: str) -> float:
    """Per-element codec work the cost model prices right now: the fused
    figure when the codec advertises fusion and fusion is enabled."""
    m = meta(name)
    if m.fused and _FUSED_ENABLED and m.fused_flops_per_elem is not None:
        return m.fused_flops_per_elem
    return m.flops_per_elem


#: collectives that sum payloads in wire form mid-flight — integer-only
#: codecs can't ride them (their wire form is not additive)
REDUCING = frozenset({"allreduce", "reduce_scatter"})


def admissible(name: str, collective, error_budget: float,
               integer_payload: bool = False) -> bool:
    """Whether one codec may carry one payload under one error budget: the
    stated bound fits the budget; an integer-only codec needs an integer
    payload and a non-reducing collective (``collective=None`` skips that
    check); a lossy codec never touches an integer payload."""
    m = meta(name)
    if m.error_bound > float(error_budget):
        return False
    if m.integer_only:
        return bool(integer_payload) and (collective is None
                                          or collective not in REDUCING)
    return m.lossless or not integer_payload


def for_budget(error_budget: float, collective=None,
               integer_payload: bool = False) -> Tuple[str, ...]:
    """Codec names admissible under ``error_budget`` (see
    :func:`admissible`)."""
    return tuple(n for n in codecs()
                 if admissible(n, collective, error_budget, integer_payload))


def collective_tolerance(name: str, collective: str, world: int,
                         max_abs: float) -> float:
    """Absolute error tolerance for one compressed collective result:
    ``eps * factor * max_abs`` with factor 1 for allgather / alltoall /
    broadcast / scatter, ``world`` for reduce_scatter and ``2 * world`` for
    allreduce (sender residuals sum over ``world`` contributions plus one
    requantization). ``max_abs`` is the input payload's max-abs; lossless
    codecs return 0."""
    eps = meta(name).error_bound
    if eps == 0.0:
        return 0.0
    factor = {"allgather": 1.0, "alltoall": 1.0,
              "broadcast": 1.0, "scatter": 1.0,
              "reduce_scatter": float(world),
              "allreduce": 2.0 * float(world)}.get(collective)
    if factor is None:
        raise ValueError(f"no compressed execution for {collective!r}")
    return eps * factor * float(max_abs)


# ---------------------------------------------------------------------------
# int8 tree-level helpers (the reference's ``optim.compress`` API, adapters
# over the registered int8 codec: one error-feedback code path)
# ---------------------------------------------------------------------------


def _flatten(tree):
    """``(leaves, spec)`` of a tree of tensors: dicts (keys in sorted
    order, as ``jax.tree_util`` visits them), lists and tuples."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, specs = [], []
        for k in keys:
            ls, sp = _flatten(tree[k])
            leaves += ls
            specs.append(sp)
        return leaves, ("dict", keys, specs)
    if isinstance(tree, (list, tuple)):
        leaves, specs = [], []
        for t in tree:
            ls, sp = _flatten(t)
            leaves += ls
            specs.append(sp)
        return leaves, (type(tree).__name__, None, specs)
    return [tree], None


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return next(it)
        kind, keys, specs = sp
        vals = [build(s) for s in specs]
        if kind == "dict":
            return dict(zip(keys, vals))
        return tuple(vals) if kind == "tuple" else vals
    return build(spec)


def quantize(x):
    """x: float tensor -> (int8 blocks ``(nb, BLOCK)``, float32 per-block
    scales ``(nb,)``): the flat face of the int8 codec."""
    comp = codec("int8_block").encode(torch.as_tensor(x).reshape(1, -1))
    return comp["q"][0], comp["scale"][0]


def dequantize(q, scale, shape):
    n = math.prod(shape)
    return codec("int8_block").decode(
        {"q": q[None], "scale": scale[None]}, n)[0].reshape(shape)


def init_error_state(grads):
    """Zero float32 error-feedback state matching a gradient tree."""
    leaves, spec = _flatten(grads)
    return _unflatten(spec, [torch.zeros(g.shape, dtype=torch.float32,
                                         device=g.device) for g in leaves])


def compress_tree(grads, error_state):
    """Quantize every leaf after adding its carried error feedback.

    Returns ``((qs, scales, spec), new_error_state)``. Each leaf rides
    :meth:`Codec.encode_with_feedback` of the int8 codec as one ``(1, n)``
    row: on the card the ``int8_encode_feedback`` kernel, one launch per
    leaf."""
    leaves, spec = _flatten(grads)
    errs, _ = _flatten(error_state)
    qs, scales, new_err = [], [], []
    cd = codec("int8_block")
    for g, e in zip(leaves, errs):
        comp, resid = cd.encode_with_feedback(g.reshape(1, -1),
                                              e.reshape(1, -1))
        qs.append(comp["q"][0])
        scales.append(comp["scale"][0])
        new_err.append(resid[0].reshape(g.shape))
    return (qs, scales, spec), _unflatten(spec, new_err)


def decompress_tree(compressed, shapes_like):
    qs, scales, spec = compressed
    shapes = [tuple(t.shape) for t in _flatten(shapes_like)[0]]
    return _unflatten(spec, [dequantize(q, s, shp)
                             for q, s, shp in zip(qs, scales, shapes)])


def wire_bytes(compressed) -> int:
    qs, scales, _ = compressed
    cd = codec("int8_block")
    return sum(cd.wire_bytes({"q": q, "scale": s})
               for q, s in zip(qs, scales))
