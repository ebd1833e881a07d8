"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel in ``kernels/csrc/`` computes,
with ordinary tensor ops: the codec kernels (``codec_{int8,int4,fp8}.cu``)
bitwise, the staging row moves :func:`shift_blocks` and :func:`pack_blocks`
(``staging.cu``) bitwise in every dtype, :func:`flash_decode`
(``flash_decode.cu``), :func:`rwkv6_wkv` (``rwkv6_wkv.cu``) and
:func:`mamba_scan` (``mamba_scan.cu``) up to the order of their fp32 sums,
:func:`adamw_update` (``adamw.cu``) bitwise. The wrappers in
``kernels/codec.py``, ``kernels/staging.py``, ``kernels/attention.py``,
``kernels/rwkv.py``, ``kernels/mamba.py`` and ``kernels/adamw.py`` use
these only for tensors on the CPU; the tests hold them against the
reference's Pallas kernels (interpret mode) or its AdamW, and
``chip_smoke.py`` and the ``cuda`` tests hold each kernel against them on
the card. :func:`flash_decode_split`,
:func:`rwkv6_wkv_chunked`, :func:`rwkv6_wkv_tick_lanes` and
:func:`mamba_scan_lanes` write out the algorithms of the split-S
flash-decode kernel, of the chunked WKV6 prefill kernel, of the WKV6 tick
kernel and of the lane-split scan kernel in plain PyTorch, for the tests;
no main path calls them.

Every codec function takes an optional leading rank dim: ``x`` is
``(S, L)`` or ``(R, S, L)``; wire leaves and outputs carry the same
leading dims.

Rounding contract shared with the kernels (see ``core/compress.py``):
the block codecs' scale is ``amax * f32(1/127)`` (int8) or ``amax *
f32(1/7)`` (int4) per 256-element block, fp8's ``max(amax * f32(1/448),
1e-30)`` per slice; quantization rounds half to even; the residual ``c -
q*scale`` and the decode accumulation ``acc + q*scale`` are each rounded
once (a fused multiply-add), accumulated over peers ``w = 0..W-1`` in order
from 0. Float64 holds each ``acc + q*scale`` exactly for payloads whose
peer terms lie within 2**29 of each other, so one cast back gives the fused
multiply-add's single rounding.

NaN: a NaN in a block (fp8: in a slice) makes its amax and scale NaN, so
the residual there and every decoded sum that includes it are NaN. Where
c / scale is NaN (that block, or a +-inf element against its infinite
scale) the kernels write the wire bytes of this version: int8 0, int4
nibble 8 (the int32 cast of NaN leaves a low nibble of 0), fp8 a NaN
byte. A NaN's payload bits are not part of the contract: the residual
here rounds a float64 NaN, the kernels' fused multiply-add a float32
one.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.compress import (_FP8_MAX, _FP8_TINY, _RECIP127,
                                       _RECIP448, _RECIP7, BLOCK, _blocks,
                                       _fma_residual, _quantize)


def _block_encode(c, recip: float, qmax: int):
    """Per-block quantization of ``c`` ``(*B, L)`` -> (q ``(*B, nb, 256)``
    float, scale ``(*B, nb)``, residual ``(*B, L)``)."""
    lead, L = tuple(c.shape[:-1]), c.shape[-1]
    blocks = _blocks(c.reshape(-1, L))
    q, scale = _quantize(blocks, recip, qmax)
    res = _fma_residual(blocks, q, scale[..., None])
    nb = blocks.shape[1]
    return (q.reshape(lead + (nb, BLOCK)), scale.reshape(lead + (nb,)),
            res.reshape(-1, nb * BLOCK)[:, :L].reshape(lead + (L,)))


def _encode(c):
    q, scale, res = _block_encode(c, _RECIP127, 127)
    return {"q": q.to(torch.int8), "scale": scale}, res


def int8_encode_feedback(x, err):
    """Encode ``x + err`` (float32 add) -> ({"q", "scale"}, residual)."""
    return _encode(x.float() + err.float())


def int8_encode_residual(x):
    """Encode ``x`` -> ({"q", "scale"}, residual)."""
    return _encode(x.float())


def _int4_encode(c):
    q, scale, res = _block_encode(c, _RECIP7, 7)
    pairs = (q.to(torch.int32) + 8).reshape(
        tuple(q.shape[:-1]) + (BLOCK // 2, 2))
    packed = (pairs[..., 0] | (pairs[..., 1] << 4)).to(torch.uint8)
    return {"q": packed, "scale": scale}, res


def int4_encode_feedback(x, err):
    """Encode ``x + err`` to int4 nibble pairs -> ({"q" ``(*B, nb, 128)``
    uint8, "scale" ``(*B, nb)``}, residual): ``q`` in [-7, 7] against
    ``blockmax * f32(1/7)``, stored +8, the even element in the low
    nibble."""
    return _int4_encode(x.float() + err.float())


def int4_encode_residual(x):
    """Encode ``x`` -> (wire form, residual); as above without the carried
    error."""
    return _int4_encode(x.float())


def _fp8_encode(c):
    scale = torch.clamp_min(c.abs().amax(dim=-1) * _RECIP448, _FP8_TINY)
    f8 = torch.clamp(c / scale[..., None], -_FP8_MAX, _FP8_MAX) \
        .to(torch.float8_e4m3fn)
    return ({"q": f8.view(torch.uint8), "scale": scale},
            _fma_residual(c, f8.float(), scale[..., None]))


def fp8_encode_feedback(x, err):
    """Encode ``x + err`` as e4m3 against a per-slice scale -> ({"q"
    ``(*B, L)`` uint8 (the e4m3 bits), "scale" ``(*B,)``}, residual). The
    cast rounds half to even and saturates at +-448."""
    return _fp8_encode(x.float() + err.float())


def fp8_encode_residual(x):
    """Encode ``x`` -> (wire form, residual); as above without the carried
    error."""
    return _fp8_encode(x.float())


def _accumulate(terms, length: int):
    """``acc = acc + t_w`` over the float64 peer terms in order, from a
    float32 0.0 (so a -0.0 term sums to +0.0), each step rounded once (see
    the module note) -> ``(*B, length)``."""
    acc = None
    for t in terms:
        if acc is None:
            acc = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        acc = (acc.double() + t).float()
    return acc[..., :length]


def int8_decode_reduce(comp, length: int):
    """Sum over the peer axis W of ``q * scale``: ``q`` is
    ``(*B, W, nb, 256)`` int8, ``scale`` ``(*B, W, nb)`` -> ``(*B, length)``
    float32."""
    q, scale = comp["q"], comp["scale"]
    W, nb = scale.shape[-2:]
    return _accumulate(
        ((q[..., w, :, :].double().flatten(-2)
          * scale[..., w, :].double().repeat_interleave(BLOCK, dim=-1))
         for w in range(W)), length)


def _int4_unpack(packed):
    """``(..., 128)`` uint8 nibble pairs -> ``(..., 256)`` int32 in
    [-8, 7], even element from the low nibble."""
    b = packed.to(torch.int32)
    return torch.stack([(b & 0xF) - 8, (b >> 4) - 8], dim=-1).flatten(-2)


def int4_decode_reduce(comp, length: int):
    """Sum over the peer axis W of the unpacked ``q * scale``: ``q`` is
    ``(*B, W, nb, 128)`` uint8, ``scale`` ``(*B, W, nb)`` ->
    ``(*B, length)`` float32."""
    q, scale = comp["q"], comp["scale"]
    W, nb = scale.shape[-2:]
    return _accumulate(
        ((_int4_unpack(q[..., w, :, :]).double().flatten(-2)
          * scale[..., w, :].double().repeat_interleave(BLOCK, dim=-1))
         for w in range(W)), length)


def fp8_decode_reduce(comp, length: int):
    """Sum over the peer axis W of the e4m3 values times their slice's
    scale: ``q`` is ``(*B, W, L)`` uint8, ``scale`` ``(*B, W)`` ->
    ``(*B, length)`` float32."""
    q, scale = comp["q"], comp["scale"]
    W = scale.shape[-1]
    return _accumulate(
        ((q[..., w, :].view(torch.float8_e4m3fn).double()
          * scale[..., w, None].double()) for w in range(W)), length)


#: the mask value of the Pallas flash-decode body
#: (``repro/kernels/flash_decode.py``)
NEG_INF = -1e30


def flash_decode(q, k, v, lengths):
    """One-token GQA attention, as the Pallas flash-decode body computes it:
    scores in fp32 from upcast ``q`` and ``k`` times ``1/sqrt(hd)``,
    positions at or beyond the row's length set to ``NEG_INF``, fp32
    softmax, fp32 ``p @ v`` (the probabilities are not cast to ``v``'s
    type), divided by ``max(l, 1e-30)``.

    q: ``(B, 1, H, hd)``; k, v: ``(B, S, KV, hd)`` with ``H = KV * G``
    (head ``h`` reads kv head ``h // G``); ``lengths``: a scalar or a
    ``(B,)`` count of valid positions per row. Returns ``(B, 1, H*hd)``
    float32. A row of length 0 or less masks every position, so, as in
    the Pallas body, it averages ``v`` over all ``S`` positions."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / hd ** 0.5
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    lengths = torch.as_tensor(lengths, device=q.device)
    if lengths.dim() == 0:
        lengths = lengths.expand(B)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float()) \
        / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, 1, H * hd)


def flash_decode_split(q, k, v, lengths, n_split: int):
    """:func:`flash_decode` as the split-S kernel computes it: split ``s``
    of ``n_split`` scores positions ``[s*span, (s+1)*span)`` of its row
    (``span = ceil(S / n_split)``), cut at the row's visited length
    (``min(len, S)`` for ``len > 0``, else ``S``), into a partial (``m``,
    ``l``, ``acc``): the running max from ``NEG_INF``, the sum of
    ``exp(score - m)`` and the fp32 ``p @ v``. A split with no visited
    position keeps ``m = NEG_INF``, ``l = 0``, ``acc = 0``. The combine
    takes ``M = max m_s`` and sums ``l_s * exp(m_s - M)`` and ``acc_s *
    exp(m_s - M)`` over the splits in order; the output is ``acc / max(l,
    1e-30)``. Same operands and result as :func:`flash_decode`."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    span = -(-S // n_split)
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (1.0 / hd ** 0.5)
    lengths = torch.as_tensor(lengths, device=q.device)
    if lengths.dim() == 0:
        lengths = lengths.expand(B)
    lengths = lengths.long()
    visit = torch.where(lengths > 0, lengths.clamp(max=S), S)
    pos = torch.arange(S, device=q.device)
    s = torch.where((pos[None, :] < lengths[:, None])[:, None, None, :], s,
                    NEG_INF)
    vf = v.float()
    m = torch.full((B, KV, G, 1), NEG_INF, device=q.device)
    parts = []
    for i in range(n_split):
        lo, hi = i * span, min((i + 1) * span, S)
        seen = ((pos[None, lo:hi] < visit[:, None])[:, None, None, :]
                if lo < hi else None)
        if seen is None or not bool(seen.any()):
            parts.append((torch.full_like(m, NEG_INF), torch.zeros_like(m),
                          torch.zeros((B, KV, G, hd), device=q.device)))
            continue
        si = torch.where(seen, s[..., lo:hi], -math.inf)
        mi = torch.maximum(si.amax(-1, keepdim=True), m)
        p = torch.where(seen, torch.exp(si - mi), 0.0)
        parts.append((mi, p.sum(-1, keepdim=True),
                      torch.einsum("bkgs,bskd->bkgd", p, vf[:, lo:hi])))
    M = torch.stack([mi for mi, _, _ in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, hd), device=q.device)
    for mi, li, ai in parts:
        e = torch.exp(mi - M)
        l = l + li * e
        acc = acc + ai * e
    return (acc / l.clamp_min(1e-30)).reshape(B, 1, H * hd)


def rwkv6_wkv(r, k, v, w, u, s0):
    """The WKV6 recurrence, as the Pallas body (``repro/kernels/
    rwkv6_wkv.py`` ``_kernel``) computes it, step by step in fp32: with
    ``S`` starting at ``s0``, for each ``t``

        kv = k_t[:, None] * v_t[None, :]
        y_t = ((S + u[:, None] * kv) * r_t[:, None]).sum over the rows
        S = w_t[:, None] * S + kv

    per batch row and head. r, k, v, w: ``(B, T, H, hd)`` (w is the decay,
    in (0, 1)); u: ``(H, hd)``; s0: ``(B, H, hd, hd)``. Any ``T``, 0
    included. Returns ``y (B, T, H, hd)`` and the final state ``(B, H, hd,
    hd)``, both float32 (the state a new tensor, never ``s0``)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[..., None]
    S = s0.to(torch.float32, copy=True)
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(((S + u * kv) * r[:, t, :, :, None]).sum(-2))
        S = w[:, t, :, :, None] * S + kv
    y = torch.stack(ys, 1) if ys else r.new_empty(r.shape)
    return y, S


def rwkv6_wkv_chunked(r, k, v, w, u, s0, chunk: int = 16):
    """:func:`rwkv6_wkv` in the chunked form of the prefill kernel
    (``rwkv6_wkv.cu``, ``wkv_chunk_intra`` then ``wkv_chunk_state``): for
    each run of ``chunk`` steps (the last one shorter) from the carried
    state ``S0``, with ``D_t = prod_{tau<=t} w_tau`` from the chunk's start
    and ``E_s = prod_{tau>s} w_tau`` to its end,

        y_t = (r_t * D_{t-1}) @ S0 + sum_{s<=t} A_ts v_s
        S   = D_last[:, None] * S0 + sum_s (k_s * E_s)[:, None] v_s[None, :]

    with ``A_ts = sum_i r_ti k_si prod_{s<tau<t} w_tau,i`` below the
    diagonal and ``A_tt = sum_i r_ti u_i k_ti``. Every decay is a product
    of decays, never a quotient or a difference of logarithms: a decay of
    0 or a subnormal one gives 0 or a tiny term, never inf or NaN, and
    nothing loses relative accuracy. ``A``'s products run from ``s``
    forward, one multiply per step, as the kernel's do. Operands and
    results as :func:`rwkv6_wkv`."""
    r, k, v, w = (t.float().transpose(1, 2) for t in (r, k, v, w))
    u = u.float()
    S = s0.to(torch.float32, copy=True)
    B, H, T, hd = r.shape
    y = r.new_empty((B, H, T, hd))
    for c0 in range(0, T, chunk):
        rc, kc, vc, wc = (t[:, :, c0:c0 + chunk] for t in (r, k, v, w))
        n = rc.shape[2]
        ones = torch.ones_like(wc[:, :, :1])
        D = torch.cumprod(torch.cat([ones, wc[:, :, :-1]], 2), 2)
        E = torch.cumprod(torch.cat([wc[:, :, 1:], ones], 2).flip(2),
                          2).flip(2)
        A = torch.zeros((B, H, n, n), device=r.device)
        X = kc.clone()  # X_s = k_s * prod_{s<tau<t} w_tau at step t
        for t in range(n):
            A[:, :, t, t] = (rc[:, :, t] * u * kc[:, :, t]).sum(-1)
            A[:, :, t, :t] = torch.einsum("bhi,bhsi->bhs", rc[:, :, t],
                                          X[:, :, :t])
            X[:, :, :t] = X[:, :, :t] * wc[:, :, t, None]
        y[:, :, c0:c0 + n] = torch.einsum("bhts,bhsj->bhtj", A, vc) \
            + torch.einsum("bhti,bhij->bhtj", rc * D, S)
        S = (D[:, :, -1] * wc[:, :, -1])[..., None] * S \
            + torch.einsum("bhsi,bhsj->bhij", kc * E, vc)
    return y.transpose(1, 2), S


def rwkv6_wkv_tick_lanes(r, k, v, w, u, s0):
    """:func:`rwkv6_wkv` in the tick kernel's order of operations
    (``rwkv6_wkv.cu``, ``rwkv6_wkv_tick_kernel``): hd padded with zeros to
    ``HD`` (32, 64 or 128), ``NW = HD / 8`` warps of 8 state rows, ``R =
    128 / HD`` rows per warp load; per (b, head) and step, in fp32,

        a   = lanes l < 32 each sum (r_i * u_i) * k_i over i = l + 32 m by
              fused multiply-adds in order of m, from 0; then for o = 16,
              8, 4, 2, 1: p_l = p_l + p_(l xor o); a = p_0
        p   = in warp x, row group g < R sums r_i * S_ij over i = 8 x + g
              + R m by fused multiply-adds in order of m, from 0; then for
              o = R / 2, ..., 1: p_g = p_g + p_(g xor o); p_x = p_0
        y_j = fma(v_j, a, s) with s = 0 + p_0 + p_1 + ... + p_(NW-1)
        S_ij = fma(w_i, S_ij, k_i * v_j)

    Same operands and results as :func:`rwkv6_wkv`, which the wrapper's CPU
    path keeps; this mirror is for the tests."""
    B, T, H, hd = r.shape
    HD = 32 if hd <= 32 else 64 if hd <= 64 else 128
    NW, R = HD // 8, 128 // HD
    pad = HD - hd
    r, k, v, w = (torch.nn.functional.pad(t.float(), (0, pad))
                  for t in (r, k, v, w))
    u = torch.nn.functional.pad(u.float(), (0, pad))
    S = torch.nn.functional.pad(s0.float(), (0, pad, 0, pad))
    lanes = torch.arange(32, device=r.device)
    groups = torch.arange(R, device=r.device)
    y = r.new_empty((B, T, H, HD))
    for t in range(T):
        rt, kt, vt, wt = (x[:, t] for x in (r, k, v, w))  # (B, H, HD)
        ru = rt * u
        p = torch.zeros((B, H, 32), dtype=torch.float32, device=r.device)
        for m in range(HD // 32):
            p = _fma32(ru[..., 32 * m:32 * m + 32],
                       kt[..., 32 * m:32 * m + 32], p)
        o = 16
        while o:
            p = p + p[..., lanes ^ o]
            o //= 2
        a = p[..., :1]
        # row 8 x + R m + g of the padded state is [x, m, g]
        Sw = S.reshape(B, H, NW, 8 // R, R, HD)
        rw = rt.reshape(B, H, NW, 8 // R, R, 1)
        q = torch.zeros((B, H, NW, R, HD), dtype=torch.float32,
                        device=r.device)
        for m in range(8 // R):
            q = _fma32(rw[:, :, :, m], Sw[:, :, :, m], q)
        o = R // 2
        while o:
            q = q + q[:, :, :, groups ^ o]
            o //= 2
        s = torch.zeros((B, H, HD), dtype=torch.float32, device=r.device)
        for x in range(NW):
            s = s + q[:, :, x, 0]
        y[:, t] = _fma32(vt, a, s)
        S = _fma32(wt[..., None], S, kt[..., None] * vt[..., None, :])
    return y[..., :hd].contiguous(), S[..., :hd, :hd].contiguous()


def mamba_scan(dt, A, Bm, Cm, x, h0=None):
    """The selective SSM scan, as the reference's ``_scan_ref``
    (``repro/layers/mamba.py``) computes it, step by step in fp32: with
    ``h`` starting at ``h0`` (zeros without one), for each ``t``

        h = exp(dt_t[:, None] * A) * h + (dt_t * x_t)[:, None] * B_t[None, :]
        y_t = sum over n of h * C_t[None, :]

    per batch row. The discretisation ``exp(dt * A)`` is taken per step, so
    nothing of size ``(B, T, Di, N)`` is ever held. dt, x: ``(B, T, Di)``
    (x in any float type, upcast); Bm, Cm: ``(B, T, N)``; A: ``(Di, N)``;
    h0: ``(B, Di, N)``. Any ``T``, 0 included. Returns ``y (B, T, Di)`` and
    the final state ``(B, Di, N)``, both float32 (the state a new tensor,
    never ``h0``)."""
    B, T, Di = dt.shape
    dt, Bm, Cm, x = (t.float() for t in (dt, Bm, Cm, x))
    A = A.float()
    h = (torch.zeros((B, Di, A.shape[1]), dtype=torch.float32,
                     device=dt.device) if h0 is None
         else h0.to(torch.float32, copy=True))
    y = dt.new_empty((B, T, Di))
    for t in range(T):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = dA * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        y[:, t] = (h * Cm[:, t, None, :]).sum(-1)
    return y, h


#: log2(e); the scan kernel pre-scales A by it, rounded to float32
_LOG2E = math.log2(math.e)
#: the smallest normal float32: the scan kernel's exponential flushes a
#: smaller result to zero
_FTZ = 2.0 ** -126


def _fma32(a, b, c):
    """``a * b + c`` of float32 tensors rounded once to float32 (the
    product is exact in float64; the sum is rounded to float64 first, so
    rarely the result is one float32 ulp from a true fused multiply-add)."""
    return (a.double() * b.double() + c.double()).float()


def mamba_scan_lanes(dt, A, Bm, Cm, x, h0=None):
    """:func:`mamba_scan` as the redesigned kernel (``mamba_scan.cu``)
    computes it: the N states padded with zeros to ``NS`` (4, 8, 16 or
    32), a channel's states spread over ``LPC = NS / 4`` lanes, four each;
    per step

        dA = exp2(dt * A2)            A2 = A * float32(log2 e), fp32;
                                      a dA below 2**-126 flushed to 0
        h  = fma(dA, h, (dt * x) * B)
        p_l = fma chain over lane l's four states of h * C, from 0
        y  = the LPC partials p_l joined as the shuffle tree joins them:
             for o = LPC/2, ..., 1: p_l = p_l + p_(l xor o); y = p_0

    all in fp32. Same operands and results as :func:`mamba_scan`, which
    the wrapper's CPU path keeps; this mirror is for the tests."""
    B, T, Di = dt.shape
    N = A.shape[1]
    NS = 4
    while NS < N:
        NS *= 2
    lpc = NS // 4
    pad = (0, NS - N)
    dt, x = dt.float(), x.float()
    Bm, Cm = (torch.nn.functional.pad(t.float(), pad) for t in (Bm, Cm))
    A2 = torch.nn.functional.pad(
        A.float() * torch.tensor(_LOG2E, dtype=torch.float32), pad)
    h = (torch.zeros((B, Di, NS), dtype=torch.float32, device=dt.device)
         if h0 is None else torch.nn.functional.pad(h0.float(), pad))
    lanes = torch.arange(lpc, device=dt.device)
    y = dt.new_empty((B, T, Di))
    for t in range(T):
        dA = torch.exp2(dt[:, t, :, None] * A2)
        dA = torch.where(dA < _FTZ, 0.0, dA)
        h = _fma32(dA, h, (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None])
        hl = h.reshape(B, Di, lpc, 4)
        cl = Cm[:, t].reshape(B, 1, lpc, 4)
        part = torch.zeros((B, Di, lpc), dtype=torch.float32,
                           device=dt.device)
        for i in range(4):
            part = _fma32(hl[..., i], cl[..., i], part)
        o = lpc // 2
        while o:
            part = part + part[..., lanes ^ o]
            o //= 2
        y[:, t] = part[..., 0]
    return y, h[..., :N].contiguous()


# ---------------------------------------------------------------------------
# the staging row moves (staging.cu): index gathers, every bit kept
# ---------------------------------------------------------------------------


def _byte_rows(x, lead: int):
    """``x``'s rows (its dims past ``lead``) as rows of bytes, ``(*lead,
    row bytes)`` uint8: a gather of bytes moves every dtype alike, on any
    device."""
    rows = x.reshape(tuple(x.shape[:lead]) + (-1,))
    if rows.stride(-1) != 1:  # a strided or expanded row: copy it
        rows = rows.clone(memory_format=torch.contiguous_format)
    return rows.view(torch.uint8)


def shift_blocks(v, shift):
    """The reference's ``roll(v, shift, 0)`` for every rank at once: ``v``
    ``(R, K, ...)``, ``shift`` ``(R,)`` integers; row ``k`` of rank ``r`` of
    the result is ``v[r, (k - shift[r]) mod K]``. Returns a new tensor."""
    R, K = v.shape[0], v.shape[1]
    if shift.shape != (R,):
        raise ValueError(f"shift_blocks: shift {tuple(shift.shape)} for "
                         f"{R} ranks")
    if v.numel() == 0:
        return v.new_empty(v.shape)
    k = torch.arange(K, device=v.device)
    return pack_blocks(v, (k[None, :] - shift.to(
        device=v.device, dtype=torch.long)[:, None]) % K)


def pack_blocks(src, idx):
    """A row gather, ``src[idx]``, where an index outside ``[0, N)`` (a
    negative one: no row) gives a zero row. Two forms:

      * flat, ``idx`` ``(K,)``: ``src`` ``(N, ...)``, the reference's form
        (``out[j] = src[idx[j]]``);
      * per rank, ``idx`` ``(R, J)``: ``src`` ``(R, N, ...)``, ``out[r, j] =
        src[r, idx[r, j]]``.

    Returns a new tensor ``(K, ...)`` or ``(R, J, ...)``; a zero row holds
    +0 bits in every dtype, as a fresh ``zeros`` tensor does."""
    idx = idx.to(device=src.device, dtype=torch.long)
    lead = idx.dim()
    if lead == 2 and src.shape[0] != idx.shape[0]:
        raise ValueError(f"pack_blocks: idx {tuple(idx.shape)} for "
                         f"{src.shape[0]} ranks")
    if lead not in (1, 2):
        raise ValueError(f"pack_blocks: idx must be (K,) or (R, J), got "
                         f"{tuple(idx.shape)}")
    N = src.shape[lead - 1]
    out_shape = tuple(idx.shape) + tuple(src.shape[lead:])
    if math.prod(out_shape) == 0:
        return src.new_empty(out_shape)
    if N == 0:
        return src.new_zeros(out_shape)
    keep = (idx >= 0) & (idx < N)
    at = idx.clamp(0, N - 1)
    rows = _byte_rows(src, lead)
    if lead == 1:
        rows = rows[at]
    else:
        rows = rows[torch.arange(idx.shape[0], device=src.device)[:, None],
                    at]
    if not bool(keep.all()):
        rows[~keep] = 0
    return rows.view(src.dtype).reshape(out_shape)


#: elements of one piece of :func:`adamw_update`'s passes
ADAMW_CHUNK = 1 << 24


def adamw_update(params, grads: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, master, scale: torch.Tensor, h,
                 decay) -> None:
    """One AdamW step in place (``adamw.cu``): ``grads`` scaled in place by
    the clip's 0-d ``scale``, then ``m``, ``v``, ``master`` (or None) and
    the weights of ``params`` (a ``FlatParams``) updated leaf by leaf in
    pieces of at most :data:`ADAMW_CHUNK` elements, so the float32
    temporaries are a piece's, not the buffer's; ``h`` holds the step's
    ``lr``, ``b1``, ``b2``, ``eps``, ``weight_decay`` and the bias
    corrections ``bc1``, ``bc2``; ``decay`` says per leaf of
    ``params.spans`` whether it decays. Every element goes through the same
    operations in the same order whatever the pieces, so the bits do not
    depend on them."""
    grads = grads.float().mul_(scale)
    b1, b2 = h.b1, h.b2
    for (_, s, e, _), dec in zip(params.spans, decay):
        for a in range(s, e, ADAMW_CHUNK):
            b = min(e, a + ADAMW_CHUNK)
            g = grads[a:b]
            m_, v_ = m[a:b], v[a:b]
            m_.mul_(b1).add_(g * (1 - b1))
            v_.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            base = master[a:b] if master is not None else \
                params.read_range(a, b)
            u = (m_ / h.bc1).div_(torch.sqrt(v_ / h.bc2).add_(h.eps))
            if dec:
                u.add_(base * h.weight_decay)
            # the master in place, or a fresh float32 copy of the piece
            params.assign_range(a, b, base.sub_(u.mul_(h.lr)))
