"""Grouped-query attention with RoPE or M-RoPE, a KV cache, the
encoder's bidirectional and the decoder's cross attention, and the
flash-decode path of the serving tick (port of
``repro.layers.attention``).

Heads are laid out ``(kv-major, group-minor)``: query head ``h`` reads kv
head ``h // G``. Scores and softmax are fp32 from bf16 operands, as the
reference's ``preferred_element_type=float32`` einsums compute them.

Unlike the reference's immutable arrays, a cache passed to
:meth:`Attention.forward` is written in place (prefill fills its first
``T`` positions, a decode step its rows at the write offsets), and the
same dict is returned as the new cache: the serving engine holds one KV
buffer per layer for its whole life.

Not ported yet: ``cache_pspec``/``logical_axes`` (with sharding).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import attention as kattn
from repro_torch.layers import common
from repro_torch.layers.common import Accum, Compute

Index = Union[int, torch.Tensor]

#: T*S above STREAMING_THRESHOLD**2 switches prefill to streaming attention
STREAMING_THRESHOLD = 2048


def init_cache(cfg, batch: int, max_len: int, dtype=Compute, device="cuda"
               ) -> Dict[str, torch.Tensor]:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, KV, hd), dtype=dtype,
                             device=device)}


def _is_vector(index: Index) -> bool:
    return torch.is_tensor(index) and index.dim() > 0


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,T,H,hd), k: (B,S,KV,hd) -> (B,KV,G,T,S) fp32."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    return torch.einsum("btkgd,bskd->bkgts", qg.to(Accum),
                        k.to(Accum)) / (hd ** 0.5)


def _gqa_out(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w: (B,KV,G,T,S) fp32 probs, v: (B,S,KV,hd) -> (B,T,H*hd) fp32; the
    probabilities are cast to ``v``'s type first, as the reference does."""
    B, KV, G, T, S = w.shape
    o = torch.einsum("bkgts,bskd->btkgd", w.to(v.dtype).to(Accum),
                     v.to(Accum))
    return o.reshape(B, T, KV * G * v.shape[-1])


def attend_full(q, k, v, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Full-materialization attention (fp32 softmax): the oracle for the
    streaming and flash-decode paths."""
    s = _gqa_scores(q, k)
    T, S = s.shape[-2], s.shape[-1]
    if causal:
        qpos = torch.arange(T, device=q.device)[:, None] + q_offset
        kpos = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    return _gqa_out(torch.softmax(s, dim=-1), v)


def _streaming_fwd(q, k, v, causal: bool, q_chunk: int, kv_chunk: int,
                   q_offset: int):
    """The online-softmax forward: ``(out (B, T, H*hd) fp32, lse (B, KV, G,
    T) fp32)``, the log-sum-exp the backward recomputes the tiles from."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    outs, lses = [], []
    for qi in range(T // q_chunk):
        qb = q[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(
            B, q_chunk, KV, G, hd).to(Accum)
        m = torch.full((B, KV, G, q_chunk), float("-inf"), device=dev)
        l = torch.zeros((B, KV, G, q_chunk), device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, hd), device=dev)
        for ki in range(S // kv_chunk):
            kb = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vb = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb.to(Accum)) * scale
            if causal:
                s = s.masked_fill(_future(qi, q_chunk, ki, kv_chunk,
                                          q_offset, dev), float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            # guard fully-masked rows (m_new = -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vb.dtype).to(Accum),
                vb.to(Accum))
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])  # (B,KV,G,qc,hd)
        lses.append(torch.where(torch.isfinite(m), m, 0.0)
                    + torch.log(l.clamp_min(1e-30)))      # (B,KV,G,qc)
    out = torch.stack(outs, dim=0)                         # (nq,B,KV,G,qc,hd)
    return (out.permute(1, 0, 4, 2, 3, 5).reshape(B, T, H * hd),
            torch.cat(lses, dim=-1))


def _future(qi: int, qc: int, ki: int, kc: int, q_offset: int, dev
            ) -> torch.Tensor:
    """(qc, kc) mask of the tile's key positions after its query's."""
    qpos = qi * qc + torch.arange(qc, device=dev)[:, None] + q_offset
    kpos = ki * kc + torch.arange(kc, device=dev)[None, :]
    return kpos > qpos


class _Streaming(torch.autograd.Function):
    """Online-softmax attention with the Dao backward (the reference's
    ``custom_vjp``): the forward saves only q, k, v, out and the
    log-sum-exp; the backward recomputes the probability tiles from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, q_offset):
        out, lse = _streaming_fwd(q, k, v, causal, q_chunk, kv_chunk,
                                  q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_chunk, kv_chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, qc, kc, q_offset = ctx.args
        B, T, H, hd = q.shape
        S, KV = k.shape[1], k.shape[2]
        G = H // KV
        scale = 1.0 / (hd ** 0.5)
        dev = q.device
        do = dout.reshape(B, T, KV, G, hd).to(Accum)
        # delta[t] = sum_d do * out  (B, KV, G, T)
        delta = torch.einsum("btkgd,btkgd->bkgt", do,
                             out.reshape(B, T, KV, G, hd).to(Accum))
        dq = torch.zeros((B, T, KV, G, hd), dtype=Accum, device=dev)
        dks, dvs = [], []
        for ki in range(S // kc):
            # outer loop over KV chunks carries dq; the inner one over Q
            # chunks gives this chunk's dk and dv
            kb = k[:, ki * kc:(ki + 1) * kc]
            vb = v[:, ki * kc:(ki + 1) * kc]
            kb32, vb32 = kb.to(Accum), vb.to(Accum)
            dk = torch.zeros((B, kc, KV, hd), dtype=Accum, device=dev)
            dv = torch.zeros((B, kc, KV, hd), dtype=Accum, device=dev)
            for qi in range(T // qc):
                rows = slice(qi * qc, (qi + 1) * qc)
                qb = q[:, rows].reshape(B, qc, KV, G, hd).to(Accum)
                dob = do[:, rows]
                s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb32) * scale
                if causal:
                    s = s.masked_fill(_future(qi, qc, ki, kc, q_offset, dev),
                                      float("-inf"))
                p = torch.exp(s - lse[..., rows, None])
                p = torch.where(torch.isfinite(s), p, 0.0)  # (B,KV,G,qc,kc)
                dv = dv + torch.einsum("bkgqs,bqkgd->bskd",
                                       p.to(v.dtype).to(Accum), dob)
                dp = torch.einsum("bqkgd,bskd->bkgqs", dob, vb32)
                ds = p * (dp - delta[..., rows, None]) * scale
                dsb = ds.to(k.dtype).to(Accum)
                dq[:, rows] += torch.einsum("bkgqs,bskd->bqkgd", dsb, kb32)
                dk = dk + torch.einsum("bkgqs,bqkgd->bskd", dsb, qb)
            dks.append(dk)
            dvs.append(dv)
        return (dq.reshape(B, T, H, hd).to(q.dtype),
                torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype),
                None, None, None, None)


def attend_streaming(q, k, v, causal: bool, q_chunk: int = 512,
                     kv_chunk: int = 1024, q_offset: int = 0
                     ) -> torch.Tensor:
    """Online-softmax attention over query and KV chunks, so the score
    matrix never materializes, forward and backward (the backward
    recomputes the probability tiles from the saved log-sum-exp: only q,
    k, v, out and the log-sum-exp are kept). q: (B,T,H,hd); k, v:
    (B,S,KV,hd). Falls back to :func:`attend_full` under plain autograd
    when the chunks do not divide T and S, as the reference does."""
    T, S = q.shape[1], k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, T), min(kv_chunk, S)
    if T % q_chunk or S % kv_chunk:
        return attend_full(q, k, v, causal, q_offset)
    return _Streaming.apply(q, k, v, causal, q_chunk, kv_chunk, q_offset)


def attend_decode(q, cache_k, cache_v, cur_index: Index,
                  use_kernel: bool = False) -> torch.Tensor:
    """One-token decode against a KV cache. q: (B,1,H,hd); cache:
    (B,S,KV,hd); ``cur_index`` counts the valid positions (the new token is
    already written at ``cur_index - 1``): a scalar, or a ``(B,)`` vector
    of per-row counts (continuous batching). ``use_kernel`` goes through
    the flash-decode kernel wrapper for scalar and vector counts alike (the
    reference's kernel takes only a scalar)."""
    if use_kernel:
        return kattn.flash_decode(q, cache_k, cache_v, cur_index)
    s = _gqa_scores(q, cache_k)  # (B,KV,G,1,S)
    S = s.shape[-1]
    pos = torch.arange(S, device=q.device)
    if _is_vector(cur_index):
        valid = pos[None, :] < cur_index[:, None]
    else:
        valid = (pos < cur_index)[None, :]
    s = s.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    return _gqa_out(torch.softmax(s, dim=-1), cache_v)


class Attention(nn.Module):
    """Weights ``wq (D, Hp*hd)``, ``wk``/``wv (D, KV*hd)``, ``wo (Hp*hd,
    D)`` (plus ``bq``/``bk``/``bv`` with ``qkv_bias``, but never on a
    ``cross`` attention), stored as the reference stores them, on
    ``device`` (the card unless the caller asks for another).
    ``generator`` (on that device) draws them; without one they are left
    uninitialised for loading."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda", cross: bool = False):
        super().__init__()
        dev = common.weights_device(generator, device)
        self.cfg = cfg
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        Hp = cfg.padded_heads
        shapes = {"wq": (D, Hp * hd), "wk": (D, KV * hd),
                  "wv": (D, KV * hd), "wo": (Hp * hd, D)}
        if generator is None:
            w = {n: torch.empty(s, dtype=Compute, device=dev)
                 for n, s in shapes.items()}
        else:
            w = {"wq": common.dense_init(generator, D, Hp * hd),
                 "wk": common.dense_init(generator, D, KV * hd),
                 "wv": common.dense_init(generator, D, KV * hd),
                 "wo": common.dense_init(generator, Hp * hd, D,
                                         scale=1.0 / (Hp * hd) ** 0.5)}
            if Hp != H:
                # TP head padding: the pad heads sit at the tail of each kv
                # group; zero wq columns and wo rows there, so they
                # contribute exactly nothing
                g_of = (torch.arange(Hp * hd, device=dev)
                        // hd) % (Hp // KV)
                mask = (g_of < H // KV).to(Compute)
                w["wq"] = w["wq"] * mask[None, :]
                w["wo"] = w["wo"] * mask[:, None]
        if cfg.qkv_bias and not cross:
            w.update({n: torch.zeros((s[1],), dtype=Compute, device=dev)
                      for n, s in (("bq", shapes["wq"]), ("bk", shapes["wk"]),
                                   ("bv", shapes["wv"]))})
        for name, t in w.items():
            setattr(self, name, nn.Parameter(t, requires_grad=False))

    def forward(self, x: torch.Tensor, mode: str = "causal",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Optional[Index] = None,
                use_flash_decode: bool = False, q_chunk: int = 512,
                kv_chunk: int = 1024, remat: bool = False,
                kv_source: Optional[torch.Tensor] = None,
                positions3: Optional[torch.Tensor] = None):
        """Modes: ``"causal"`` (train/prefill; with a cache, prefill writes
        its first ``T`` positions), ``"bidir"`` (the encoder: no mask),
        ``"cross"`` (K and V from ``kv_source``, the encoder output; no
        mask, no rotary embedding) and ``"decode"`` (cache and
        ``cache_index`` required: a scalar or ``(B,)`` per-row write
        offsets, clamped into the cache as ``dynamic_update_slice``
        clamps). M-RoPE takes ``positions3`` ``(B, 3, T)`` when given, else
        three equal text streams of the positions. A pass whose ``T * S``
        exceeds ``STREAMING_THRESHOLD ** 2`` attends by streaming. ``remat``
        recomputes the attention core (its batched products and softmax)
        in the backward instead of keeping it. Returns ``(y, new_cache)``;
        ``new_cache`` is ``cache`` itself, updated in place, or None
        without a cache."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, KV, hd = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
        kv_in = kv_source if mode == "cross" else x
        q, k, v = x @ self.wq, kv_in @ self.wk, kv_in @ self.wv
        if hasattr(self, "bq"):
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, kv_in.shape[1], KV, hd)
        v = v.reshape(B, kv_in.shape[1], KV, hd)

        if cfg.rope != "none" and mode != "cross":
            steps = torch.arange(T, device=x.device)
            base = cache_index if mode == "decode" else 0
            if _is_vector(base):
                # per-row decode indices: each slot's rotary position is
                # its own true length (mixed-length continuous batching)
                positions = steps[None, :] + base[:, None]
            else:
                positions = (steps[None, :] + base).expand(B, T)
            if cfg.rope == "mrope":
                p3 = positions3 if positions3 is not None else \
                    common.text_positions3(positions)
                cos, sin = common.mrope_cos_sin(
                    p3, hd, cfg.rope_theta, common.mrope_sections(hd))
            else:
                cos, sin = common.rope_cos_sin(positions, hd, cfg.rope_theta)
            q = common.apply_rope(q, cos, sin)
            k = common.apply_rope(k, cos, sin)

        if mode == "decode":
            if cache is None or cache_index is None:
                raise ValueError("decode mode needs a cache and cache_index")
            S = cache["k"].shape[1]
            if _is_vector(cache_index):
                # per-row write offsets: slot b's new KV lands at its own
                # true length, not the batch max
                start = cache_index.clamp(0, S - T).to(torch.long)
                rows = torch.arange(B, device=x.device)[:, None]
                cols = start[:, None] + torch.arange(T, device=x.device)
                cache["k"][rows, cols] = k.to(cache["k"].dtype)
                cache["v"][rows, cols] = v.to(cache["v"].dtype)
            else:
                start = min(max(int(cache_index), 0), S - T)
                cache["k"][:, start:start + T] = k
                cache["v"][:, start:start + T] = v
            o = attend_decode(q, cache["k"], cache["v"], cache_index + 1,
                              use_kernel=use_flash_decode)
        elif mode in ("causal", "bidir", "cross"):
            if cache is not None and mode == "causal":  # prefill: fill it
                cache["k"][:, :T] = k
                cache["v"][:, :T] = v
            causal = mode == "causal"
            # the reference's test: query length times key length
            if T * k.shape[1] > STREAMING_THRESHOLD ** 2:
                core = lambda q_, k_, v_: attend_streaming(
                    q_, k_, v_, causal=causal, q_chunk=q_chunk,
                    kv_chunk=kv_chunk)
            else:
                core = lambda q_, k_, v_: attend_full(q_, k_, v_,
                                                      causal=causal)
            o = (checkpoint(core, q, k, v, use_reentrant=False) if remat
                 else core(q, k, v))
        else:
            raise ValueError(f"unknown attention mode {mode!r}")
        return o.to(x.dtype) @ self.wo, cache
