"""The encoder-decoder LM, a SeamlessM4T-style backbone (port of
``repro.models.encdec``).

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``(B, S_enc, D)``. The encoder's layers
attend bidirectionally; the decoder is a causal LM with a cross-attention
to the encoder output in every layer. Decoding uses a self-attention KV
cache per layer and the cross K/V computed once from the encoder output
(:meth:`EncDecLM.cross_cache`); the reference serves the family only
through :meth:`EncDecLM.encode`, :meth:`EncDecLM.cross_cache` and
:meth:`EncDecLM.decode_forward`, so no engine takes it.

The reference stacks the encoder's and the decoder's layers (``enc``,
``dec``) and scans them; here each is a ``ModuleList`` run in a Python
loop (``models/params.py`` lays the stacked leaves out, layer by layer).
With ``RunFlags.remat`` other than ``"none"`` every layer of a pass without
caches is recomputed in the backward (``torch.utils.checkpoint``; the
reference's ``jax.checkpoint`` without a policy); the values are the same
bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.layers import attention, common
from repro_torch.layers.common import RMSNorm
from repro_torch.layers.mlp import MLP
from repro_torch.models.decoder import REMATS, DecoderLM, RunFlags

Caches = List[Dict[str, torch.Tensor]]


class EncLayer(nn.Module):
    """Pre-norm encoder layer: bidirectional self-attention, then a SwiGLU
    MLP, each with a residual."""

    def __init__(self, cfg, generator=None, device="cuda"):
        super().__init__()
        self.eps = cfg.norm_eps
        dev = common.weights_device(generator, device)
        self.ln1 = RMSNorm(cfg.d_model, dev)
        self.attn = attention.Attention(cfg, generator, dev)
        self.ln2 = RMSNorm(cfg.d_model, dev)
        self.ffn = MLP(cfg, generator, dev)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        a, _ = self.attn(self.ln1(h, self.eps), mode="bidir")
        h = h + a
        return h + self.ffn(self.ln2(h, self.eps))


class DecLayer(nn.Module):
    """Pre-norm decoder layer: causal self-attention, cross-attention to
    the encoder output, then a SwiGLU MLP, each with a residual."""

    def __init__(self, cfg, generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.eps = cfg.norm_eps
        dev = common.weights_device(generator, device)
        self.ln1 = RMSNorm(cfg.d_model, dev)
        self.attn = attention.Attention(cfg, generator, dev)
        self.lnx = RMSNorm(cfg.d_model, dev)
        self.xattn = attention.Attention(cfg, generator, dev, cross=True)
        self.ln2 = RMSNorm(cfg.d_model, dev)
        self.ffn = MLP(cfg, generator, dev)

    def forward(self, h: torch.Tensor, enc_out: Optional[torch.Tensor],
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index=None,
                xkv: Optional[Dict[str, torch.Tensor]] = None,
                use_flash_decode: bool = False) -> torch.Tensor:
        """A decode step (``cache`` written in place at ``cache_index``,
        the cross-attention against the precomputed ``xkv``) when a cache
        and an index are given, else a causal pass cross-attending to
        ``enc_out``."""
        cfg = self.cfg
        decode = cache is not None and cache_index is not None
        a, _ = self.attn(self.ln1(h, self.eps),
                         mode="decode" if decode else "causal",
                         cache=cache if decode else None,
                         cache_index=cache_index,
                         use_flash_decode=use_flash_decode)
        h = h + a
        xq = self.lnx(h, self.eps)
        if decode:
            # the reference's cross-attention decode: q over n_heads, the
            # plain one-query attention over every encoder position
            q = (xq @ self.xattn.wq).reshape(xq.shape[0], xq.shape[1],
                                             cfg.n_heads, cfg.head_dim)
            o = attention.attend_decode(q, xkv["k"], xkv["v"],
                                        xkv["k"].shape[1])
            x = o.to(h.dtype) @ self.xattn.wo
        else:
            x, _ = self.xattn(xq, mode="cross", kv_source=enc_out)
        h = h + x
        return h + self.ffn(self.ln2(h, self.eps))


class EncDecLM(nn.Module):
    """Embedding, ``cfg.enc_layers`` encoder layers and their final norm,
    ``cfg.n_layers`` decoder layers, final norm, LM head (the vocab padded
    to a multiple of 128).

    The weights are bf16 on ``device``, the card unless the caller asks
    for another. ``generator`` (on that device; another raises) draws them;
    without one they are left uninitialised (``"meta"`` allocates
    nothing), for ``interop.params_from_reference`` to assign."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: the {cfg.family} family is "
                             f"models/decoder.DecoderLM, not EncDecLM")
        self.cfg = cfg
        Vp, D = common.pad_vocab(cfg.vocab, 128), cfg.d_model
        dev = common.weights_device(generator, device)
        self.embed = common.param(generator, (Vp, D), dev,
                                  lambda: common.dense_init(generator, Vp, D,
                                                            scale=1.0))
        self.enc = nn.ModuleList(EncLayer(cfg, generator, dev)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, generator, dev)
                                 for _ in range(cfg.n_layers))
        self.enc_norm = RMSNorm(D, dev)
        self.final_norm = RMSNorm(D, dev)
        self.lm_head = common.param(generator, (D, Vp), dev,
                                    lambda: common.dense_init(generator, D,
                                                              Vp))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    trainable = DecoderLM.trainable

    @staticmethod
    def _remat(flags: RunFlags) -> bool:
        if flags.remat not in REMATS:
            raise ValueError(f"remat {flags.remat!r} is none of {REMATS}")
        return flags.remat != "none" and torch.is_grad_enabled()

    def encode(self, frames: torch.Tensor, flags: RunFlags = RunFlags()
               ) -> torch.Tensor:
        """frames: (B, S_enc, D) stub embeddings, cast to bf16 -> the
        encoder output (B, S_enc, D)."""
        h = frames.to(common.Compute)
        remat = self._remat(flags)
        for layer in self.enc:
            h = (checkpoint(layer, h, use_reentrant=False) if remat
                 else layer(h))
        return self.enc_norm(h, self.cfg.norm_eps)

    def init_cache(self, batch: int, max_len: int, dtype=common.Compute
                   ) -> Caches:
        """One zeroed self-attention cache ``{"k", "v"}`` of ``max_len``
        positions per decoder layer, on the model's device."""
        return [attention.init_cache(self.cfg, batch, max_len, dtype,
                                     self.device) for _ in self.dec]

    def cross_cache(self, enc_out: torch.Tensor) -> Caches:
        """Per decoder layer, the cross-attention's K and V of the encoder
        output, ``(B, S_enc, KV, hd)`` each (no bias)."""
        cfg = self.cfg
        B = enc_out.shape[0]
        return [{"k": (enc_out @ layer.xattn.wk).reshape(
                     B, -1, cfg.n_kv_heads, cfg.head_dim),
                 "v": (enc_out @ layer.xattn.wv).reshape(
                     B, -1, cfg.n_kv_heads, cfg.head_dim)}
                for layer in self.dec]

    def decode_forward(self, tokens: torch.Tensor,
                       enc_out: Optional[torch.Tensor] = None,
                       flags: RunFlags = RunFlags(),
                       caches: Optional[Caches] = None, cache_index=None,
                       xkv: Optional[Caches] = None
                       ) -> Tuple[torch.Tensor, Optional[Caches]]:
        """The decoder. With ``caches``, ``cache_index`` and ``xkv`` (from
        :meth:`cross_cache`) a decode step of ``tokens`` (B, 1) at
        ``cache_index`` (a scalar or ``(B,)`` offsets), the caches written
        in place and returned; otherwise a causal pass over ``tokens`` (B,
        T) cross-attending to ``enc_out``, which neither fills nor returns
        caches (as the reference's). Returns ``(logits (B, T,
        vocab_padded), new_caches)``."""
        h = self.embed[tokens]
        decode = caches is not None and cache_index is not None
        if decode:
            for layer, cache, xkv_l in zip(self.dec, caches, xkv):
                h = layer(h, None, cache, cache_index, xkv_l,
                          flags.use_flash_decode)
        else:
            remat = self._remat(flags)
            for layer in self.dec:
                h = (checkpoint(layer, h, enc_out, use_reentrant=False)
                     if remat else layer(h, enc_out))
            caches = None
        h = self.final_norm(h, self.cfg.norm_eps)
        logits = (h @ self.lm_head).to(getattr(torch, flags.logits_dtype))
        return logits, caches

    def forward_train(self, frames: torch.Tensor, tokens: torch.Tensor,
                      flags: RunFlags = RunFlags()):
        """``(logits, aux, None)`` of the training pass: encode ``frames``,
        then the causal decoder over ``tokens``; ``aux`` is a float32 zero
        (no MoE), as the decoder's forward returns one."""
        enc_out = self.encode(frames, flags)
        logits, _ = self.decode_forward(tokens, enc_out, flags)
        return logits, torch.zeros((), dtype=common.Accum,
                                   device=logits.device), None
