"""The dense decoder LM (port of ``repro.models.decoder`` for the attention
block pattern).

The reference scans its layers over stacked pattern cycles; here one block
module per layer sits in a ``ModuleList`` and runs in a Python loop (layer
``c * len(pattern) + j`` is the reference's cycle ``c``, block ``j``).
Parameters are not trainable yet (serving only; the training slice turns
``requires_grad`` on).

Caches are a list with one ``{"k", "v"}`` dict per layer, written in place
by :meth:`DecoderLM.forward` (see ``layers/attention.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.layers import attention, common
from repro_torch.layers.mlp import MLP

Caches = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RunFlags:
    remat: str = "dots"            # "none" | "full" | "dots"
    use_flash_decode: bool = False
    use_mamba_kernel: bool = False
    use_rwkv_kernel: bool = False
    logits_dtype: str = "bfloat16"
    q_chunk: int = 512             # streaming-attention tile
    kv_chunk: int = 1024


_NOT_PORTED = {
    "mamba": "the hybrid family (ROADMAP.md, queue 1 item 7; kernel: queue 2 "
             "item 11)",
    "rwkv": "the hybrid family (ROADMAP.md, queue 1 item 7; kernel: queue 2 "
            "item 12)",
    "moe": "MoE (ROADMAP.md, queue 1 item 7)",
}


def _vocab_padded(cfg) -> int:
    return common.pad_vocab(cfg.vocab, 128)


def n_cycles(cfg) -> int:
    pat = cfg.block_pattern
    if cfg.n_layers % len(pat):
        raise ValueError(f"{cfg.n_layers} layers do not cycle {pat}")
    return cfg.n_layers // len(pat)


def _param(generator, shape, device, init) -> nn.Parameter:
    t = (init() if generator is not None
         else torch.empty(shape, dtype=common.Compute, device=device))
    return nn.Parameter(t, requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(common.init_rmsnorm(d, device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return common.rmsnorm(x, self.scale, eps)


class AttnBlock(nn.Module):
    """Pre-norm attention block with a SwiGLU MLP."""

    def __init__(self, cfg, generator=None, device="cuda"):
        super().__init__()
        self.eps = cfg.norm_eps
        dev = common.weights_device(generator, device)
        self.ln1 = RMSNorm(cfg.d_model, dev)
        self.attn = attention.Attention(cfg, generator, dev)
        self.ln2 = RMSNorm(cfg.d_model, dev)
        self.ffn = MLP(cfg, generator, dev)

    def forward(self, h, cache, cache_index, flags: RunFlags):
        mode = "decode" if cache is not None and cache_index is not None \
            else "causal"
        a, new_cache = self.attn(
            self.ln1(h, self.eps), mode=mode, cache=cache,
            cache_index=cache_index, use_flash_decode=flags.use_flash_decode,
            q_chunk=flags.q_chunk, kv_chunk=flags.kv_chunk)
        h = h + a
        h = h + self.ffn(self.ln2(h, self.eps))
        return h, new_cache


class DecoderLM(nn.Module):
    """Embedding, ``cfg.n_layers`` attention blocks, final norm, LM head.

    The weights are bf16 on ``device``, the card unless the caller asks
    for another. ``generator`` (on that device; another raises) draws them
    as the reference's ``init`` does; without one they are left
    uninitialised (``"meta"`` allocates nothing), for
    ``interop.params_from_reference`` to assign."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if cfg.family != "decoder":
            raise NotImplementedError(f"{cfg.name}: the {cfg.family} family "
                                      f"is not ported yet (ROADMAP.md, "
                                      f"queue 1 item 7)")
        if cfg.moe is not None:
            raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED['moe']}")
        for kind in cfg.block_pattern:
            if kind != "attn":
                raise NotImplementedError(
                    f"{cfg.name}: {kind} blocks come with "
                    f"{_NOT_PORTED.get(kind, 'a later slice')}")
        self.cfg = cfg
        Vp, D = _vocab_padded(cfg), cfg.d_model
        dev = common.weights_device(generator, device)
        self.embed = _param(generator, (Vp, D), dev,
                            lambda: common.dense_init(generator, Vp, D,
                                                      scale=1.0))
        self.blocks = nn.ModuleList(
            AttnBlock(cfg, generator, dev)
            for _ in range(n_cycles(cfg) * len(cfg.block_pattern)))
        self.final_norm = RMSNorm(D, dev)
        self.lm_head = _param(generator, (D, Vp), dev,
                              lambda: common.dense_init(generator, D, Vp))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, batch: int, max_len: int, dtype=common.Compute
                   ) -> Caches:
        """One zeroed ``{"k", "v"}`` cache per layer on the model's
        device."""
        return [attention.init_cache(self.cfg, batch, max_len, dtype,
                                     self.device)
                for _ in self.blocks]

    def embed_apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token lookup: (B, T) int -> (B, T, D)."""
        return self.embed[tokens]

    def head_apply(self, h: torch.Tensor, flags: RunFlags = RunFlags()
                   ) -> torch.Tensor:
        """Final norm and LM head; logits cast to ``flags.logits_dtype``."""
        h = self.final_norm(h, self.cfg.norm_eps)
        return (h @ self.lm_head).to(getattr(torch, flags.logits_dtype))

    def forward(self, tokens: torch.Tensor, caches: Optional[Caches] = None,
                cache_index=None, flags: RunFlags = RunFlags()):
        """tokens: (B, T) int. With ``caches`` and no ``cache_index`` the
        pass is a prefill that fills each layer's first ``T`` positions;
        with both it is a decode step at ``cache_index`` (a scalar or a
        ``(B,)`` vector of per-row offsets).

        Returns ``(logits (B, T, vocab_padded), aux, new_caches)``: ``aux``
        is the float32 0 of a model without MoE, ``new_caches`` the given
        list, updated in place (None without caches)."""
        h = self.embed_apply(tokens)
        for i, blk in enumerate(self.blocks):
            h, _ = blk(h, None if caches is None else caches[i], cache_index,
                       flags)
        aux = torch.zeros((), dtype=common.Accum, device=h.device)
        return self.head_apply(h, flags), aux, caches
