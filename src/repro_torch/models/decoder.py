"""The decoder LM (port of ``repro.models.decoder``) for the attention,
mamba and rwkv block kinds: the dense decoders (smollm, yi with padded
heads, qwen1.5 with QKV biases, phi3), the VLM (qwen2-vl: M-RoPE, stub
patch embeddings put before the tokens), the hybrid family (jamba: mamba
and attention blocks, MoE on every other block), the MoE family
(qwen3-moe: MoE on every block; arctic: MoE plus a dense residual MLP on
the same normed input) and the attention-free rwkv family (rwkv6). The
encoder-decoder family is ``models/encdec.py``.

``rules`` and ``grid`` (:meth:`DecoderLM.forward`, :meth:`DecoderLM.
segment_apply`) reach the MoE blocks, as the reference's ``rules=`` and
``mesh=`` do: with a grid whose TP axis splits the experts, an MoE block
runs expert parallel (``layers/moe.py``); every other layer ignores them
(on a grid held by one device the reference's sharding constraints change
no value).

The reference scans its layers over stacked pattern cycles; here one block
module per layer sits in a ``ModuleList`` and runs in a Python loop (layer
``c * len(pattern) + j`` is the reference's cycle ``c``, block ``j``).
The weights are made frozen, as serving wants them; :meth:`DecoderLM.
trainable` turns ``requires_grad`` on for training (the train steps of
``train/`` call it). Without caches, under grad mode, each block runs
under the remat policy of ``RunFlags.remat`` (the reference's
``_remat_wrap``, there per pattern cycle): ``"none"`` keeps every
activation; ``"full"`` recomputes the whole block in the backward
(``torch.utils.checkpoint``, the reference's ``nothing_saveable``);
``"dots"`` keeps the outputs of the 2-D matrix products and recomputes
each block's mixer core, the part without them: attention's batched
products, masks and softmax, the WKV6 recurrence, the selective scan.
The reference's ``checkpoint_dots_with_no_batch_dims`` also recomputes
the elementwise work between the 2-D products (norms, SwiGLU); here that
is kept, which holds a few MB a layer more and spares a selective
checkpoint's Python dispatch of every operation (0.5 against 0.2 s a
rank's backward at full smollm width on an H100, PERF.md §6).
Every policy gives the same values, bit for bit.
:meth:`DecoderLM.embed_apply`, :meth:`DecoderLM.segment_apply` and
:meth:`DecoderLM.head_apply` are the forward's stages, the segments the
backward-segmented train step differentiates one by one.

Caches are a list with one dict per layer, written in place by
:meth:`DecoderLM.forward`: ``{"k", "v"}`` for an attention layer (see
``layers/attention.py``), ``{"conv", "ssm"}`` for a mamba layer (see
``layers/mamba.py``), ``{"tm_shift", "wkv", "cm_shift"}`` for an rwkv
layer (see ``layers/rwkv.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.layers import attention, common, mamba, rwkv
from repro_torch.layers.common import RMSNorm
from repro_torch.layers.mlp import MLP
from repro_torch.layers.moe import MoE
from repro_torch.models.params import block_is_moe

Caches = List[Dict[str, torch.Tensor]]
#: a block's output: the hidden state and its MoE's load-balance loss (None
#: for a block without one)
BlockOut = Tuple[torch.Tensor, Optional[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RunFlags:
    remat: str = "dots"            # "none" | "full" | "dots"
    use_flash_decode: bool = False
    use_mamba_kernel: bool = False
    use_rwkv_kernel: bool = False
    logits_dtype: str = "bfloat16"
    q_chunk: int = 512             # streaming-attention tile
    kv_chunk: int = 1024


REMATS = ("none", "full", "dots")


def _remat_core(flags: RunFlags) -> bool:
    """Whether a block recomputes its mixer core in the backward."""
    return flags.remat == "dots" and torch.is_grad_enabled()


def _vocab_padded(cfg) -> int:
    return common.pad_vocab(cfg.vocab, 128)


def n_cycles(cfg) -> int:
    pat = cfg.block_pattern
    if cfg.n_layers % len(pat):
        raise ValueError(f"{cfg.n_layers} layers do not cycle {pat}")
    return cfg.n_layers // len(pat)


class _MixerBlock(nn.Module):
    """Pre-norm block: a mixer (attention or mamba, set by the subclass),
    then a SwiGLU MLP, or an MoE on the pattern's MoE blocks (block ``j``
    of the pattern), each with a residual. With ``moe.dense_residual``
    (arctic) an MoE block keeps its MLP too, run on the same normed input
    and added to the MoE's output."""

    def __init__(self, cfg, j: int, generator=None, device="cuda"):
        super().__init__()
        self.eps = cfg.norm_eps
        dev = common.weights_device(generator, device)
        self.ln1 = RMSNorm(cfg.d_model, dev)
        self.ln2 = RMSNorm(cfg.d_model, dev)
        if block_is_moe(cfg, j):
            self.moe = MoE(cfg, generator, dev)
        if not block_is_moe(cfg, j) or cfg.moe.dense_residual:
            self.ffn = MLP(cfg, generator, dev)

    def _ffn(self, h: torch.Tensor, rules, grid) -> BlockOut:
        x = self.ln2(h, self.eps)
        if hasattr(self, "moe"):
            f, aux = self.moe(x, rules=rules, grid=grid)
            if hasattr(self, "ffn"):  # arctic's dense residual
                f = f + self.ffn(x)
            return h + f, aux
        return h + self.ffn(x), None


class AttnBlock(_MixerBlock):
    """Attention, then the FFN or MoE."""

    def __init__(self, cfg, j: int = 0, generator=None, device="cuda"):
        super().__init__(cfg, j, generator, device)
        self.attn = attention.Attention(cfg, generator, device)

    def forward(self, h, cache, cache_index, flags: RunFlags, rules=None,
                grid=None, positions3=None) -> BlockOut:
        mode = "decode" if cache is not None and cache_index is not None \
            else "causal"
        a, _ = self.attn(
            self.ln1(h, self.eps), mode=mode, cache=cache,
            cache_index=cache_index, use_flash_decode=flags.use_flash_decode,
            q_chunk=flags.q_chunk, kv_chunk=flags.kv_chunk,
            remat=_remat_core(flags), positions3=positions3)
        return self._ffn(h + a, rules, grid)


class MambaBlock(_MixerBlock):
    """The selective SSM, then the FFN or MoE."""

    def __init__(self, cfg, j: int = 0, generator=None, device="cuda"):
        super().__init__(cfg, j, generator, device)
        self.mamba = mamba.Mamba(cfg, generator, device)

    def forward(self, h, cache, cache_index, flags: RunFlags, rules=None,
                grid=None, positions3=None) -> BlockOut:
        """``cache`` (the layer's state, or None) is advanced in place;
        ``cache_index`` and ``positions3`` are not read: the state holds
        the whole context."""
        h = h + self.mamba(self.ln1(h, self.eps), cache,
                           use_kernel=flags.use_mamba_kernel,
                           remat=_remat_core(flags))
        return self._ffn(h, rules, grid)


class RwkvBlock(nn.Module):
    """Pre-norm rwkv block: time mixing, then channel mixing (the rwkv
    kind's FFN), each with a residual."""

    def __init__(self, cfg, j: int = 0, generator=None, device="cuda"):
        super().__init__()
        self.eps = cfg.norm_eps
        dev = common.weights_device(generator, device)
        self.ln1 = RMSNorm(cfg.d_model, dev)
        self.tm_cm = nn.ModuleDict({"tm": rwkv.TimeMix(cfg, generator, dev),
                                    "cm": rwkv.ChannelMix(cfg, generator,
                                                          dev)})
        self.ln2 = RMSNorm(cfg.d_model, dev)

    def forward(self, h, cache, cache_index, flags: RunFlags, rules=None,
                grid=None, positions3=None) -> BlockOut:
        """``cache`` (the layer's state, or None) is advanced in place;
        ``cache_index`` and ``positions3`` are not read: the state holds
        the whole context. ``rules`` and ``grid`` are not read: the block
        has no MoE."""
        h = h + self.tm_cm["tm"](self.ln1(h, self.eps), cache,
                                 use_kernel=flags.use_rwkv_kernel,
                                 remat=_remat_core(flags))
        h = h + self.tm_cm["cm"](self.ln2(h, self.eps), cache)
        return h, None


_BLOCKS = {"attn": AttnBlock, "mamba": MambaBlock, "rwkv": RwkvBlock}


class DecoderLM(nn.Module):
    """Embedding, ``cfg.n_layers`` blocks of ``cfg.block_pattern``'s kinds
    (attention, mamba or rwkv), final norm, LM head.

    The weights are bf16 on ``device``, the card unless the caller asks
    for another. ``generator`` (on that device; another raises) draws them
    as the reference's ``init`` does; without one they are left
    uninitialised (``"meta"`` allocates nothing), for
    ``interop.params_from_reference`` to assign."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the encoder-decoder family is "
                             f"models/encdec.EncDecLM, not DecoderLM")
        for kind in cfg.block_pattern:
            if kind not in _BLOCKS:
                raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
        self.cfg = cfg
        Vp, D = _vocab_padded(cfg), cfg.d_model
        dev = common.weights_device(generator, device)
        self.embed = common.param(generator, (Vp, D), dev,
                            lambda: common.dense_init(generator, Vp, D,
                                                      scale=1.0))
        pat = cfg.block_pattern
        self.blocks = nn.ModuleList(
            _BLOCKS[pat[i % len(pat)]](cfg, i % len(pat), generator, dev)
            for i in range(n_cycles(cfg) * len(pat)))
        self.final_norm = RMSNorm(D, dev)
        self.lm_head = common.param(generator, (D, Vp), dev,
                              lambda: common.dense_init(generator, D, Vp))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, batch: int, max_len: int, dtype=common.Compute
                   ) -> Caches:
        """One zeroed cache per layer on the model's device: ``{"k", "v"}``
        of ``max_len`` positions for an attention layer, the recurrent
        state ``{"conv", "ssm"}`` for a mamba layer and ``{"tm_shift",
        "wkv", "cm_shift"}`` for an rwkv layer (the scan and WKV states
        float32 whatever ``dtype``)."""
        def one(blk):
            if isinstance(blk, AttnBlock):
                return attention.init_cache(self.cfg, batch, max_len, dtype,
                                            self.device)
            kind = mamba if isinstance(blk, MambaBlock) else rwkv
            return kind.init_state(self.cfg, batch, dtype, self.device)
        return [one(blk) for blk in self.blocks]

    def reset_state(self, caches: Caches) -> None:
        """Zero the recurrent state of ``caches`` (every mamba and rwkv
        layer's), in place, as a fresh ``init_cache`` holds it. Attention
        caches are left as they are: a row beyond a sequence's length is
        masked."""
        for blk, cache in zip(self.blocks, caches):
            if not isinstance(blk, AttnBlock):
                for t in cache.values():
                    t.zero_()

    def trainable(self, on: bool = True) -> "DecoderLM":
        """Turn ``requires_grad`` on (or off) for every weight; returns the
        model."""
        for p in self.parameters():
            p.requires_grad_(on)
        return self

    def embed_apply(self, tokens: torch.Tensor,
                    embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token lookup: (B, T) int -> (B, T, D), with the frontend's stub
        embeddings ``embeds`` (B, T_p, D) (VLM patches) put before the
        tokens, cast to the embedding's dtype: (B, T_p + T, D)."""
        h = self.embed[tokens]
        if embeds is not None:
            h = torch.cat([embeds.to(h.dtype), h], dim=1)
        return h

    def _positions3(self, B: int, T: int, cache_index,
                    positions3: Optional[torch.Tensor]):
        """M-RoPE's ``(B, 3, T)`` positions: ``positions3`` when given,
        else three equal text streams from ``cache_index`` (0 without one;
        a ``(B,)`` vector gives each row its own). None without M-RoPE."""
        if self.cfg.rope != "mrope" or positions3 is not None:
            return positions3
        base = cache_index if cache_index is not None else 0
        steps = torch.arange(T, device=self.device)
        if torch.is_tensor(base) and base.dim() > 0:
            pos = steps[None] + base.to(steps.device)[:, None]
        else:
            pos = (steps[None] + base).expand(B, T)
        return common.text_positions3(pos)

    def _block(self, i: int, h: torch.Tensor, flags: RunFlags, rules=None,
               grid=None, positions3=None) -> BlockOut:
        """Layer ``i`` without a cache, under ``flags.remat`` when grad
        mode is on (``"dots"`` is the blocks' own: they recompute their
        mixer cores)."""
        blk = self.blocks[i]
        if flags.remat not in REMATS:
            raise ValueError(f"remat {flags.remat!r} is none of {REMATS}")
        if flags.remat == "full" and torch.is_grad_enabled():
            return checkpoint(blk, h, None, None, flags, rules, grid,
                              positions3, use_reentrant=False)
        return blk(h, None, None, flags, rules, grid, positions3)

    def segment_apply(self, h: torch.Tensor, lo: int, hi: int,
                      flags: RunFlags = RunFlags(), rules=None, grid=None,
                      positions3: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pattern cycles ``[lo, hi)`` (layers ``lo * len(pattern)`` up to
        ``hi * len(pattern)``) on the hidden state ``h``, without caches.
        Returns ``(h, aux)``, ``aux`` the float32 sum of their MoE
        load-balance losses. ``segment_apply(h, 0, n_cycles(cfg))`` is the
        whole trunk, as :meth:`forward` runs it. ``rules`` and ``grid``
        reach the MoE blocks; ``positions3`` (M-RoPE) the attention."""
        n = len(self.cfg.block_pattern)
        B, T, _ = h.shape
        positions3 = self._positions3(B, T, None, positions3)
        aux = torch.zeros((), dtype=common.Accum, device=h.device)
        for i in range(lo * n, hi * n):
            h, blk_aux = self._block(i, h, flags, rules, grid, positions3)
            if blk_aux is not None:
                aux = aux + blk_aux
        return h, aux

    def head_apply(self, h: torch.Tensor, flags: RunFlags = RunFlags()
                   ) -> torch.Tensor:
        """Final norm and LM head; logits cast to ``flags.logits_dtype``."""
        h = self.final_norm(h, self.cfg.norm_eps)
        return (h @ self.lm_head).to(getattr(torch, flags.logits_dtype))

    def forward(self, tokens: torch.Tensor, caches: Optional[Caches] = None,
                cache_index=None, flags: RunFlags = RunFlags(), rules=None,
                grid=None, embeds: Optional[torch.Tensor] = None,
                positions3: Optional[torch.Tensor] = None):
        """tokens: (B, T) int; ``embeds``: optional (B, T_p, D) stub
        frontend embeddings (VLM patches) put before the tokens. With
        ``caches`` and no ``cache_index`` the pass is a prefill that fills
        each layer's first ``T_p + T`` positions; with both it is a decode
        step at ``cache_index`` (a scalar or a ``(B,)`` vector of per-row
        offsets). ``positions3`` (B, 3, T_p + T): M-RoPE's positions (the
        default: text positions from ``cache_index``, as the reference
        gives them).

        Returns ``(logits (B, T, vocab_padded), aux, new_caches)``: ``aux``
        is the float32 sum of the MoE blocks' load-balance losses (0 without
        MoE), ``new_caches`` the given list, updated in place (None without
        caches). ``rules`` (``sharding.rules.Rules``) and ``grid`` (a
        ``RankGrid`` or a ``Communicator``) reach the MoE blocks: the
        reference's ``rules=`` and ``mesh=``."""
        h = self.embed_apply(tokens, embeds)
        B, T, _ = h.shape
        positions3 = self._positions3(B, T, cache_index, positions3)
        if caches is None:
            h, aux = self.segment_apply(h, 0, n_cycles(self.cfg), flags,
                                        rules, grid, positions3)
            return self.head_apply(h, flags), aux, None
        aux = torch.zeros((), dtype=common.Accum, device=h.device)
        for i, blk in enumerate(self.blocks):
            h, blk_aux = blk(h, caches[i], cache_index, flags, rules, grid,
                             positions3)
            if blk_aux is not None:
                aux = aux + blk_aux
        return self.head_apply(h, flags), aux, caches
