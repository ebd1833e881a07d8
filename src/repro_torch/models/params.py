"""Parameter layout of the decoder (attention, mamba and rwkv blocks, each
attention or mamba block with an FFN, an MoE, or both: arctic's MoE with
a dense residual) and of the encoder-decoder, in the reference's flatten
order.

The reference initialises its decoder as a nested dict (``repro/models/
decoder.py`` ``init``) with the blocks of one pattern cycle stacked over
``n_cycles`` under ``groups``, and its encoder-decoder (``repro/models/
encdec.py`` ``init``) with the encoder's layers stacked under ``enc`` and
the decoder's under ``dec``; it flattens them with ``jax.tree_util``,
which visits dict keys in sorted order. Gradient buckets are windows of
that flattened order, so :func:`param_shapes` reproduces it exactly
(``models/decoder.py`` and ``models/encdec.py`` hold the models;
``interop.params_from_reference`` carries the reference's tree into
them).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.layers import mamba
from repro_torch.layers.rwkv import DECAY_LORA

Leaf = Tuple[str, Tuple[int, ...]]


def _pad_vocab(vocab: int, multiple: int = 128) -> int:
    return -(-vocab // multiple) * multiple


def block_is_moe(cfg, j: int) -> bool:
    """Block ``j`` of the pattern carries an MoE in place of its FFN (the
    reference's ``_block_is_moe``: every ``moe.every``-th block)."""
    m = cfg.moe
    return m is not None and j % m.every == m.every - 1


def _attn(cfg, cross: bool = False) -> dict:
    D, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    Hp = cfg.padded_heads
    p = {"wq": (D, Hp * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
         "wo": (Hp * hd, D)}
    if cfg.qkv_bias and not cross:
        p.update({"bq": (Hp * hd,), "bk": (KV * hd,), "bv": (KV * hd,)})
    return p


def _mamba(cfg) -> dict:
    D = cfg.d_model
    Di, R, N, K = mamba.dims(cfg)
    return {"in_proj": (D, 2 * Di), "conv_w": (K, Di), "conv_b": (Di,),
            "x_proj": (Di, R + 2 * N), "dt_proj": (R, Di), "dt_bias": (Di,),
            "A_log": (Di, N), "D_skip": (Di,), "out_proj": (Di, D)}


def _mixer_block(cfg, kind: str, j: int) -> dict:
    """An attention or mamba block: norms, the mixer, then an FFN or (on
    the MoE blocks) an MoE."""
    D = cfg.d_model
    p = {"ln1": {"scale": (D,)}, "ln2": {"scale": (D,)},
         kind: _attn(cfg) if kind == "attn" else _mamba(cfg)}
    if block_is_moe(cfg, j):
        E, F = cfg.moe.n_experts, cfg.moe.d_ff_expert
        p["moe"] = {"router": (D, E), "w_gate": (E, D, F),
                    "w_up": (E, D, F), "w_down": (E, F, D)}
    if not block_is_moe(cfg, j) or cfg.moe.dense_residual:
        p["ffn"] = _ffn(cfg)
    return p


def _ffn(cfg) -> dict:
    return {"w_gate": (cfg.d_model, cfg.d_ff), "w_up": (cfg.d_model, cfg.d_ff),
            "w_down": (cfg.d_ff, cfg.d_model)}


def _encdec_layers(cfg) -> Tuple[dict, dict]:
    """An encoder layer (self-attention and FFN) and a decoder layer (self-
    and cross-attention, FFN), each with its norms."""
    D = cfg.d_model
    enc = {"ln1": {"scale": (D,)}, "attn": _attn(cfg),
           "ln2": {"scale": (D,)}, "ffn": _ffn(cfg)}
    dec = dict(enc, lnx={"scale": (D,)}, xattn=_attn(cfg, cross=True))
    return enc, dec


def _rwkv_block(cfg) -> dict:
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    tm = {"mu": (5, D), "wr": (D, D), "wk": (D, D), "wv": (D, D),
          "wg": (D, D), "wo": (D, D), "w0": (D,), "w1": (D, DECAY_LORA),
          "w2": (DECAY_LORA, D), "u": (D // hd, hd), "ln_x": {"scale": (D,)}}
    cm = {"mu": (2, D), "wk": (D, F), "wv": (F, D), "wr": (D, D)}
    return {"ln1": {"scale": (D,)}, "tm_cm": {"tm": tm, "cm": cm},
            "ln2": {"scale": (D,)}}


#: the block kinds the port lays out (``models/decoder.py`` reads it too)
KINDS = ("attn", "mamba", "rwkv")

#: the model families the port builds
FAMILIES = ("decoder", "rwkv", "encdec")

#: the top-level keys whose leaves are stacked over layers (the decoder's
#: pattern cycles; the encoder's and the decoder's layers)
STACKED = ("groups", "enc", "dec")


def _flatten(tree, prefix: str = "") -> List[Leaf]:
    """Leaves of a nested dict of shapes, keys visited in sorted order."""
    if isinstance(tree, dict):
        out: List[Leaf] = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tuple(tree))]


def param_shapes(cfg) -> List[Leaf]:
    """``(path, shape)`` of every parameter leaf of the model, in the
    reference's flatten order; paths join dict keys with ``/``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    D, Vp = cfg.d_model, _pad_vocab(cfg.vocab)
    if cfg.family == "encdec":
        enc, dec = _encdec_layers(cfg)
        return (
            [(p, (cfg.n_layers,) + s) for p, s in _flatten(dec, "dec")]
            + [("embed", (Vp, D))]
            + [(p, (cfg.enc_layers,) + s) for p, s in _flatten(enc, "enc")]
            + _flatten({"enc_norm": {"scale": (D,)},
                        "final_norm": {"scale": (D,)},
                        "lm_head": (D, Vp)}))
    if any(k not in KINDS for k in cfg.block_pattern):
        raise ValueError(f"{cfg.name}: a block kind of "
                         f"{cfg.block_pattern} is none of {KINDS}")
    if cfg.n_layers % len(cfg.block_pattern):
        raise ValueError(f"{cfg.n_layers} layers do not cycle "
                         f"{cfg.block_pattern}")
    nc = cfg.n_layers // len(cfg.block_pattern)
    cycle = {f"blk{j}": _rwkv_block(cfg) if kind == "rwkv"
             else _mixer_block(cfg, kind, j)
             for j, kind in enumerate(cfg.block_pattern)}
    stacked = [(p, (nc,) + s) for p, s in _flatten(cycle, "groups")]
    tree_top = _flatten({"embed": (Vp, D), "final_norm": {"scale": (D,)},
                         "lm_head": (D, Vp)})
    # "groups" sorts between "final_norm" and "lm_head"
    return tree_top[:2] + stacked + tree_top[2:]


def n_params(cfg) -> int:
    total = 0
    for _, shape in param_shapes(cfg):
        n = 1
        for d in shape:
            n *= d
        total += n
    return total


def leaf_views(flat: torch.Tensor, shapes: List[Leaf]):
    """``{path: (world, *shape) view}`` of a stacked flat ``(world, n)``
    buffer laid out by :func:`param_shapes` (no copy)."""
    views, off = {}, 0
    for path, shape in shapes:
        n = 1
        for d in shape:
            n *= d
        views[path] = flat[:, off:off + n].unflatten(1, shape)
        off += n
    if off != flat.shape[1]:
        raise ValueError(f"layout covers {off} of {flat.shape[1]} columns")
    return views


def module_names(cfg) -> List[Tuple[str, Tuple[int, ...], List[str]]]:
    """``(path, shape, names)`` for every leaf of :func:`param_shapes`:
    ``names`` are the model's parameters holding it: one per pattern cycle
    for a ``DecoderLM``'s ``groups/blk<j>/...`` leaf (cycle ``c`` is layer
    ``c * len(pattern) + j``), one per layer for an ``EncDecLM``'s
    ``enc/...`` and ``dec/...`` leaves (layer ``i`` is ``enc.<i>...``),
    else the one top-level weight."""
    n_pat = len(cfg.block_pattern)
    out = []
    for path, shape in param_shapes(cfg):
        top, *rest = path.split("/")
        if top in ("enc", "dec"):
            out.append((path, shape, [".".join([top, str(i)] + rest)
                                      for i in range(shape[0])]))
            continue
        if top != "groups":
            out.append((path, shape, [".".join([top] + rest)]))
            continue
        blk, *leaf = rest
        j = int(blk[len("blk"):])
        out.append((path, shape, [".".join(["blocks", str(c * n_pat + j)]
                                           + leaf)
                                  for c in range(shape[0])]))
    return out


class FlatParams:
    """Weights in the reference's flat layout (:func:`param_shapes`): the
    leaves in flatten order, each leaf's tensors one after another (layer
    ``c`` of a stacked leaf is its contiguous slab ``c``). Moves values
    between the weights and flat float32 buffers of :attr:`n` elements.

    ``leaves`` is ``[(path, [tensor, ...]), ...]`` in flatten order:
    :meth:`of` builds it for a ``DecoderLM``; a reference tree carried as
    one tensor per leaf works as well."""

    def __init__(self, leaves):
        self.tensors: List[torch.Tensor] = []
        self.offsets: List[int] = []
        #: ``(path, start, end, first tensor index)`` per leaf
        self.spans: List[Tuple[str, int, int, int]] = []
        off = 0
        for path, ts in leaves:
            start, first = off, len(self.tensors)
            for t in ts:
                self.tensors.append(t)
                self.offsets.append(off)
                off += t.numel()
            self.spans.append((path, start, off, first))
        self.n = off

    @classmethod
    def of(cls, model) -> "FlatParams":
        leaves = []
        for path, shape, names in module_names(model.cfg):
            ts = [model.get_parameter(n) for n in names]
            want = shape[1:] if path.split("/")[0] in STACKED else shape
            if any(tuple(t.shape) != tuple(want) for t in ts):
                raise ValueError(f"{path}: the model's weights are not "
                                 f"{want}")
            leaves.append((path, ts))
        return cls(leaves)

    @property
    def device(self) -> torch.device:
        return self.tensors[0].device

    def read(self, out: torch.Tensor = None) -> torch.Tensor:
        """The weights as one float32 ``(n,)`` buffer (``out`` if given)."""
        return self.gather(self.tensors, out)

    def gather(self, tensors, out: torch.Tensor = None) -> torch.Tensor:
        """``tensors`` (one per weight, in :attr:`tensors`' order; None for
        zeros) written as float32 into ``out`` (a new ``(n,)`` buffer
        without one), each cast where it lands."""
        if out is None:
            out = torch.empty(self.n, dtype=torch.float32,
                              device=self.device)
        with torch.no_grad():
            for t, off, w in zip(tensors, self.offsets, self.tensors):
                seg = out[off:off + w.numel()]
                if t is None:
                    seg.zero_()
                else:
                    seg.copy_(t.reshape(-1))
        return out

    def accumulate(self, tensors, acc: torch.Tensor, div: int) -> None:
        """``acc += t.float() / div`` for each of ``tensors`` (None adds
        nothing), in place: microbatch gradient accumulation."""
        with torch.no_grad():
            for t, off in zip(tensors, self.offsets):
                if t is not None:
                    acc[off:off + t.numel()].add_(
                        t.reshape(-1).float() / div)

    def assign(self, flat: torch.Tensor) -> None:
        """Write a float32 ``(n,)`` buffer into the weights, each cast to
        its own dtype."""
        with torch.no_grad():
            for w, off in zip(self.tensors, self.offsets):
                w.copy_(flat[off:off + w.numel()].view(w.shape))

    def leaf(self, path: str) -> Tuple[int, int]:
        """``(start, end)`` of a leaf in the flat layout."""
        for p, start, end, _ in self.spans:
            if p == path:
                return start, end
        raise KeyError(path)

    def cycles(self, lo: int, hi: int):
        """The stacked (``groups/...``) leaves restricted to cycles ``[lo,
        hi)``: ``(tensors, [(start, end), ...])``, the tensors in flatten
        order and the flat ranges they fill, one per leaf (contiguous: a
        leaf's cycles are consecutive slabs)."""
        tensors, ranges = [], []
        for path, start, end, first in self.spans:
            if not path.startswith("groups/"):
                continue
            ts = self.tensors[first + lo:first + hi]
            tensors += ts
            a = self.offsets[first + lo]
            ranges.append((a, a + sum(t.numel() for t in ts)))
        return tensors, ranges
