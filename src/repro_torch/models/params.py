"""Parameter layout of the decoder (attention and rwkv blocks), in the
reference's flatten order.

The reference initialises its decoder as a nested dict (``repro/models/
decoder.py`` ``init``) with the blocks of one pattern cycle stacked over
``n_cycles`` under ``groups``, and flattens it with ``jax.tree_util``,
which visits dict keys in sorted order. Gradient buckets are windows of
that flattened order, so :func:`param_shapes` reproduces it exactly
(``models/decoder.py`` holds the model; ``interop.params_from_reference``
carries the reference's tree into it).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.layers.rwkv import DECAY_LORA

Leaf = Tuple[str, Tuple[int, ...]]


def _pad_vocab(vocab: int, multiple: int = 128) -> int:
    return -(-vocab // multiple) * multiple


def _attn_block(cfg) -> dict:
    D, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    Hp = cfg.padded_heads
    p = {"wq": (D, Hp * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
         "wo": (Hp * hd, D)}
    if cfg.qkv_bias:
        p.update({"bq": (Hp * hd,), "bk": (KV * hd,), "bv": (KV * hd,)})
    return {"ln1": {"scale": (D,)}, "attn": p, "ln2": {"scale": (D,)},
            "ffn": {"w_gate": (D, cfg.d_ff), "w_up": (D, cfg.d_ff),
                    "w_down": (cfg.d_ff, D)}}


def _rwkv_block(cfg) -> dict:
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    tm = {"mu": (5, D), "wr": (D, D), "wk": (D, D), "wv": (D, D),
          "wg": (D, D), "wo": (D, D), "w0": (D,), "w1": (D, DECAY_LORA),
          "w2": (DECAY_LORA, D), "u": (D // hd, hd), "ln_x": {"scale": (D,)}}
    cm = {"mu": (2, D), "wk": (D, F), "wv": (F, D), "wr": (D, D)}
    return {"ln1": {"scale": (D,)}, "tm_cm": {"tm": tm, "cm": cm},
            "ln2": {"scale": (D,)}}


_BLOCKS = {"attn": _attn_block, "rwkv": _rwkv_block}

#: the model families the port builds (``models/decoder.py`` reads it too)
FAMILIES = ("decoder", "rwkv")


def _flatten(tree, prefix: str = "") -> List[Leaf]:
    """Leaves of a nested dict of shapes, keys visited in sorted order."""
    if isinstance(tree, dict):
        out: List[Leaf] = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tuple(tree))]


def param_shapes(cfg) -> List[Leaf]:
    """``(path, shape)`` of every parameter leaf of the decoder, in the
    reference's flatten order; paths join dict keys with ``/``."""
    if cfg.family not in FAMILIES or cfg.moe is not None or \
            any(k not in _BLOCKS for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: only the attention and rwkv blocks are laid out "
            f"so far (ROADMAP.md, queue 1: the model stack)")
    if cfg.n_layers % len(cfg.block_pattern):
        raise ValueError(f"{cfg.n_layers} layers do not cycle "
                         f"{cfg.block_pattern}")
    nc = cfg.n_layers // len(cfg.block_pattern)
    D, Vp = cfg.d_model, _pad_vocab(cfg.vocab)
    cycle = {f"blk{j}": _BLOCKS[kind](cfg)
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
