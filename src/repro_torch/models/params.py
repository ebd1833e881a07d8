"""Parameter layout of the dense decoder, in the reference's flatten order.

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


def _flatten(tree, prefix: str = "") -> List[Leaf]:
    """Leaves of a nested dict of shapes, keys visited in sorted order."""
    if isinstance(tree, dict):
        out: List[Leaf] = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tuple(tree))]


def param_shapes(cfg) -> List[Leaf]:
    """``(path, shape)`` of every parameter leaf of the dense decoder, in
    the reference's flatten order; paths join dict keys with ``/``."""
    if cfg.family != "decoder" or cfg.moe is not None or \
            any(k != "attn" for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: only the dense attention decoder is laid out so "
            f"far (ROADMAP.md, queue 1: the model stack)")
    if cfg.n_layers % len(cfg.block_pattern):
        raise ValueError(f"{cfg.n_layers} layers do not cycle "
                         f"{cfg.block_pattern}")
    nc = cfg.n_layers // len(cfg.block_pattern)
    D, Vp = cfg.d_model, _pad_vocab(cfg.vocab)
    cycle = {f"blk{j}": _attn_block(cfg)
             for j in range(len(cfg.block_pattern))}
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
