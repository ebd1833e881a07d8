"""Parameter layout of the decoder (attention, mamba and rwkv blocks, each
attention or mamba block with an FFN or an MoE), in the reference's
flatten order.

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


def _attn(cfg) -> dict:
    D, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    Hp = cfg.padded_heads
    p = {"wq": (D, Hp * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
         "wo": (Hp * hd, D)}
    if cfg.qkv_bias:
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
    else:
        p["ffn"] = {"w_gate": (D, cfg.d_ff), "w_up": (D, cfg.d_ff),
                    "w_down": (cfg.d_ff, D)}
    return p


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
    if cfg.family not in FAMILIES or \
            any(k not in KINDS for k in cfg.block_pattern) or \
            (cfg.moe is not None and cfg.moe.dense_residual):
        raise NotImplementedError(
            f"{cfg.name}: only the attention, mamba and rwkv blocks and MoE "
            f"without a dense residual are laid out so far (ROADMAP.md, "
            f"queue 1: the model stack)")
    if cfg.n_layers % len(cfg.block_pattern):
        raise ValueError(f"{cfg.n_layers} layers do not cycle "
                         f"{cfg.block_pattern}")
    nc = cfg.n_layers // len(cfg.block_pattern)
    D, Vp = cfg.d_model, _pad_vocab(cfg.vocab)
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
