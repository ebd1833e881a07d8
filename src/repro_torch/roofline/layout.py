"""The collectives of the production layout, per device (the part of the
reference's post-SPMD collective count that the port's one-device program
does not run).

The port's sharded step runs the whole global program on one device
(``train/step.py``); only the expert-parallel MoE crosses the grid, and
the work counter counts its primitives where they run. What XLA's SPMD
partitioner would add to the reference's module for the same leaf specs
(``launch/specs.py``) and rules (``launch/mesh.default_rules``) is
modelled here, per device and per layer:

  * FSDP: each weight sharded over a ``rules.fsdp`` axis is all-gathered
    before use, its bytes per device those of its shard on the other
    axes; once for prefill and decode, for train once more in the
    backward unless ``remat="none"`` keeps the gathered weight; its
    gradient is reduce-scattered once (train);
  * data parallel: each weight not sharded over ``rules.batch``'s axes has
    its gradient all-reduced over them (train);
  * tensor parallel: each product whose contraction dim is sharded over
    ``rules.tp`` (a weight whose second-to-last dim is, outside the MoE's
    experts, whose all-to-alls the counter sees) leaves a partial sum of
    its output activation, all-reduced: the reductions at the reference's
    ``constrain(..., ("batch", None, None))`` points (attention and rwkv
    ``wo``, the FFN's ``w_down``, mamba's ``out_proj``, the embedding over
    a sharded vocab); train adds the backward's reduction at each
    column-parallel input, one per forward reduction;
  * context parallel (decode with ``rules.seq``): each attention layer
    combines its sequence shards' fp32 partial outputs with one
    all-reduce.

Activations count bf16; each stacked leaf (``groups/``, ``enc/``,
``dec/``) counts once per layer. It is a model of the layout, counted
from shapes: no program runs.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

#: leaves stacked over layers, their first dim the layer
_STACKED = ("groups/", "enc/", "dec/")


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _leaf_bytes(leaf) -> int:
    return math.prod(leaf.shape) * torch.empty((), dtype=leaf.dtype
                                               ).element_size()


def _tokens(cfg, shape) -> int:
    """Tokens a sequence of the cell runs through the encoder or the
    decoder (``launch/specs.py``'s batches and caches): the encoder-
    decoder trains on half the sequence budget each."""
    if shape.kind == "decode":
        return 1
    if cfg.family == "encdec" and shape.kind == "train":
        return shape.seq_len // 2
    return shape.seq_len


def _runs(cfg, shape, path: str) -> bool:
    """Whether the cell's program uses leaf ``path`` (the encoder-decoder's
    prefill runs the encoder, its decode the decoder)."""
    if cfg.family != "encdec" or shape.kind == "train":
        return True
    if shape.kind == "prefill":
        return path.startswith("enc") or path in ("dec/xattn/wk",
                                                  "dec/xattn/wv")
    return not path.startswith("enc")


def collectives(cfg, shape, grid_shape: Mapping[str, int], rules,
                params: Mapping[str, object], remat: str
                ) -> Tuple[Dict[str, int], Dict[str, float]]:
    """``(counts, bytes by op)`` per device of the layout's collectives
    for one step of the cell; ``params`` is ``launch.specs.param_specs``'
    tree (``LeafSpec`` by path)."""
    counts: Dict[str, int] = {}
    by_op: Dict[str, float] = {}

    def add(op: str, n: int, nbytes: float) -> None:
        if n and nbytes:
            counts[op] = counts.get(op, 0) + n
            by_op[op] = by_op.get(op, 0.0) + n * nbytes

    size = dict(grid_shape)
    train = shape.kind == "train"
    batch = tuple(a for a in rules.batch if size.get(a, 1) > 1)
    n_batch = math.prod(size[a] for a in batch)
    B_dev = shape.global_batch // n_batch \
        if shape.global_batch % n_batch == 0 else shape.global_batch
    tp = rules.tp if size.get(rules.tp, 1) > 1 else None
    for path, leaf in params.items():
        if not _runs(cfg, shape, path):
            continue
        spec = tuple(leaf.spec) + (None,) * (len(leaf.shape)
                                             - len(leaf.spec))
        layers = leaf.shape[0] if path.startswith(_STACKED) else 1
        sharded = {a: size.get(a, 1) for e in spec for a in _axes(e)}
        whole = _leaf_bytes(leaf) / layers
        fsdp = [a for a in rules.fsdp if a in sharded and sharded[a] > 1]
        # the layer's weight as a device holds it after the gathers
        held = whole / math.prod(v for a, v in sharded.items()
                                 if a not in fsdp)
        if fsdp:
            passes = 2 if train and remat != "none" else 1
            add("all-gather", layers * passes, held)
            if train:
                add("reduce-scatter", layers, held)
        elif train and batch and not any(a in sharded for a in batch):
            add("all-reduce", layers, held)
        body = spec[1:] if path.startswith(_STACKED) else spec
        if tp and len(body) >= 2 and tp in _axes(body[-2]) \
                and "/moe/" not in path:
            act = B_dev * _tokens(cfg, shape) * leaf.shape[-1] * 2
            add("all-reduce", layers * (2 if train else 1), act)
    if shape.kind == "decode" and rules.seq and \
            size.get(rules.seq, 1) > 1:
        layers = sum(leaf.shape[0] for p, leaf in params.items()
                     if p.endswith("/attn/wo") and _runs(cfg, shape, p))
        h_dev = cfg.n_heads // size[tp] if tp and \
            cfg.n_heads % size[tp] == 0 else cfg.n_heads
        add("all-reduce", layers, B_dev * h_dev * (cfg.head_dim + 2) * 4)
    return counts, by_op
