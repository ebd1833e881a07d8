"""Abstract arguments and sharding specs for every (arch x shape) cell
(port of ``repro.launch.specs``).

Nothing here allocates memory: the model, its optimizer state, the batch
and the caches are built on the ``meta`` device, so a 480B-parameter
config costs nothing, and each leaf is described by a :class:`LeafSpec`
(shape, dtype, spec; ``sharding.rules`` specs). Trees are keyed as the
reference's are flattened: the weights, AdamW's ``m``/``v``/master by
their ``models.params.param_shapes`` paths, the decoder's caches
``blk<j>/<name>`` stacked over the pattern cycles, the encoder-decoder's
``k``/``v`` stacked over the layers.

A builder returns a callable and its abstract arguments, as the
reference's returns a jitted function and its ``ShapeDtypeStruct``
arguments. The callable takes concrete arguments in the model's own
layout: a model, its AdamW state and a batch for a train cell
(``train_step(..., rules=, grid=)``); a model, tokens and per-layer caches
for a prefill cell (the last position's logits and the filled caches); a
model, one token per row, the caches and an index for a decode cell; for
the encoder-decoder, frames (``encode`` and ``cross_cache``) or one token
with the cross K/V (``decode_forward``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.layers import attention
from repro_torch.models import decoder, encdec
from repro_torch.models.decoder import DecoderLM, RunFlags
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.sharding import rules as R
from repro_torch.train.step import TrainConfig, train_step


class LeafSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: R.Spec


def model_api(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else decoder


def meta_model(cfg: ModelConfig):
    """The model with uninitialised weights on ``meta``."""
    return (EncDecLM if cfg.family == "encdec" else DecoderLM)(
        cfg, device="meta")


def _leaf(logical, shape, dtype, rules, gshape) -> LeafSpec:
    shape = tuple(shape)
    return LeafSpec(shape, dtype, R.spec_for(logical, shape, rules, gshape))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules, grid
                ) -> Dict[str, LeafSpec]:
    """The train batch of one global step: half the sequence budget frames
    and half tokens for the encoder-decoder, a quarter of the context stub
    patch embeddings for the VLM."""
    B, S = shape.global_batch, shape.seq_len
    gs = R.grid_shape(grid)
    D = cfg.d_model

    def rows(logical, dims, dtype):
        return _leaf(logical, dims, dtype, rules, gs)
    if cfg.family == "encdec":
        return {"frames": rows(("batch", None, None), (B, S // 2, D),
                               torch.bfloat16),
                "tokens": rows(("batch", None), (B, S // 2), torch.int32),
                "labels": rows(("batch", None), (B, S // 2), torch.int32)}
    out = {}
    n_text = S
    if cfg.input_mode == "vl":
        n_patch = S // 4
        n_text = S - n_patch
        out["embeds"] = rows(("batch", None, None), (B, n_patch, D),
                             torch.bfloat16)
    out["tokens"] = rows(("batch", None), (B, n_text), torch.int32)
    out["labels"] = rows(("batch", None), (B, n_text), torch.int32)
    return out


def param_specs(cfg: ModelConfig, rules, grid) -> Dict[str, LeafSpec]:
    """Every weight of the model built on ``meta``: its reference shape,
    its dtype and the spec of its logical axes."""
    flat = FlatParams.of(meta_model(cfg))
    logical = model_api(cfg).logical(cfg)
    gs = R.grid_shape(grid)
    return {p: _leaf(logical[p], flat.shapes[p], flat.tensors[first].dtype,
                     rules, gs)
            for p, _, _, first in flat.spans}


def opt_specs(cfg: ModelConfig, params: Dict[str, LeafSpec], rules, grid,
              ocfg: adamw.AdamWConfig) -> Dict:
    """The AdamW state built on ``meta`` over the model's weights: the step,
    then ``m``, ``v`` (and the master) float32 leaf by leaf through
    ``FlatParams``' layout, sharded like the weights."""
    flat = FlatParams.of(meta_model(cfg))
    state = adamw.init(flat, ocfg)
    logical = adamw.state_logical(model_api(cfg).logical(cfg), ocfg)
    gs = R.grid_shape(grid)
    out = {"step": LeafSpec((), torch.int32, ())}
    for name in ("m", "v", "master"):
        if name in state:
            out[name] = {p: _leaf(logical[name][p], t.shape, t.dtype, rules,
                                  gs)
                         for p, t in flat.tree(state[name]).items()}
    if set(params) != set(out["m"]):
        raise ValueError("the optimizer state's leaves are not the "
                         "weights'")
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, rules, grid
                ) -> Dict[str, LeafSpec]:
    """The decode caches built on ``meta``, in the reference's stacked
    layout; the attention caches take ``attention.cache_pspec`` (the
    context-parallel rules), the recurrent states their logical axes."""
    gs = R.grid_shape(grid)
    kv = (None,) + attention.cache_pspec(cfg, rules, gs)
    model = meta_model(cfg)
    caches = model.init_cache(batch, max_len)
    if cfg.family == "encdec":
        layer = caches[0]
        return {name: LeafSpec((len(caches),) + tuple(t.shape), t.dtype, kv)
                for name, t in sorted(layer.items())}
    n = len(cfg.block_pattern)
    logical = decoder.cache_logical(cfg)
    out = {}
    for path, lg in logical.items():
        blk, name = path.split("/")
        j = int(blk[len("blk"):])
        t = caches[j][name]
        shape = (decoder.n_cycles(cfg),) + tuple(t.shape)
        spec = kv if cfg.block_pattern[j % n] == "attn" else \
            R.spec_for(lg, shape, rules, gs)
        out[path] = LeafSpec(shape, t.dtype, spec)
    return out


def _token_spec(B, S, rules, gs) -> LeafSpec:
    return _leaf(("batch", None), (B, S), torch.int32, rules, gs)


# ---------------------------------------------------------------------------
# step functions per cell kind
# ---------------------------------------------------------------------------


def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, grid, rules,
                     tcfg: TrainConfig):
    """``(fn, (params, opt, batch))``: ``fn(model, opt_state, batch)`` is
    one ``train_step`` of the model over ``grid`` under ``rules``."""
    params = param_specs(cfg, rules, grid)
    opt = opt_specs(cfg, params, rules, grid, tcfg.optimizer)
    batch = batch_specs(cfg, shape, rules, grid)

    def fn(model, opt_state, b, flat=None):
        return train_step(model, opt_state, b, tcfg, flat, rules=rules,
                          grid=grid)
    return fn, (params, opt, batch)


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, grid, rules,
                       flags: RunFlags):
    """``(fn, args)``: the decoder's ``fn(model, tokens, caches)`` gives
    the last position's logits and the caches filled in place; the
    encoder-decoder's ``fn(model, frames)`` its encoder output and cross
    K/V."""
    B, S = shape.global_batch, shape.seq_len
    params = param_specs(cfg, rules, grid)
    gs = R.grid_shape(grid)
    if cfg.family == "encdec":
        frames = _leaf(("batch", None, None), (B, S, cfg.d_model),
                       torch.bfloat16, rules, gs)

        @torch.no_grad()
        def fn(model, fr):
            enc_out = model.encode(fr, flags)
            return enc_out, model.cross_cache(enc_out)
        return fn, (params, frames)

    tokens = _token_spec(B, S, rules, gs)
    caches = cache_specs(cfg, B, S, rules, grid)

    @torch.no_grad()
    def fn(model, tok, c):
        logits, _, new_c = model(tok, caches=c, flags=flags, rules=rules,
                                 grid=grid)
        return logits[:, -1:], new_c
    return fn, (params, tokens, caches)


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, grid, rules,
                      flags: RunFlags):
    """serve_step: one new token a row against a ``seq_len`` cache at an
    index. ``(fn, args)``: ``fn(model, tokens, caches, index)`` for the
    decoder, ``fn(model, tokens, caches, xkv, index)`` with the cross K/V
    for the encoder-decoder; logits and the caches written in place."""
    B, S = shape.global_batch, shape.seq_len
    params = param_specs(cfg, rules, grid)
    gs = R.grid_shape(grid)
    tok = _token_spec(B, 1, rules, gs)
    idx = LeafSpec((), torch.int32, ())
    caches = cache_specs(cfg, B, S, rules, grid)
    if cfg.family == "encdec":
        xkv_shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        xkv_logical = (None, "batch", "seq", "kv_heads", None)
        xkv = {n: _leaf(xkv_logical, xkv_shape, torch.bfloat16, rules, gs)
               for n in ("k", "v")}

        @torch.no_grad()
        def fn(model, t, c, x, i):
            return model.decode_forward(t, None, flags, caches=c,
                                        cache_index=i, xkv=x)
        return fn, (params, tok, caches, xkv, idx)

    @torch.no_grad()
    def fn(model, t, c, i):
        logits, _, new_c = model(t, caches=c, cache_index=i, flags=flags,
                                 rules=rules, grid=grid)
        return logits, new_c
    return fn, (params, tok, caches, idx)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, grid, rules,
               tcfg: TrainConfig = None, flags: RunFlags = None):
    flags = flags or RunFlags()
    if shape.kind == "train":
        return build_train_cell(cfg, shape, grid, rules,
                                tcfg or TrainConfig(flags=flags))
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, grid, rules, flags)
    return build_decode_cell(cfg, shape, grid, rules, flags)
