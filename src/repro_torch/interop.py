"""Carry state across from the JAX reference, as numpy arrays.

  * :func:`from_reference` turns a reference gradient or parameter tree
    (nested dicts of numpy arrays, as ``jax.device_get`` returns them)
    into the port's stacked flat buffer, leaves in the reference's flatten
    order (dict keys sorted, as ``jax.tree_util`` visits them);
  * :func:`error_state_from_reference` turns the reference's per-bucket
    error-feedback tuple (``init_error_state`` / ``OverlappedGradSync.errs``)
    into the port's layout: views into one flat buffer;
  * :func:`params_from_reference` turns the reference decoder's parameter
    tree (``jax.device_get`` of ``decoder.init``) into the port's
    ``DecoderLM``, unstacking the pattern cycles into layers, and the
    encoder-decoder's (``encdec.init``) into an ``EncDecLM``, unstacking
    the encoder's and the decoder's layers;
  * :func:`opt_state_from_reference` turns the reference's AdamW state
    (``step``, ``m``, ``v`` and ``master``) into the port's flat float32
    buffers (``optim.adamw``), so a run resumes from the reference's state.

Tuning tables need nothing here: ``TuningTable`` writes the same JSON in
both packages.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def flatten_reference(tree, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    """``(path, array)`` leaves of a nested dict tree in ``jax.tree_util``
    order (dict keys sorted); paths join the keys with ``/``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_reference(tree[k], f"{prefix}/{k}" if prefix
                                     else str(k))
        return out
    return [(prefix, np.asarray(tree))]


def from_reference(tree, device="cuda", ranked: bool = True) -> torch.Tensor:
    """The stacked flat float32 buffer ``(world, n)`` for a reference tree.

    ``ranked=True``: every leaf has a leading rank dim ``world`` (a
    per-rank gradient stack); ``ranked=False``: a single copy (parameters),
    returned as ``(1, n)``."""
    leaves = [a if ranked else a[None] for _, a in flatten_reference(tree)]
    world = {a.shape[0] for a in leaves}
    if len(world) != 1:
        raise ValueError(f"leaves disagree on the rank dim: {sorted(world)}")
    flat = np.concatenate([a.reshape(a.shape[0], -1) for a in leaves],
                          axis=1).astype(np.float32)
    return torch.from_numpy(flat).to(device)


def error_state_from_reference(errs: Sequence[np.ndarray], device="cuda"
                               ) -> Tuple[torch.Tensor, ...]:
    """The reference's per-bucket ``(world, n_i)`` error buffers as views
    into one ``(world, sum n_i)`` float32 buffer on ``device``."""
    if not errs:
        return ()
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(e, np.float32) for e in errs], axis=1)).to(device)
    views, off = [], 0
    for e in errs:
        n = np.asarray(e).shape[1]
        views.append(flat[:, off:off + n])
        off += n
    return tuple(views)


def _tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """A numpy array as a tensor on ``device``, dtype kept; bfloat16 arrays
    (``ml_dtypes``, as ``jax.device_get`` returns them) move as their bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree, cfg, device="cuda"):
    """The port's model holding the reference's parameters: a ``DecoderLM``,
    or an ``EncDecLM`` for the encoder-decoder family.

    ``tree`` is the reference's nested dict of numpy arrays: the
    decoder's ``embed``, ``final_norm``, ``lm_head`` and ``groups/blk<j>/
    ...`` stacked over pattern cycles, or the encoder-decoder's ``embed``,
    ``enc_norm``, ``final_norm``, ``lm_head`` and ``enc/...``, ``dec/...``
    stacked over layers. Cycle ``c``, block ``j`` becomes layer
    ``c * len(cfg.block_pattern) + j``; layer ``i`` of ``enc`` becomes
    ``enc.<i>`` (``dec`` alike). Dtypes are kept (a tree cast to float32
    gives a float32 model). Every leaf maps by name, so an MoE block with a
    dense residual (arctic: ``moe`` and ``ffn`` both) and padded heads
    (``head_pad``: ``wq``/``wo`` at the padded width, the pad heads'
    columns and rows zero in the tree) carry across as they are."""
    from repro_torch.models.decoder import DecoderLM, n_cycles
    from repro_torch.models.encdec import EncDecLM

    state: Dict[str, torch.Tensor] = {}
    if cfg.family == "encdec":
        model = EncDecLM(cfg, device="meta")
        depth = {"enc": cfg.enc_layers, "dec": cfg.n_layers}
        for path, a in flatten_reference(tree):
            top, *rest = path.split("/")
            if top not in depth:
                state[".".join([top] + rest)] = _tensor_from_numpy(a, device)
                continue
            if a.shape[0] != depth[top]:
                raise ValueError(f"{path}: {a.shape[0]} layers, config has "
                                 f"{depth[top]}")
            for i in range(depth[top]):
                state[".".join([top, str(i)] + rest)] = \
                    _tensor_from_numpy(a[i], device)
        return _loaded(model, state)
    model = DecoderLM(cfg, device="meta")
    nc, n_pat = n_cycles(cfg), len(cfg.block_pattern)
    for path, a in flatten_reference(tree):
        top, *rest = path.split("/")
        if top != "groups":
            state[".".join([top] + rest)] = _tensor_from_numpy(a, device)
            continue
        blk, *leaf = rest
        j = int(blk[len("blk"):])
        if a.shape[0] != nc:
            raise ValueError(f"{path}: {a.shape[0]} cycles, config has {nc}")
        for c in range(nc):
            state[".".join(["blocks", str(c * n_pat + j)] + leaf)] = \
                _tensor_from_numpy(a[c], device)
    return _loaded(model, state)


def _loaded(model, state: Dict[str, torch.Tensor]):
    """``model`` (on ``meta``) holding ``state``, every weight frozen."""
    model.load_state_dict(state, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def opt_state_from_reference(state, cfg, device="cuda") -> dict:
    """The port's AdamW state (``optim.adamw.init``'s layout) holding the
    reference's: ``step`` as an int, ``m``, ``v`` (and ``master`` when the
    reference keeps one) as float32 ``(n,)`` buffers in the flatten order
    of ``models.params.param_shapes(cfg)``."""
    from repro_torch.models.params import n_params

    out = {"step": int(np.asarray(state["step"]))}
    for key in ("m", "v", "master"):
        if key in state:
            flat = from_reference(state[key], device, ranked=False)[0]
            if flat.numel() != n_params(cfg):
                raise ValueError(f"{key}: {flat.numel()} elements, {cfg.name} "
                                 f"has {n_params(cfg)}")
            out[key] = flat
    return out
