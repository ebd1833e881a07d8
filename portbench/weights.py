"""The benchmark's own weights: the decoder's leaves in the program's flat
layout (the JAX reference's flatten order, leaves stacked over layers),
each drawn on the device from the seed in one call.

The layout is a frozen copy for the decoder family with attention blocks,
each with a SwiGLU MLP or an MoE; the harness checks it against the
layout the program reports before it hands the weights over. A leaf is
drawn from N(0, std^2) in float32 by a generator of its own, seeded from
the run's seed and the leaf's index, scaled and cast to the type it is
served in (bf16; the router float32), so the reference can draw any leaf
again after the program's state is freed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

#: (path, shape, std (None: ones), dtype)
Leaf = Tuple[str, Tuple[int, ...], Optional[float], torch.dtype]

BF16, F32 = torch.bfloat16, torch.float32


def vocab_padded(vocab: int) -> int:
    return -(-vocab // 128) * 128


def layout(cfg: Dict) -> List[Leaf]:
    D, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd, L, Vp = cfg["head_dim"], cfg["n_layers"], vocab_padded(cfg["vocab"])
    s = lambda n: 1.0 / math.sqrt(n)
    blk = [("attn/wk", (D, KV * hd), s(D), BF16),
           ("attn/wo", (H * hd, D), s(H * hd), BF16),
           ("attn/wq", (D, H * hd), s(D), BF16),
           ("attn/wv", (D, KV * hd), s(D), BF16)]
    moe = cfg.get("moe")
    if not moe:
        F = cfg["d_ff"]
        blk += [("ffn/w_down", (F, D), s(F), BF16),
                ("ffn/w_gate", (D, F), s(D), BF16),
                ("ffn/w_up", (D, F), s(D), BF16)]
    blk += [("ln1/scale", (D,), None, BF16), ("ln2/scale", (D,), None, BF16)]
    if moe:
        E, Fe = moe["n_experts"], moe["d_ff_expert"]
        blk += [("moe/router", (D, E), s(D), F32),
                ("moe/w_down", (E, Fe, D), s(Fe), BF16),
                ("moe/w_gate", (E, D, Fe), s(D), BF16),
                ("moe/w_up", (E, D, Fe), s(D), BF16)]
    return ([("embed", (Vp, D), 1.0, BF16),
             ("final_norm/scale", (D,), None, BF16)]
            + [(f"groups/blk0/{p}", (L,) + sh, sd, dt)
               for p, sh, sd, dt in blk]
            + [("lm_head", (D, Vp), s(D), BF16)])


def n_params(cfg: Dict) -> int:
    return sum(math.prod(sh) for _, sh, _, _ in layout(cfg))


def _leaf_seed(seed: int, i: int) -> int:
    return (int(seed) * 0x9E3779B1 + (i + 1) * 0x85EBCA6B) % (2 ** 63 - 1)


def draw(cfg: Dict, seed: int, device, index: int,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Leaf ``index`` of :func:`layout`, drawn from the seed, in its own
    dtype or ``dtype``."""
    path, shape, std, dt = layout(cfg)[index]
    if std is None:
        return torch.ones(shape, dtype=dtype or dt, device=device)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, index))
    w = torch.randn(shape, generator=gen, device=device, dtype=F32)
    return w.mul_(std).to(dt).to(dtype or dt)


def tree(cfg: Dict, seed: int, device,
         dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Every leaf, ``{path: tensor}``."""
    return {p: draw(cfg, seed, device, i, dtype)
            for i, (p, _, _, _) in enumerate(layout(cfg))}
