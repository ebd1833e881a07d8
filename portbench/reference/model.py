"""The plain decoder: forward, loss and (through autograd) gradients in
float32, from weights ``{path: tensor}`` in the flat layout of
``portbench/weights.py``.

Each layer is pre-norm: RMSNorm, grouped-query causal attention with
rotary embeddings, a residual; RMSNorm, a SwiGLU MLP or a mixture of
experts, a residual. Then the final RMSNorm, the LM head and the mean
cross-entropy with a z-loss over the tokens.

- RMSNorm: ``x * rsqrt(mean(x^2) + eps) * scale``.
- Rotary embeddings rotate the two halves of each head:
  ``[x1 cos - x2 sin, x1 sin + x2 cos]``, frequencies
  ``theta^(-2i/hd)``, positions from 0.
- Attention: query head ``h`` reads key/value head ``h // (H / KV)``,
  scores over ``sqrt(hd)``, a causal mask, softmax.
- The MoE routes each token by ``softmax(x @ router)``, keeps its
  ``top_k`` experts (ties to the lower id) with their probabilities
  renormalised, and sums the kept experts' SwiGLU outputs weighted.
  Expert parallel over ``n_nodes x n_local`` ranks (the batch over the
  nodes, the experts over a node's ranks): a node's tokens are cut into
  ``n_local`` slices, each slice's routings (token-major, then by rank of
  the pick) go to the rank holding the expert, and a rank takes at most
  ``cap = int(ceil(t * k / n_local) * capacity_factor)`` routings from
  each slice; the rest are dropped (weight 0). The load-balance loss of a
  slice is ``E * sum_e (f_e / k) * P_e`` (``f_e`` the share of the
  slice's routings to expert ``e``, ``P_e`` its mean probability). As the
  program defines it, the loss reports the mean over the nodes of each
  node's first slice, and its gradient is that of the mean over every
  slice.

``prec`` computes every matrix product: :class:`Float32` plainly, and
:class:`Fp8` with both operands rounded to float8 e4m3 against a scale
per tensor first (the control: the next precision below the bf16 the
configuration states). Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


class Float32:
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        s = amax / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


class Fp8(Float32):
    def mm(self, a, b):
        return _RoundFp8.apply(a) @ _RoundFp8.apply(b)


def strict_float32() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, T, H, hd)."""
    B, T, H, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(x, w, cfg, prec):
    B, T, D = x.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = prec.mm(x, w["wq"]).reshape(B, T, H, hd)
    k = prec.mm(x, w["wk"]).reshape(B, T, KV, hd)
    v = prec.mm(x, w["wv"]).reshape(B, T, KV, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    G = H // KV
    q = q.permute(0, 2, 1, 3)                                # B H T hd
    k = k.permute(0, 2, 3, 1).repeat_interleave(G, dim=1)    # B H hd T
    v = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)    # B H T hd
    s = prec.mm(q, k) / math.sqrt(hd)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    o = prec.mm(p, v).permute(0, 2, 1, 3).reshape(B, T, H * hd)
    return prec.mm(o, w["wo"])


def swiglu(x, wg, wu, wd, prec):
    return prec.mm(torch.nn.functional.silu(prec.mm(x, wg))
                   * prec.mm(x, wu), wd)


def ep_capacity(n_tokens: int, tp: int, top_k: int, factor: float) -> int:
    t = -(-n_tokens // tp)
    return max(1, int(-(-t * top_k // tp) * factor))


def moe(x, w, cfg, prec, ep: Tuple[int, int]
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """Expert parallel over ``ep = (n_nodes, n_local)``. Returns (y, aux
    as reported, aux whose gradient is taken, {"kept", "routings"})."""
    m = cfg["moe"]
    E, k = m["n_experts"], m["top_k"]
    B, S, D = x.shape
    nodes, tp = ep
    if B % nodes:
        nodes = 1  # a batch the nodes do not divide is replicated
    T = B // nodes * S
    t = -(-T // tp)
    El = E // tp
    cap = ep_capacity(T, tp, k, m["capacity_factor"])
    tok = x.reshape(nodes, T, D)
    if t * tp > T:
        tok = torch.cat([tok, tok.new_zeros((nodes, t * tp - T, D))], 1)
    sl = tok.reshape(nodes * tp, t, D)                       # slices
    probs = torch.softmax(prec.mm(sl, w["router"]), -1)      # (n*tp, t, E)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, ids = top[..., :k], ids[..., :k]
    wts = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    dest = (ids // El).reshape(nodes * tp, t * k)
    onehot = torch.nn.functional.one_hot(dest, tp)
    pos = (onehot.cumsum(1) - 1).gather(2, dest[..., None])[..., 0]
    kept = (pos < cap).reshape(nodes * tp, t, k)
    flat_x = sl.reshape(-1, D)
    flat_ids = ids.reshape(-1, k)
    gate = (wts * kept).reshape(-1, k)
    y = torch.zeros_like(flat_x)
    wg, wu, wd = (w[n].unbind(0) for n in ("w_gate", "w_up", "w_down"))
    for e in range(E):
        rows, slot = torch.nonzero((flat_ids == e) & (gate != 0),
                                   as_tuple=True)
        if rows.numel():
            out = swiglu(flat_x[rows], wg[e], wu[e], wd[e], prec)
            y = y.index_add(0, rows, out * gate[rows, slot][:, None])
    y = y.reshape(nodes, t * tp, D)[:, :T].reshape(B, S, D)
    counts = torch.zeros((nodes * tp, E), dtype=torch.float32,
                         device=x.device)
    counts.scatter_add_(1, ids.reshape(nodes * tp, -1),
                        torch.ones_like(ids.reshape(nodes * tp, -1),
                                        dtype=torch.float32))
    per_slice = E * ((counts / t) / k * probs.mean(-2)).sum(-1)
    aux_value = per_slice.reshape(nodes, tp)[:, 0].mean()
    return y, aux_value, per_slice.mean(), {
        "kept": int(kept.sum()), "routings": int(kept.numel())}


def forward_loss(wt: Dict[str, torch.Tensor], tokens, labels, cfg: Dict,
                 prec=None, ep: Optional[Tuple[int, int]] = None,
                 z_loss: float = 1e-4):
    """Returns (the loss whose gradient is taken, {"loss": the loss as
    reported, "ce", "aux", "kept", "routings"}). ``wt``: float32 leaves
    (stacked over layers under ``groups/blk0/``)."""
    prec = prec or Float32()
    eps = cfg["norm_eps"]
    h = wt["embed"][tokens.long()]
    aux_v = aux_g = torch.zeros((), device=h.device)
    kept = routings = 0
    # one view a layer (unbind: the backward stacks each leaf once)
    g = {p[len("groups/blk0/"):]: v.unbind(0) for p, v in wt.items()
         if p.startswith("groups/blk0/")}
    for i in range(cfg["n_layers"]):
        lw = {p: v[i] for p, v in g.items()}
        a = {n: lw[f"attn/{n}"] for n in ("wq", "wk", "wv", "wo")}
        h = h + attention(rmsnorm(h, lw["ln1/scale"], eps), a, cfg, prec)
        x = rmsnorm(h, lw["ln2/scale"], eps)
        if cfg.get("moe"):
            mw = {n: lw[f"moe/{n}"] for n in ("router", "w_gate", "w_up",
                                               "w_down")}
            f, av, ag, info = moe(x, mw, cfg, prec, ep)
            aux_v, aux_g = aux_v + av, aux_g + ag
            kept, routings = kept + info["kept"], routings + info["routings"]
        else:
            f = swiglu(x, lw["ffn/w_gate"], lw["ffn/w_up"], lw["ffn/w_down"],
                       prec)
        h = h + f
    logits = prec.mm(rmsnorm(h, wt["final_norm/scale"], eps), wt["lm_head"])
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = (lse - gold + z_loss * lse * lse).mean()
    w_aux = cfg["moe"]["aux_loss_weight"] if cfg.get("moe") else 0.0
    loss = ce + w_aux * aux_g
    ce, aux_v = ce.detach(), aux_v.detach()
    return loss, {"loss": float(ce + w_aux * aux_v), "ce": float(ce),
                  "aux": float(aux_v), "kept": kept, "routings": routings}
