"""Plain AdamW over ``{path: tensor}`` leaves in float32, with the global
gradient-norm clip, bias correction and decoupled weight decay, and the
weights stored back in the type the configuration serves them in.

Weight decay applies to the leaves named in ``DECAYED`` alone: the
embedding and the output head. The program's optimizer decides by
substrings of a leaf's path, and its list of exempt substrings holds
``u`` (meant for a recurrent layer's bonus), which every layer's path
(``groups/...``) contains; so of a decoder's leaves only these two decay
there, and the reference states that outcome as its rule. Imports nothing
of the program.
"""
from __future__ import annotations

from typing import Dict

import torch

#: elements of one piece of a large leaf's update
CHUNK = 1 << 26

#: the leaves weight decay applies to
DECAYED = ("embed", "lm_head")


def decays(path: str) -> bool:
    return path in DECAYED


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """The float64 sum of squares of ``x``, a piece at a time."""
    x = x.reshape(-1)
    return sum(torch.sum(x[a:a + CHUNK].double() ** 2)
               for a in range(0, x.numel(), CHUNK))


class AdamW:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, grad_clip
        self.step = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def update(self, w: Dict[str, torch.Tensor],
               g: Dict[str, torch.Tensor],
               store: Dict[str, torch.dtype], take=None):
        """One step on float32 weights ``w`` (updated in place, each then
        rounded to its stored type ``store[path]`` and back) from float32
        gradients ``g``, which it takes over (scaled in place, then
        dropped leaf by leaf). Returns each leaf's clipped gradient norm
        (the gradient the moments took) and, for ``take`` ``{path: flat
        indices}``, those elements of it. Large leaves go in pieces of
        ``CHUNK`` elements, so the temporaries stay small."""
        norm = torch.sqrt(sum(_sumsq(x) for x in g.values())).float()
        scale = torch.clamp(self.clip / (norm + 1e-9), max=1.0)
        self.step += 1
        bc1 = 1.0 - self.b1 ** self.step
        bc2 = 1.0 - self.b2 ** self.step
        norms, picked = {}, {}
        for p in list(g):
            gc = g.pop(p).mul_(scale).reshape(-1)
            norms[p] = float(_sumsq(gc)) ** 0.5
            if take is not None:
                picked[p] = gc[take[p]].clone()
            m = self.m.setdefault(p, torch.zeros_like(gc))
            v = self.v.setdefault(p, torch.zeros_like(gc))
            wp = w[p].view(-1)
            for a in range(0, gc.numel(), CHUNK):
                sl = slice(a, a + CHUNK)
                gi, mi, vi, wi = gc[sl], m[sl], v[sl], wp[sl]
                mi.mul_(self.b1).add_(gi * (1 - self.b1))
                vi.mul_(self.b2).add_(gi * gi * (1 - self.b2))
                u = (mi / bc1).div_(torch.sqrt(vi / bc2).add_(self.eps))
                if self.wd and decays(p):
                    u.add_(self.wd * wi)
                wi.sub_(self.lr * u)
                wi.copy_(wi.to(store[p]).float())
            del gc
        return norms, picked
