"""Mixture-of-Experts with token-choice top-k routing and expert
parallelism (port of ``repro.layers.moe``).

Each token is routed by float32 router logits (softmax, top-k, the k
weights renormalised), its k copies are sorted by expert (a stable sort),
each expert's SwiGLU runs as plain matrix products over its own group of
rows (the reference's ``ragged_dot``, an XLA product, not a Pallas
kernel), and the outputs come back to their tokens weighted and summed.
The group sizes are read to the host once per call to cut the groups.

Expert parallelism (``MoE.forward(x, rules=..., grid=...)``, the
reference's ``apply`` with a mesh and ``_moe_ep_shard``): the experts are
split over the TP axis ``rules.tp`` of a rank grid, ``E / tp`` a TP rank,
and the batch over ``rules.batch``. Every operand carries the grid's
leading flat-rank dim (``core/grid.py``), so the reference's per-device
body runs for all ranks at once:

  * each TP rank routes its ``t = ceil(T / tp)`` slice of its batch
    shard's ``T`` tokens (zero rows pad the last slice) and packs them per
    destination peer into ``cap`` slots (:func:`ep_capacity`), in the flat
    order of the routings (token-major, k-minor); a routing past ``cap``
    is dropped, and an empty slot carries expert ``E/tp - 1`` with its
    ``ok`` flag off;
  * dispatch is three all-to-alls over the TP group
    ``communicator(grid).split(axes=tp)`` (tokens, expert ids, flags),
    with the algorithm ``comm.plan("alltoall", tp * cap * D * itemsize)``
    resolves; the tokens take its ``chunks`` where the algorithm is
    segmented, the ids and flags go unsegmented;
  * each rank's received rows are sorted by expert, its ``E / tp``
    experts run, rows whose flag is off are zeroed;
  * combine is a fourth all-to-all, under ``error_budget > 0`` with a
    plan of its own that may carry a codec (expert outputs tolerate a
    bounded error; tokens and routing metadata always move lossless);
  * each token gathers its k results (a dropped routing's weight is 0),
    sums them, and an all-gather over the TP group rebuilds the shard.

Without a grid, with a TP axis of size 1, or with experts that do not
split over it, the layer runs the single-device path, as the reference
does. The expert-parallel path has no backward yet (ROADMAP.md, queue 1
item 8) and does not run across processes (item 5b).

Expert weights are stored ``(E, D, F)`` and ``(E, F, D)`` as the
reference stores them; the router is float32. Drawing them is done expert
by expert, so the float32 transient is one expert's matrix, not all of
them (at jamba's width the whole ``(16, 8192, 24576)`` array is 12.9 GB in
float32).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import mcoll, runtime
from repro_torch.core.comm import Communicator, communicator
from repro_torch.core.grid import ProcessGrid
from repro_torch.layers import common
from repro_torch.layers.common import Accum, Compute


def _expert_stack(generator, shape, scale, device) -> torch.Tensor:
    """``(E, d_in, d_out)`` drawn from N(0, scale^2) in float32 one expert
    at a time, each cast on its own."""
    w = torch.empty(shape, dtype=Compute, device=device)
    for e in range(shape[0]):
        w[e] = (torch.randn(shape[1:], generator=generator, device=device)
                * scale).to(Compute)
    return w


def ep_capacity(n_tokens: int, tp_size: int, moe) -> int:
    """Dispatch slots per destination peer for ``n_tokens`` tokens of one
    batch shard routed over ``tp_size`` ranks (the reference's
    ``_ep_capacity``): ``capacity_factor`` times the even share of one
    rank's ``ceil(n_tokens / tp) * top_k`` routings."""
    t = -(-n_tokens // tp_size)
    return max(1, int(-(-t * moe.top_k // tp_size) * moe.capacity_factor))


def _route(router: torch.Tensor, tokens: torch.Tensor, k: int):
    """tokens ``(..., t, D)`` -> (weights ``(..., t, k)``, expert ids
    ``(..., t, k)``, probabilities ``(..., t, E)``). Ties go to the lower
    expert id, as ``lax.top_k`` breaks them (a stable descending sort)."""
    probs = torch.softmax(tokens.to(Accum) @ router.to(Accum), -1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :k], ids[..., :k]
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9), ids, probs


def _aux(probs: torch.Tensor, counts: torch.Tensor, moe) -> torch.Tensor:
    """Switch-style load balance ``E * sum_e f_e * P_e``, ``f_e`` the share
    of the routings that went to expert ``e`` (``counts`` over the last
    dim) and ``P_e`` the mean probability; batched over leading dims."""
    E, k = moe.n_experts, moe.top_k
    f = counts.to(Accum) / probs.shape[-2]
    return E * torch.sum(f / k * probs.mean(-2), -1)


class MoE(nn.Module):
    """Weights on ``device`` (the card unless the caller asks for another),
    drawn by ``generator`` (on that device) as the reference's ``init``
    draws them, or left uninitialised for loading."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        dev = common.weights_device(generator, device)
        self.cfg = cfg
        D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
        g = generator
        self.router = common.param(g, (D, E), dev, lambda: common.dense_init(
            g, D, E, dtype=Accum), Accum)
        for name, shape, fan_in in (("w_gate", (E, D, F), D),
                                    ("w_up", (E, D, F), D),
                                    ("w_down", (E, F, D), F)):
            setattr(self, name, common.param(
                g, shape, dev, lambda: _expert_stack(
                    g, shape, 1.0 / math.sqrt(fan_in), dev)))

    def _experts(self, x_sorted: torch.Tensor, counts: List[int],
                 first: int = 0) -> torch.Tensor:
        """The SwiGLU of experts ``first, first + 1, ...`` over their
        groups of the expert-sorted rows (``counts[e]`` rows for expert
        ``first + e``, counts already on the host)."""
        out = torch.empty_like(x_sorted)
        start = 0
        for e, n in enumerate(counts):
            if n:
                rows = x_sorted[start:start + n]
                h = nn.functional.silu(rows @ self.w_gate[first + e]) \
                    * (rows @ self.w_up[first + e])
                out[start:start + n] = h.to(rows.dtype) \
                    @ self.w_down[first + e]
            start += n
        return out

    def forward(self, x: torch.Tensor, rules=None, grid=None,
                error_budget: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, D) -> (y (B, S, D), the load-balance loss, a float32
        scalar: the value the reference's decoder reads, ``aux.mean()``).

        ``grid`` (a ``RankGrid``, or a ``Communicator`` on one) with
        ``rules`` (``sharding.rules.Rules``) asks for the expert-parallel
        path; ``error_budget`` lets its combine all-to-all run compressed.
        The reference's condition picks the single-device path instead: no
        grid, no ``rules.tp`` axis of size > 1 on it, or experts that do
        not split over it."""
        comm = grid if isinstance(grid, Communicator) else None
        if comm is not None:
            grid = comm.grid
        tp = rules.tp if rules is not None else None
        tp_size = grid.shape[tp] if (grid is not None
                                     and tp in grid.axis_names) else 1
        if grid is None or tp_size == 1 or \
                self.cfg.moe.n_experts % tp_size:
            return self._local(x)
        if isinstance(grid, ProcessGrid):
            raise NotImplementedError(
                "expert-parallel MoE across processes (a ProcessGrid) comes "
                "with the process groups of ROADMAP.md, queue 1 item 5b")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, self.router, self.w_gate,
                                          self.w_up, self.w_down)):
            raise NotImplementedError(
                "the expert-parallel MoE has no backward yet: it comes with "
                "the sharded train step (ROADMAP.md, queue 1 item 8)")
        if comm is None:
            comm = communicator(grid)
        return self._expert_parallel(x, rules, grid, comm.split(axes=tp),
                                     float(error_budget))

    def _local(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The single-device path (the reference's ``_moe_local``)."""
        B, S, D = x.shape
        moe = self.cfg.moe
        E, k = moe.n_experts, moe.top_k
        tokens = x.reshape(-1, D)
        w, ids, probs = _route(self.router, tokens, k)
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        x_sorted = tokens.repeat_interleave(k, dim=0)[order]
        counts = torch.bincount(flat, minlength=E)
        out = self._experts(x_sorted, counts.tolist())
        unsorted = torch.empty_like(out)
        unsorted[order] = out
        y = (unsorted.reshape(-1, k, D) * w[..., None].to(out.dtype)).sum(1)
        return y.reshape(B, S, D), _aux(probs, counts, moe)

    def _expert_parallel(self, x: torch.Tensor, rules, grid, comm,
                         error_budget: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``_moe_ep_shard`` for every rank of ``grid`` at
        once, its all-to-alls over the TP group ``comm``."""
        B, S, D = x.shape
        moe = self.cfg.moe
        E, k = moe.n_experts, moe.top_k
        tp = rules.tp
        tp_size = grid.shape[tp]
        El = E // tp_size
        world, dev = grid.world, x.device
        batch_axes = tuple(a for a in (rules.batch or ())
                           if a in grid.axis_names)
        bshard = math.prod(grid.shape[a] for a in batch_axes)
        if B % bshard:
            raise ValueError(f"batch {B} does not split over {batch_axes} "
                             f"({bshard} shards)")
        T = B // bshard * S  # a shard's tokens
        t = -(-T // tp_size)  # a TP rank's routing slice, padded
        cap = ep_capacity(T, tp_size, moe)
        nbytes = tp_size * cap * D * x.element_size()
        dtype = runtime.dtype_name(x.dtype)
        a2a_sel = comm.plan("alltoall", nbytes, dtype=dtype)
        comb_sel = (comm.plan("alltoall", nbytes, dtype=dtype,
                              error_budget=error_budget)
                    if error_budget > 0.0 else a2a_sel)

        # each rank's batch shard (row-major over the batch axes, as a
        # PartitionSpec over several axes splits) and TP index, on the host
        index = [dict(zip(grid.axis_names, divmod(r, grid.n_local)))
                 for r in range(world)]
        shard_of = [0] * world
        for a in batch_axes:
            shard_of = [s * grid.shape[a] + index[r][a]
                        for r, s in enumerate(shard_of)]
        rt_of = [index[r][tp] for r in range(world)]
        shard = torch.tensor(shard_of, device=dev)
        rt = torch.tensor(rt_of, device=dev)
        tokens = x.reshape(bshard, T, D)
        if t * tp_size > T:
            tokens = torch.cat([tokens, tokens.new_zeros(
                (bshard, t * tp_size - T, D))], 1)
        mine = tokens.reshape(bshard, tp_size, t, D)[shard, rt]  # (W, t, D)

        w, ids, probs = _route(self.router, mine, k)
        flat_ids = ids.reshape(world, t * k)
        flat_w = w.reshape(world, t * k)
        dest = flat_ids // El
        onehot = nn.functional.one_hot(dest, tp_size)
        pos = (onehot.cumsum(1) - 1).gather(2, dest[..., None])[..., 0]
        valid = pos < cap
        #: the last expert-parallel call's routing, per rank: the expert
        #: ids (W, t, k) and whether each routing kept its slot (W, t*k)
        self.ep_routing = {"ids": ids, "kept": valid}

        # pack: slot (r, dest, pos) of one flat buffer, every dropped
        # routing into one spare slot past the end (the reference's
        # scatter with mode="drop")
        n_slots = world * tp_size * cap
        r_idx = torch.arange(world, device=dev)[:, None]
        slot = torch.where(valid, (r_idx * tp_size + dest) * cap + pos,
                           n_slots).reshape(-1)
        tok = torch.arange(t * k, device=dev) // k
        send_x = x.new_zeros((n_slots + 1, D))
        send_x[slot] = mine[r_idx, tok[None, :]].reshape(-1, D)
        send_eid = torch.full((n_slots + 1,), El - 1, dtype=torch.int32,
                              device=dev)
        send_eid[slot] = (flat_ids % El).to(torch.int32).reshape(-1)
        send_ok = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
        send_ok[slot] = valid.reshape(-1)
        shape = (world, tp_size, cap)

        fn = mcoll.algorithm("alltoall", a2a_sel.algo)
        kw = ({"chunks": a2a_sel.chunks}
              if mcoll.supports_chunks("alltoall", a2a_sel.algo) else {})
        rx = fn(send_x[:n_slots].view(shape + (D,)), comm.topo, grid, **kw)
        re = fn(send_eid[:n_slots].view(shape), comm.topo, grid)
        rok = fn(send_ok[:n_slots].view(shape), comm.topo, grid)
        rx = rx.reshape(world, tp_size * cap, D)
        re = re.reshape(world, tp_size * cap)
        rok = rok.reshape(world, tp_size * cap)

        # each rank's experts over its received rows, sorted by expert
        eid = torch.where(rok, re, El - 1).long()
        order = torch.argsort(eid, dim=1, stable=True)
        counts = torch.zeros((world, El), dtype=torch.long, device=dev)
        counts.scatter_add_(1, eid, torch.ones_like(eid))
        sizes = counts.tolist()  # the one host read of the call
        x_sorted = rx.gather(1, order[..., None].expand(-1, -1, D))
        out_sorted = torch.stack([self._experts(x_sorted[r], sizes[r],
                                                rt_of[r] * El)
                                  for r in range(world)])
        out = torch.empty_like(out_sorted).scatter_(
            1, order[..., None].expand(-1, -1, D), out_sorted)
        out.masked_fill_(~rok[..., None], 0)

        cfn = mcoll.algorithm("alltoall", comb_sel.algo)
        ckw = ({"chunks": comb_sel.chunks}
               if mcoll.supports_chunks("alltoall", comb_sel.algo) else {})
        if comb_sel.codec != "none" and \
                mcoll.supports_codec("alltoall", comb_sel.algo):
            ckw["codec"] = comb_sel.codec
        back = cfn(out.view(shape + (D,)), comm.topo, grid, **ckw)
        # a dropped routing reads slot cap - 1 (the reference's gather
        # clamps the index cap it gives a dropped routing) and weighs it 0
        gathered = back[r_idx, dest, pos.clamp(max=cap - 1)]
        contrib = gathered * (flat_w * valid)[..., None].to(gathered.dtype)
        y_mine = contrib.reshape(world, t, k, D).sum(2)
        y_all = grid.all_gather(y_mine, tp, tiled=True)[:, :T]

        # the shards' outputs (every TP rank of a shard holds the same),
        # and the reference's aux as its decoder reads it: the mean over
        # the batch shards of the first TP rank 0's routing slice
        lead = [min(r for r in range(world)
                    if shard_of[r] == s and rt_of[r] == 0)
                for s in range(bshard)]
        y = y_all[lead].reshape(B, S, D)
        counts_e = torch.zeros((world, E), dtype=torch.long, device=dev)
        counts_e.scatter_add_(1, flat_ids, torch.ones_like(flat_ids))
        return y, _aux(probs, counts_e, moe)[lead].mean()
