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
    shard's ``T`` tokens (zero rows pad the last slice; a batch that the
    batch axes do not divide is replicated over them, as
    ``sharding.rules.spec_for`` replicates it, where the reference's
    ``shard_map`` refuses it) and packs them per destination peer into
    ``cap`` slots (:func:`ep_capacity`), in the flat order of the
    routings (token-major, k-minor); a routing past ``cap`` is dropped,
    and an empty slot carries expert ``E/tp - 1`` with its ``ok`` flag
    off;
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
does.

On a ``ProcessGrid`` (``core/grid.py``) whose TP group crosses processes
the same path runs with each process holding its ranks' rows: every
process routes every rank's slice (a few small products, so the routings,
the drop counts and the aux are the one-process grid's on every process),
then dispatches, computes and combines for its held ranks only, the four
all-to-alls and the all-gather crossing processes through the grid. The
shards' outputs come back to every process by ``grid.all_rows``
(:class:`_AllRows`), so the layer returns the whole ``(B, S, D)`` there
too. In the backward the held rows' cotangents of the routed tokens and of
the routing weights are gathered back to every rank's (:class:`_HeldRows`)
and each process keeps its own rows of the output's cotangent, so the
router's and ``x``'s gradients are the one-process grid's, bitwise; each
process's experts are a view of the experts of its TP indices
(:class:`_HeldExperts`), whose backward sums each expert's gradient over
the ranks that routed rows to it, in rank order, across processes.
Operations batched over the ranks are batched per rank where a batch's
size could change a reduction's order (the routing is over every rank on
every grid; the sum of a token's ``k`` results runs rank by rank).

The backward (the reference's ``jax.grad`` through its ``shard_map``): an
all-to-all is its own transpose, so each token all-to-all is one
:class:`_AllToAll` whose backward runs the same plan on the cotangent over
the same TP group, and the tiled all-gather of the outputs is one
:class:`_AllGather` whose backward is the group's reduce-scatter. Neither
differentiates through the grid primitives (on the card ``take`` and
``ppermute`` are the ``pack_blocks`` kernel, which has no backward). The
integer metadata all-to-alls carry no gradient. The aux loss's value is
TP rank 0's slice's, averaged over the batch shards, but
its gradient is the mean over every rank's slice: ``shard_map``'s
transpose divides the cotangent of an output unmapped over an axis by
that axis' size and sums the inputs' cotangents over it, so that is the
gradient the reference takes. A compressed combine under grad raises:
the codec's rounding has no derivative and its per-block scale sends a
block's gradient to one element (ROADMAP.md, queue 3).

Under the work counter (``roofline/counter.py``) on ``meta`` the group
sizes have no values to read: each rank's rows split evenly over its
experts (:func:`_group_sizes`; a grouped product's FLOPs depend only on
the rows' total, which is the same), so every rank's expert work has one
shape, and the expert-parallel path runs one rank of each TP index and
counts it once for each of the ranks (:func:`_counted_experts`).

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
from repro_torch.kernels import _dispatch
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


def logical_axes(cfg=None):
    """The weights' logical axes (the reference's ``logical_axes``): the
    experts over TP, each expert's model dim over FSDP."""
    return {"router": (None, None),
            "w_gate": ("experts", "fsdp", None),
            "w_up": ("experts", "fsdp", None),
            "w_down": ("experts", None, "fsdp")}


def ep_capacity(n_tokens: int, tp_size: int, moe) -> int:
    """Dispatch slots per destination peer for ``n_tokens`` tokens of one
    batch shard routed over ``tp_size`` ranks (the reference's
    ``_ep_capacity``): ``capacity_factor`` times the even share of one
    rank's ``ceil(n_tokens / tp) * top_k`` routings."""
    t = -(-n_tokens // tp_size)
    return max(1, int(-(-t * moe.top_k // tp_size) * moe.capacity_factor))


class _AllToAll(torch.autograd.Function):
    """One all-to-all of the TP group, ``fn(x, topo, grid, **kw)``; its
    backward is the same all-to-all of the cotangent (the exchange is a
    permutation that is its own inverse: slot ``j`` of rank ``i`` goes to
    slot ``i`` of rank ``j``)."""

    @staticmethod
    def forward(ctx, x, fn, topo, grid, kw):
        ctx.call = (fn, topo, grid, kw)
        return fn(x, topo, grid, **kw)

    @staticmethod
    def backward(ctx, g):
        fn, topo, grid, kw = ctx.call
        return fn(g.contiguous(), topo, grid, **kw), None, None, None, None


class _HeldRows(torch.autograd.Function):
    """This process's rows (``grid.held_of``) of a tensor every process
    computes for every rank; the backward gathers each process's cotangent
    rows (``grid.all_rows``), so every process holds every rank's."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return grid.held_of(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.all_rows(g.contiguous()), None


class _AllRows(torch.autograd.Function):
    """Every rank's rows (``grid.all_rows``) on every process; the backward
    keeps this process's own rows of the cotangent: every process computes
    the same loss from the whole, so each answers for its own ranks."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return grid.all_rows(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.held_of(g), None


#: bytes of expert gradients gathered at once across processes
_GRAD_CHUNK_BYTES = 256 << 20


class _HeldExperts(torch.autograd.Function):
    """The experts of this process's TP indices, ``[lo, lo + n)`` of one
    ``(E, ...)`` expert weight (a view). The backward makes the whole
    weight's gradient on every process: expert ``e`` of TP index ``j`` is
    the sum of the gradients of the ranks of index ``j`` that routed rows
    to it, in rank order, across processes (a rank that routed none adds
    nothing, as autograd adds nothing for an unused view). Each held row
    sends its index's slice, a chunk of experts at a time (a process's
    first row of an index answers for its others, whose rows autograd has
    already summed)."""

    @staticmethod
    def forward(ctx, w, grid, lo, n, rt_of, used):
        ctx.call = (grid, lo, rt_of, used, w.shape)
        return w.narrow(0, lo, n)

    @staticmethod
    def backward(ctx, g):
        grid, lo, rt_of, used, shape = ctx.call
        tp = max(rt_of) + 1
        El = shape[0] // tp
        held_rt = [rt_of[f] for f in grid.held]
        first = [held_rt.index(j) == i for i, j in enumerate(held_rt)]
        mine = [[any(u[e] for u, j2 in zip(used, held_rt) if j2 == j)
                 and first[i] for e in range(El)]
                for i, j in enumerate(held_rt)]
        users = grid.all_rows(torch.tensor(mine, device=g.device)).tolist()
        out = g.new_empty(shape)
        per = math.prod(shape[1:]) * g.element_size() * grid.world
        step = max(1, min(El, _GRAD_CHUNK_BYTES // max(per, 1)))
        for e0 in range(0, El, step):
            e1 = min(El, e0 + step)
            rows = torch.stack([
                g[(j * El - lo) + e0:(j * El - lo) + e1] if first[i]
                else g.new_zeros((e1 - e0,) + tuple(shape[1:]))
                for i, j in enumerate(held_rt)])
            every = grid.all_rows(rows)  # (world, e1 - e0, ...)
            for e in range(e0, e1):
                for j in range(tp):
                    dst = out[j * El + e]
                    src = [r for r in range(grid.world)
                           if rt_of[r] == j and users[r][e]]
                    if not src:
                        dst.zero_()
                        continue
                    dst.copy_(every[src[0], e - e0])
                    for r in src[1:]:
                        dst += every[r, e - e0]
        return out, None, None, None, None, None


class _AllGather(torch.autograd.Function):
    """``grid.all_gather(x, axes, tiled=True)``; its backward is the
    group's tiled reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, x, grid, axes):
        ctx.call = (grid, axes)
        return grid.all_gather(x, axes, tiled=True)

    @staticmethod
    def backward(ctx, g):
        grid, axes = ctx.call
        return grid.psum_scatter(g.contiguous(), axes, tiled=True), None, \
            None


def _group_sizes(counts: torch.Tensor, rows: int):
    """The rows of each expert group on the host (``counts`` over the last
    dim; ``rows`` their total per leading index): the one host read of a
    call. Under the work counter a ``meta`` call has no values to read:
    the rows split evenly, the first ``rows % groups`` groups one more."""
    if counts.device.type != "meta" or _dispatch.counter() is None:
        return counts.tolist()
    n = counts.shape[-1]
    q, r = divmod(rows, n)
    even = [q + (e < r) for e in range(n)]
    return [even] * counts.shape[0] if counts.dim() == 2 else even


class _Replicas(torch.autograd.Function):
    """Under the work counter: the representatives' expert outputs ``(tp,
    rows, D)`` made into every rank's ``(world, rows, D)`` by TP index,
    uncounted; the backward sums the ranks' cotangents back, uncounted, and
    counts what follows (the representatives' backward) ``n`` times."""

    @staticmethod
    def forward(ctx, rep, rank_tp, counter, n):
        ctx.call = (rank_tp, counter, n, rep.shape[0])
        with counter.hidden():
            return rep[rank_tp]

    @staticmethod
    def backward(ctx, g):
        rank_tp, counter, n, tp = ctx.call
        with counter.hidden():
            g_rep = g.new_zeros((tp,) + tuple(g.shape[1:])).index_add_(
                0, rank_tp, g)
        counter.push_scale(n)
        return g_rep, None, None, None


class _ScaledInputs(torch.autograd.Function):
    """The representatives' inputs (views of them); in the backward, the
    end of their ``n``-fold count."""

    @staticmethod
    def forward(ctx, counter, n, *xs):
        ctx.call = (counter, n)
        out = tuple(x.view_as(x) for x in xs)
        ctx.mark_non_differentiable(*(o for o, x in zip(out, xs)
                                      if not x.requires_grad))
        return out

    @staticmethod
    def backward(ctx, *gs):
        counter, n = ctx.call
        counter.pop_scale(n)
        return (None, None) + gs


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

    def _expert_weights(self):
        """Each expert's three weights as views, one tuple per weight
        (``unbind``): in the backward one node per weight stacks every
        expert's gradient at once, where indexing an expert would
        materialise a zero-filled gradient of the whole ``(E, D, F)``
        weight for each expert and add them up (1.2 s of a 2.0 s train
        step at qwen3-moe's width on an H100 80GB HBM3, PERF.md §6)."""
        return tuple(w.unbind(0) for w in (self.w_gate, self.w_up,
                                           self.w_down))

    def _experts(self, x_sorted: torch.Tensor, counts: List[int],
                 first: int = 0, weights=None) -> torch.Tensor:
        """The SwiGLU of experts ``first, first + 1, ...`` over their
        groups of the expert-sorted rows (``counts[e]`` rows for expert
        ``first + e``, counts already on the host); ``weights`` is
        :meth:`_expert_weights` of the call."""
        wg, wu, wd = weights or self._expert_weights()
        out = torch.empty_like(x_sorted)
        start = 0
        for e, n in enumerate(counts):
            if n:
                rows = x_sorted[start:start + n]
                h = nn.functional.silu(rows @ wg[first + e]) \
                    * (rows @ wu[first + e])
                out[start:start + n] = h.to(rows.dtype) @ wd[first + e]
            start += n
        return out

    def _counted_experts(self, counter, x_sorted, sizes, rt_of, El,
                         weights) -> torch.Tensor:
        """Every rank's expert outputs under the work counter on ``meta``:
        the even split gives every rank the same group sizes, so one rank
        of each TP index runs, counted ``world / tp`` times, forward and
        backward. Exact for the FLOPs; the backward's sums of the ranks'
        cotangents into the shared weights (one add per rank past the
        first) are not counted."""
        world, tp = len(rt_of), max(rt_of) + 1
        n = world // tp
        reps = [rt_of.index(j) for j in range(tp)]
        E = len(weights[0])
        ins = _ScaledInputs.apply(counter, n, x_sorted,
                                  *(w for ws in weights for w in ws))
        xs, flat = ins[0], ins[1:]
        ws = tuple(flat[i * E:(i + 1) * E] for i in range(3))
        with counter.scaled(n):
            rep = torch.stack([self._experts(xs[r], sizes[r], rt_of[r] * El,
                                             ws) for r in reps])
        with counter.hidden():
            rank_tp = torch.tensor(rt_of, device=x_sorted.device)
        return _Replicas.apply(rep, rank_tp, counter, n)

    def forward(self, x: torch.Tensor, rules=None, grid=None,
                error_budget: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, D) -> (y (B, S, D), the load-balance loss, a float32
        scalar: the value the reference's decoder reads, ``aux.mean()``).

        ``grid`` (a ``RankGrid`` or a ``ProcessGrid``, or a
        ``Communicator`` on one) with
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
        out = self._experts(x_sorted, _group_sizes(counts, flat.numel()))
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
            # replicated, as sharding.rules.spec_for replicates a dim its
            # axes do not divide (the production grid's 64 nodes and a
            # batch of 32): every TP group routes the whole batch
            batch_axes, bshard = (), 1
        T = B // bshard * S  # a shard's tokens
        t = -(-T // tp_size)  # a TP rank's routing slice, padded
        cap = ep_capacity(T, tp_size, moe)
        nbytes = tp_size * cap * D * x.element_size()
        dtype = runtime.dtype_name(x.dtype)
        a2a_sel = comm.plan("alltoall", nbytes, dtype=dtype)
        comb_sel = (comm.plan("alltoall", nbytes, dtype=dtype,
                              error_budget=error_budget)
                    if error_budget > 0.0 else a2a_sel)
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, self.router, self.w_gate,
                                      self.w_up, self.w_down))
        codec = comb_sel.codec if mcoll.supports_codec(
            "alltoall", comb_sel.algo) else "none"
        if grad and codec != "none":
            raise ValueError(
                f"the compressed combine ({codec}) has no usable gradient: "
                f"the codec's rounding has zero derivative and its "
                f"per-block amax scale sends each block's gradient to one "
                f"element (at reduced qwen3-moe in float32 the reference's "
                f"w_down gradient under error_budget=0.07 is 805 off a "
                f"lossless maximum of 11.5); train with error_budget=0 or "
                f"call it under no_grad")

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
        # every rank's slice, routed on every process
        mine_all = tokens.reshape(bshard, tp_size, t, D)[shard, rt]

        w, ids, probs = _route(self.router, mine_all, k)
        flat_ids = ids.reshape(world, t * k)
        flat_w = w.reshape(world, t * k)
        dest = flat_ids // El
        onehot = nn.functional.one_hot(dest, tp_size)
        pos = (onehot.cumsum(1) - 1).gather(2, dest[..., None])[..., 0]
        valid = pos < cap
        #: the last expert-parallel call's routing, per rank: the expert
        #: ids (W, t, k) and whether each routing kept its slot (W, t*k)
        self.ep_routing = {"ids": ids, "kept": valid}

        # from here on this process's ranks only (every rank on a grid
        # held by one process)
        split = grid.rows != world
        rows = grid.rows
        rt_h = [rt_of[f] for f in grid.held]
        mine, w_h, ids_h, dest, pos, valid = (
            mine_all, flat_w, flat_ids, dest, pos, valid)
        if split:
            mine, w_h = (_HeldRows.apply(a, grid) for a in (mine, w_h))
            ids_h, dest, pos, valid = (grid.held_of(a) for a in (
                ids_h, dest, pos, valid))

        # pack: slot (r, dest, pos) of one flat buffer, every dropped
        # routing into one spare slot past the end (the reference's
        # scatter with mode="drop")
        n_slots = rows * tp_size * cap
        r_idx = torch.arange(rows, device=dev)[:, None]
        slot = torch.where(valid, (r_idx * tp_size + dest) * cap + pos,
                           n_slots).reshape(-1)
        tok = torch.arange(t * k, device=dev) // k
        send_x = x.new_zeros((n_slots + 1, D))
        send_x[slot] = mine[r_idx, tok[None, :]].reshape(-1, D)
        send_eid = torch.full((n_slots + 1,), El - 1, dtype=torch.int32,
                              device=dev)
        send_eid[slot] = (ids_h % El).to(torch.int32).reshape(-1)
        send_ok = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
        send_ok[slot] = valid.reshape(-1)
        shape = (rows, tp_size, cap)

        fn = mcoll.algorithm("alltoall", a2a_sel.algo)
        kw = ({"chunks": a2a_sel.chunks}
              if mcoll.supports_chunks("alltoall", a2a_sel.algo) else {})
        rx = _AllToAll.apply(send_x[:n_slots].view(shape + (D,)), fn,
                             comm.topo, grid, kw)
        re = fn(send_eid[:n_slots].view(shape), comm.topo, grid)
        rok = fn(send_ok[:n_slots].view(shape), comm.topo, grid)
        rx = rx.reshape(rows, tp_size * cap, D)
        re = re.reshape(rows, tp_size * cap)
        rok = rok.reshape(rows, tp_size * cap)

        # each rank's experts over its received rows, sorted by expert
        eid = torch.where(rok, re, El - 1).long()
        order = torch.argsort(eid, dim=1, stable=True)
        counts = torch.zeros((rows, El), dtype=torch.long, device=dev)
        counts.scatter_add_(1, eid, torch.ones_like(eid))
        sizes = _group_sizes(counts, tp_size * cap)  # the one host read
        x_sorted = rx.gather(1, order[..., None].expand(-1, -1, D))
        j0 = 0
        if split:
            j0, j1 = min(rt_h), max(rt_h) + 1
            weights = tuple(_HeldExperts.apply(
                wt, grid, j0 * El, (j1 - j0) * El, rt_of,
                [[n > 0 for n in sz] for sz in sizes]).unbind(0)
                for wt in (self.w_gate, self.w_up, self.w_down))
        else:
            weights = self._expert_weights()
        counter = _dispatch.counter()
        if counter is not None and x.device.type == "meta" and not split:
            out_sorted = self._counted_experts(counter, x_sorted, sizes,
                                               rt_of, El, weights)
        else:
            out_sorted = torch.stack([
                self._experts(x_sorted[i], sizes[i], (rt_h[i] - j0) * El,
                              weights) for i in range(rows)])
        out = torch.empty_like(out_sorted).scatter_(
            1, order[..., None].expand(-1, -1, D), out_sorted)
        out.masked_fill_(~rok[..., None], 0)

        cfn = mcoll.algorithm("alltoall", comb_sel.algo)
        ckw = ({"chunks": comb_sel.chunks}
               if mcoll.supports_chunks("alltoall", comb_sel.algo) else {})
        if codec != "none":
            ckw["codec"] = codec
        back = _AllToAll.apply(out.view(shape + (D,)), cfn, comm.topo, grid,
                               ckw)
        # a dropped routing reads slot cap - 1 (the reference's gather
        # clamps the index cap it gives a dropped routing) and weighs it 0
        gathered = back[r_idx, dest, pos.clamp(max=cap - 1)]
        contrib = gathered * (w_h * valid)[..., None].to(gathered.dtype)
        y_mine = torch.stack([c.sum(1) for c in contrib.reshape(
            rows, t, k, D)])
        y_all = _AllGather.apply(y_mine, grid, tp)[:, :T]
        if split:
            y_all = _AllRows.apply(y_all, grid)

        # the shards' outputs (every TP rank of a shard holds the same),
        # and the reference's aux as its decoder reads it: the mean over
        # the batch shards of the first TP rank 0's routing slice, with
        # the reference's gradient, the mean over every rank's slice
        lead = [min(r for r in range(world)
                    if shard_of[r] == s and rt_of[r] == 0)
                for s in range(bshard)]
        y = y_all[lead].reshape(B, S, D)
        counts_e = torch.zeros((world, E), dtype=torch.long, device=dev)
        counts_e.scatter_add_(1, flat_ids, torch.ones_like(flat_ids))
        per_rank = _aux(probs, counts_e, moe)
        aux = per_rank[lead].mean()
        if grad:
            every = per_rank.mean()
            aux = aux.detach() + (every - every.detach())
        return y, aux
