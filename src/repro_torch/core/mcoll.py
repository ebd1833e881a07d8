"""PiP-MColl multi-object collectives on a rank grid (port of
``repro.core.mcoll``).

The paper's design for a (nodes x procs-per-node) cluster: an intra-node
phase through shared memory, an inter-node phase where all local processes
drive the network at once, and a final reorder. The reference writes each
algorithm as a per-device body under ``shard_map``; here each algorithm is
written once against the :class:`~repro_torch.core.grid.RankGrid`
primitives and takes the *stacked* operand: dim 0 is the flat rank in
row-major ``(node, local)`` order and row ``d`` is rank ``d``'s payload.
Every ``lax.axis_index`` step of the reference becomes per-rank index
arithmetic on those rows (``grid.take``/``roll``/``dynamic_slice``/
``where``), and a masked ``psum`` stays a rank-ordered ``grid.psum``, so
signed zeros come out as the reference's do. ``topo.world`` is always a
group size and ``x.shape[0]`` the rows the grid holds: all ranks on a
``RankGrid``, one node's on a ``ProcessGrid``, whose primitives carry the
other nodes' rows across processes, so every algorithm runs on either.

Algorithms (selectable, ``algo=`` everywhere):
  allgather : pip_mcoll | bruck | recursive_doubling | ring | ring_pipeline
              | single_leader | xla
  scatter   : pip_mcoll | binomial | linear
  broadcast : pip_mcoll | binomial | xla (psum mask)
  allreduce : pip_mcoll (two-level multi-lane) | pip_pipeline (chunked
              two-phase) | recursive_doubling | xla (the grid's psum)
  reduce_scatter : pip_mcoll (nodes, then lanes) | xla (flat rank order)
  alltoall  : pip_mcoll (two-level multi-lane) | pip_pipeline (segmented)
              | xla (tiled)

:data:`CHUNKED` lists the algorithms taking the ``chunks`` pipelining knob
and :data:`COMPRESSED` those taking a ``codec``. Compressed execution
encodes before the slow wire axis and decodes after; codec work runs as one
launch over all ranks (the allreduce encode on ``(ranks * W, Ls)``, every
decode-reduce on ``(ranks, W, ...)``). Compressed broadcast and scatter
are root-encodes-once: the trees forward the wire form leafwise and every
receiver decodes.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import compress as _codecs
from repro_torch.core import telemetry as _tm
from repro_torch.core.topology import Topology

# ---------------------------------------------------------------------------
# helpers (per-rank dims follow the leading rank dim)
# ---------------------------------------------------------------------------


def _axes(topo: Topology) -> Tuple[str, ...]:
    """The topology's grid axes with size > 1 (see Topology.active_axes)."""
    return topo.active_axes


def mo_rounds(n_nodes: int, radix: int) -> Sequence[int]:
    """Step sizes S for the multi-object Bruck schedule (paper steps 2-5):
    full rounds while ``S * B <= N`` then one remainder round."""
    out, s = [], 1
    while s < n_nodes:
        out.append(s)
        s += min((radix - 1) * s, n_nodes - s)
    return out


def _mo_perm(topo: Topology, step: int, n_lanes: int) -> list:
    """Static flat perm for one multi-object round: lane l of node n sends to
    node (n - (l+1)*step) % N."""
    N = topo.n_nodes
    pairs = []
    for n in range(N):
        for l in range(n_lanes):
            dst = ((n - (l + 1) * step) % N)
            pairs.append((topo.flat(n, l), topo.flat(dst, l)))
    return pairs


def _flat_shift_perm(topo: Topology, dist: int) -> list:
    """Flat perm over all M ranks: rank r sends to (r - dist) % M."""
    M = topo.world
    return [(r, (r - dist) % M) for r in range(M)]


def _pad_to(x, mult):
    """Zero-pad each rank's dim 0 (tensor dim 1) to a multiple of ``mult``."""
    pad = (-x.shape[1]) % mult
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))],
                      dim=1)
    return x, pad


def _norm_chunks(chunks, limit) -> int:
    """Chunk count clamped to [1, limit]."""
    return max(1, min(int(chunks), max(1, int(limit))))


def _segments(x, chunks: int, mult: int = 1, axis: int = 0):
    """Split each rank's ``axis`` into ``chunks`` equal segments, zero-padded
    so every segment length is a multiple of ``mult``. Returns (segments,
    seg_len)."""
    dim = 1 + axis
    per = -(-x.shape[dim] // chunks)
    per += (-per) % mult
    pad = per * chunks - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    return [x.narrow(dim, k * per, per) for k in range(chunks)], per


# ---------------------------------------------------------------------------
# compressed execution
# ---------------------------------------------------------------------------


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _check_codec_payload(x, codec: str, collective: Optional[str] = None
                         ) -> None:
    """Two-way codec/payload domain check (see ``compress.admissible``)."""
    cm = _codecs.meta(codec)
    integer = _is_integer(x.dtype)
    if cm.integer_only:
        if not integer:
            raise ValueError(
                f"integer-only codec {codec!r} on float payload dtype "
                f"{x.dtype}: its lossless claim holds only for integer "
                f"payloads")
        if collective in _codecs.REDUCING:
            raise ValueError(
                f"integer-only codec {codec!r} on reducing collective "
                f"{collective!r}: its wire form is not additive")
    elif integer and not cm.lossless:
        raise ValueError(
            f"lossy codec {codec!r} on integer payload dtype "
            f"{x.dtype}: integer collectives must stay lossless "
            f"(codec='none')")


def _wire_axis(topo: Topology) -> Tuple[Optional[str], int]:
    """(axis, size) of the slow axis compression targets: the node axis when
    present, else the local axis; (None, 1) on a 1x1 topology."""
    if topo.n_nodes > 1:
        return topo.node_axis, topo.n_nodes
    if topo.n_local > 1:
        return topo.local_axis, topo.n_local
    return None, 1


def _wire_all_to_all(grid, comp: Dict[str, torch.Tensor], axis: str):
    """Leafwise all-to-all of a wire form over the wire axis (each rank's
    leading dim = per-peer slices): slice i of every peer lands on peer i."""
    return {k: grid.all_to_all(v, axis, 0, 0) for k, v in comp.items()}


def _wire_all_gather(grid, comp: Dict[str, torch.Tensor], axis: str):
    """Leafwise all-gather of a wire form over the wire axis (tiled on each
    rank's leading per-peer dim)."""
    return {k: grid.all_gather(v, axis, tiled=True) for k, v in comp.items()}


def _split0(comp, lead: Tuple[int, int]):
    """Reshape each wire leaf's dim 0 into the two dims ``lead``."""
    return {k: v.reshape(lead + tuple(v.shape[1:])) for k, v in comp.items()}


def _merge01(comp):
    """Merge each wire leaf's (rank, peer) dims into one slice dim."""
    return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in comp.items()}


def _compressed_allreduce(x, topo: Topology, grid, codec: str, err=None):
    """Two-level compressed allreduce with optional error feedback.

    Phases: (1) lossless intra reduce-scatter over the fast axis; (2) each
    rank's slice splits into W wire sub-slices, encoded and exchanged
    reduce-scatter-style over the wire axis; (3) decode + sum + re-encode;
    (4) encoded allgather back over the wire axis, decode; (5) lossless
    intra allgather. ``err`` (shaped like ``x``): each rank adds its carried
    residual before compressing and gets back the fresh residuals of both
    encode sites at the positions it owns post-scatter. Returns
    ``(out, new_err)`` when ``err`` is given. Profiler ranges
    (``core.telemetry``): ``allreduce/intra_reduce_scatter`` (1),
    ``allreduce/wire_reduce_scatter`` (2 and the decode + sum),
    ``allreduce/wire_allgather`` (the re-encode and 4),
    ``allreduce/intra_allgather`` (5) and ``allreduce/residual`` (both
    residuals placed).
    """
    cd = _codecs.codec(codec)
    _check_codec_payload(x, codec, "allreduce")
    dtype, shape = x.dtype, x.shape
    wire, W = _wire_axis(topo)
    if wire is None:
        return (x, err) if err is not None else x
    fast = topo.local_axis if (topo.n_nodes > 1 and topo.n_local > 1) \
        else None
    Pl = topo.n_local if fast else 1
    R = x.shape[0]
    with _tm.span("allreduce/intra_reduce_scatter", cat="allreduce"):
        g = x.float().reshape(R, -1)
        orig = g.shape[1]
        if err is not None:
            g = g + err.float().reshape(R, -1)
        gp, _ = _pad_to(g, Pl)
        s = grid.psum_scatter(gp, fast, tiled=True) if fast else gp
    Lp = s.shape[1]
    Ls = -(-Lp // W)
    with _tm.span("allreduce/wire_reduce_scatter", cat="allreduce"):
        sp, _ = _pad_to(s, W * Ls)
        xs = sp.reshape(R * W, Ls)
        # one encode launch for every rank's W sub-slices
        if err is not None:
            comp, r1 = cd.encode_residual(xs)
        else:
            comp = cd.encode(xs)
        # reduce-scatter over the wire: rank w of each wire group receives
        # sub-slice w of every peer and reduces it in one decode_reduce
        # launch
        mine = cd.decode_reduce(_wire_all_to_all(
            grid, _split0(comp, (R, W)), wire), Ls)
    with _tm.span("allreduce/wire_allgather", cat="allreduce"):
        if err is not None:
            comp2, r2 = cd.encode_residual(mine)
        else:
            comp2 = cd.encode(mine)
        gathered = _wire_all_gather(grid, _split0(comp2, (R, 1)), wire)
        red = cd.decode(_merge01(gathered), Ls).reshape(R, W * Ls)[:, :Lp]
    with _tm.span("allreduce/intra_allgather", cat="allreduce"):
        out = grid.all_gather(red, fast, tiled=True) if fast else red
        out = out[:, :orig].to(dtype).reshape(shape)
    if err is None:
        return out
    # place both residuals at the positions each rank owns: r1 covers its
    # whole scattered slice; r2 belongs to the wire sub-slice it reduced
    with _tm.span("allreduce/residual", cat="allreduce"):
        rows = torch.arange(R, device=x.device)
        res = r1.reshape(R, W, Ls)
        res[rows, grid.axis_index(wire)] += r2
        res = res.reshape(R, W * Ls)[:, :Lp]
        if fast:
            new_err = torch.zeros((R, Pl, Lp), dtype=torch.float32,
                                  device=x.device)
            new_err[rows, grid.axis_index(fast)] = res
            res = new_err.reshape(R, Pl * Lp)
        return out, res[:, :orig].reshape(err.shape)


def _compressed_reduce_scatter(x, topo: Topology, grid, codec: str):
    """Wire-axis compressed reduce-scatter, then lossless intra scatter.

    Nodes first, as the lossless two-level order: every rank encodes its W
    wire sub-slices, the wire all-to-all delivers sub-slice w to wire peer
    w, one decode_reduce launch sums each rank's W received slices, and a
    lossless intra psum_scatter finishes the reduction over the fast axis.
    """
    cd = _codecs.codec(codec)
    _check_codec_payload(x, codec, "reduce_scatter")
    dtype = x.dtype
    wire, W = _wire_axis(topo)
    if wire is None:
        return x
    fast = topo.local_axis if (topo.n_nodes > 1 and topo.n_local > 1) \
        else None
    R, rows = x.shape[0], x.shape[1]
    if rows % topo.world:
        raise ValueError(f"reduce_scatter payload dim0 {rows} must be "
                         f"divisible by world size {topo.world}")
    flat = x.float().reshape(R, -1)
    Ls = flat.shape[1] // W
    comp = cd.encode(flat.reshape(R * W, Ls))
    mine = cd.decode_reduce(_wire_all_to_all(grid, _split0(comp, (R, W)),
                                             wire), Ls)
    if fast:
        mine = grid.psum_scatter(mine, fast, tiled=True)
    return mine.to(dtype).reshape((R, rows // topo.world)
                                  + tuple(x.shape[2:]))


def _compressed_allgather(x, topo: Topology, grid, codec: str):
    """Lossless intra gather into the node block, encoded allgather over
    the wire axis, decode. Node-major order needs no final shift. The
    payload reaches ``encode`` in its own dtype (every codec casts
    internally), so integer-only codecs keep integers off the f32 path."""
    cd = _codecs.codec(codec)
    _check_codec_payload(x, codec, "allgather")
    dtype = x.dtype
    wire, W = _wire_axis(topo)
    if wire is None:
        return x
    fast = topo.local_axis if (topo.n_nodes > 1 and topo.n_local > 1) \
        else None
    nodeblk = grid.all_gather(x, fast, tiled=True) if fast else x
    R = x.shape[0]
    flat = nodeblk.reshape(R, -1)
    L = flat.shape[1]
    gathered = _wire_all_gather(grid, _split0(cd.encode(flat), (R, 1)), wire)
    out = cd.decode(_merge01(gathered), L)
    return out.reshape((R, W * nodeblk.shape[1])
                       + tuple(nodeblk.shape[2:])).to(dtype)


def _compressed_alltoall(x, topo: Topology, grid, codec: str):
    """Hierarchical all-to-all with the wire exchange compressed: the intra
    regroup (when both axes exist) stays lossless, the per-node payloads
    encode before the node-axis exchange and decode after."""
    cd = _codecs.codec(codec)
    _check_codec_payload(x, codec, "alltoall")
    dtype = x.dtype
    N, Pl = topo.n_nodes, topo.n_local
    R, s = x.shape[0], tuple(x.shape[2:])
    if N * Pl == 1:
        return x
    if N > 1:
        v = x.reshape((R, N, Pl) + s)
        if Pl > 1:
            v = grid.all_to_all(v, topo.local_axis, 1, 1)
        flat = v.reshape(R * N, -1)
        comp = _wire_all_to_all(grid, _split0(cd.encode(flat), (R, N)),
                                topo.node_axis)
        out = cd.decode(_merge01(comp), flat.shape[1])
        return out.reshape((R, N * Pl) + s).to(dtype)
    flat = x.reshape(R * Pl, -1)
    comp = _wire_all_to_all(grid, _split0(cd.encode(flat), (R, Pl)),
                            topo.local_axis)
    out = cd.decode(_merge01(comp), flat.shape[1])
    return out.reshape((R, Pl) + s).to(dtype)


def _compressed_broadcast(x, topo: Topology, grid, codec: str,
                          radix: Optional[int], root: int):
    """Root-encodes-once compressed broadcast: encode, run the broadcast
    tree leafwise over the wire form (non-root copies are zero-masked as in
    the lossless tree, so only the root's encoding propagates), decode at
    every receiver — every rank's output is bitwise ``decode(encode(x))``
    of the root's payload."""
    cd = _codecs.codec(codec)
    _check_codec_payload(x, codec, "broadcast")
    flat = x.reshape(x.shape[0], -1)
    comp = {k: _broadcast_tree(v, topo, grid, radix, root)
            for k, v in cd.encode(flat).items()}
    return cd.decode(comp, flat.shape[1]).reshape(x.shape).to(x.dtype)


def _compressed_scatter(xfull, topo: Topology, grid, codec: str,
                        radix: Optional[int], root: int):
    """Root-encodes-once compressed scatter: the root encodes its ``M``
    per-destination slices into one wire form, the scatter tree forwards it
    leafwise, and every rank decodes just its own slice — rank d's output
    is bitwise row d of ``decode(encode(full))``."""
    cd = _codecs.codec(codec)
    _check_codec_payload(xfull, codec, "scatter")
    R, M = xfull.shape[0], topo.world
    m = xfull.shape[1] // M
    flat = xfull.reshape(R * M, -1)
    comp = _split0(cd.encode(flat), (R, M))
    mine = {k: _scatter_tree(v, topo, grid, radix, root)
            for k, v in comp.items()}
    out = cd.decode(_merge01(mine), flat.shape[1])
    return out.reshape((R, m) + tuple(xfull.shape[2:])).to(xfull.dtype)


# ---------------------------------------------------------------------------
# ALLGATHER
# ---------------------------------------------------------------------------


def pip_mcoll_allgather(x, topo: Topology, grid, radix: Optional[int] = None,
                        shift_fn=None, codec: str = "none"):
    """The paper's multi-object allgather (Section 2).

    Per-rank input ``(m, ...)``; output ``(N*P*m, ...)``, the full gather in
    node-major rank order on every rank. Phases: (1) intra all_gather (the
    PiP gather into the node's shared buffer; every lane keeps a copy, it
    sends in phase 2); (2) radix-B rounds, each ONE ppermute over the flat
    ``(node, local)`` ranks moving S node-blocks per lane, plus one intra
    all_gather; (3) paper step 6, the shift into rank order: by default
    ``grid.roll`` by the node index, which on the card is the staging
    kernel ``shift_blocks`` (``kernels/staging.py``); or ``shift_fn(V, n)``
    with ``V`` the stacked ``(world, N, P*m, ...)`` blocks and ``n`` the
    ``(world,)`` node index.

    ``codec != "none"`` switches to the compressed execution."""
    if codec != "none":
        return _compressed_allgather(x, topo, grid, codec)
    N, Pl = topo.n_nodes, topo.n_local
    B = int(radix) if radix else Pl + 1
    if not 2 <= B <= Pl + 1:
        raise ValueError(f"radix {B} must be in [2, P+1={Pl + 1}]")
    R, rest = x.shape[0], tuple(x.shape[2:])
    nodeblk = grid.all_gather(x, topo.local_axis, tiled=True)  # (P*m, ...)
    if N == 1:
        return nodeblk
    n = grid.axis_index(topo.node_axis)
    # V[j] = node-block of node (n + j) % N; identical on all lanes of a node
    V = nodeblk[:, None]
    S = 1
    while S < N:
        K = min((B - 1) * S, N - S)  # fresh node-blocks this round
        n_lanes = min(B - 1, -(-K // S))
        send_cnt = min(S, K)
        recv = grid.ppermute(V[:, :send_cnt], _axes(topo),
                             _mo_perm(topo, S, n_lanes=n_lanes))
        # lane l received offsets (l+1)*S + [0, send_cnt)
        shared = grid.all_gather(recv, topo.local_axis)
        shared = shared.reshape((R, Pl * send_cnt) + tuple(V.shape[2:]))
        V = torch.cat([V, shared[:, :K]], dim=1)
        S += K
    W = shift_fn(V, n) if shift_fn is not None else grid.roll(V, n)
    return W.reshape((R, N * Pl * x.shape[1]) + rest)


def bruck_allgather(x, topo: Topology, grid, radix: int = 2):
    """Flat Bruck over all M = N*P ranks (the paper's "PiP-MPICH" baseline
    at radix 2: log2(M) rounds, every rank a single object)."""
    M = topo.world
    r = grid.axis_index(_axes(topo))
    V = x[:, None]
    S = 1
    while S < M:
        for j in range(1, radix):
            if j * S >= M:
                break
            cnt = min(S, M - j * S)
            # we receive from r + j*S, whose V[:cnt] holds our offsets
            # j*S + [0, cnt)
            recv = grid.ppermute(V[:, :cnt], _axes(topo),
                                 _flat_shift_perm(topo, j * S))
            V = torch.cat([V, recv], dim=1)
        S *= radix
    W = grid.roll(V[:, :M], r)
    return W.reshape((x.shape[0], M * x.shape[1]) + tuple(x.shape[2:]))


def recursive_doubling_allgather(x, topo: Topology, grid):
    """Flat recursive doubling (power-of-two M only)."""
    M = topo.world
    if M & (M - 1):
        raise ValueError("recursive doubling needs power-of-two world size")
    r = grid.axis_index(_axes(topo))
    V = x[:, None]
    S = 1
    while S < M:
        recv = grid.ppermute(V, _axes(topo), [(i, i ^ S) for i in range(M)])
        # bit 0: this rank's half is the lower one, its blocks come first
        bit = ((r // S) % 2).bool()
        V = grid.where(bit, torch.cat([recv, V], dim=1),
                       torch.cat([V, recv], dim=1))
        S *= 2
    return V.reshape((x.shape[0], M * x.shape[1]) + tuple(x.shape[2:]))


def _ring_order(grid, topo: Topology, rows):
    """Stack ring round outputs (rows[i] = block of rank (r - i) % M) and
    reorder them into rank order per rank."""
    M = topo.world
    r = grid.axis_index(_axes(topo))
    idx = (r[:, None] - torch.arange(M, device=r.device)[None, :]) % M
    return grid.take(torch.stack(rows, dim=1), idx)


def ring_allgather(x, topo: Topology, grid):
    """Flat ring: M-1 rounds, bandwidth-optimal, latency-worst."""
    M = topo.world
    perm = _flat_shift_perm(topo, -1)  # r sends to r+1, receives from r-1
    rows, cur = [x], x
    for _ in range(M - 1):
        cur = grid.ppermute(cur, _axes(topo), perm)
        rows.append(cur)
    W = _ring_order(grid, topo, rows)
    return W.reshape((x.shape[0], M * x.shape[1]) + tuple(x.shape[2:]))


def ring_pipeline_allgather(x, topo: Topology, grid, chunks: int = 1):
    """Segmented ring allgather: the block splits into ``chunks`` segments
    with an independent ring chain each (each lane sends segment k while
    receiving segment k+1). ``chunks=1`` is the plain ring."""
    M = topo.world
    m = x.shape[1]
    c = _norm_chunks(chunks, m)
    perm = _flat_shift_perm(topo, -1)
    segs, _ = _segments(x, c)
    rows, cur = [torch.cat(segs, dim=1)], segs
    for _ in range(M - 1):
        cur = [grid.ppermute(s, _axes(topo), perm) for s in cur]
        rows.append(torch.cat(cur, dim=1))
    W = _ring_order(grid, topo, rows)[:, :, :m]
    return W.reshape((x.shape[0], M * m) + tuple(x.shape[2:]))


def single_leader_allgather(x, topo: Topology, grid):
    """Single-object hierarchical baseline: intra gather to a leader,
    leader-only radix-2 Bruck over nodes, intra broadcast (every lane runs
    the node-axis Bruck; the cost model charges only the leader lane)."""
    N, Pl = topo.n_nodes, topo.n_local
    nodeblk = grid.all_gather(x, topo.local_axis, tiled=True)
    if N == 1:
        return nodeblk
    n = grid.axis_index(topo.node_axis)
    V = nodeblk[:, None]
    S = 1
    while S < N:
        cnt = min(S, N - S)
        recv = grid.ppermute(V[:, :cnt], topo.node_axis,
                             [(i, (i - S) % N) for i in range(N)])
        V = torch.cat([V, recv], dim=1)
        S += cnt
    W = grid.roll(V, n)
    return W.reshape((x.shape[0], N * Pl * x.shape[1]) + tuple(x.shape[2:]))


def xla_allgather(x, topo: Topology, grid):
    """The vendor baseline: the grid's tiled all_gather over every rank."""
    return grid.all_gather(x, _axes(topo), tiled=True)


ALLGATHER = {
    "pip_mcoll": pip_mcoll_allgather,
    "bruck": bruck_allgather,
    "recursive_doubling": recursive_doubling_allgather,
    "ring": ring_allgather,
    "ring_pipeline": ring_pipeline_allgather,
    "single_leader": single_leader_allgather,
    "xla": xla_allgather,
}


# ---------------------------------------------------------------------------
# SCATTER (paper Figure 1 collective)
# ---------------------------------------------------------------------------


def _tree_steps(n: int, B: int):
    """(step sizes S, largest first; tree capacity B**rounds) of a radix-B
    tree over ``n`` nodes, by exact integer arithmetic."""
    n_rounds, cap = 1, B
    while cap < n:
        cap *= B
        n_rounds += 1
    return [B ** i for i in range(n_rounds - 1, -1, -1)], cap


def _tree_pairs(topo: Topology, S: int, B: int, root_node: int) -> list:
    """Static flat perm of one multi-object tree round: lane ``l`` of an
    active node ``va`` feeds node ``va + (l+1)*S`` (relative to the root)."""
    N, Pl = topo.n_nodes, topo.n_local
    pairs = []
    for va in range(0, N, S * B):
        for lane in range(Pl):
            tgt = va + (lane + 1) * S
            if tgt < min(va + S * B, N):
                pairs.append((topo.flat((va + root_node) % N, lane),
                              topo.flat((tgt + root_node) % N, lane)))
    return pairs


def _share_round(grid, topo: Topology, recv, keep, is_dst):
    """The PiP shared-buffer write of one tree round: exactly one lane of a
    receiving node is a destination, and its ``recv`` reaches every lane by
    a masked rank-ordered psum over the local axis (as the reference's
    ``psum(where(is_dst, recv, 0))``); nodes that received nothing keep
    ``keep``."""
    seg = grid.psum(grid.where(is_dst, recv, torch.zeros_like(recv)),
                    topo.local_axis)
    got = grid.psum(is_dst.to(torch.int32), topo.local_axis) > 0
    return grid.where(got, seg, keep)


def pip_mcoll_scatter(xfull, topo: Topology, grid,
                      radix: Optional[int] = None, root: int = 0,
                      chunks: int = 1, codec: str = "none"):
    """Multi-object scatter: a radix-(P+1) tree over nodes in which an
    active node's P lanes feed P distinct child nodes in the same round,
    then a free intra-node slice (the PiP shared-memory analogue).

    Per-rank input: the full payload ``(N*P*m, ...)`` (only the root's copy
    is read); output this rank's ``(m, ...)`` shard. ``chunks > 1`` runs
    one tree per segment of every rank's block; ``codec != "none"`` is the
    root-encodes-once compressed execution."""
    M = topo.world
    if xfull.shape[1] % M:
        raise ValueError(f"scatter payload dim0 {xfull.shape[1]} must be "
                         f"divisible by world size {M}")
    m = xfull.shape[1] // M
    c = _norm_chunks(chunks, m)
    if codec != "none":
        def body(seg):
            return _compressed_scatter(seg, topo, grid, codec, radix, root)
    else:
        def body(seg):
            return _scatter_tree(seg, topo, grid, radix, root)
    if c > 1:
        R, rest = xfull.shape[0], tuple(xfull.shape[2:])
        segs, per = _segments(xfull.reshape((R, M, m) + rest), c, axis=1)
        outs = [body(s.reshape((R, M * per) + rest)) for s in segs]
        return torch.cat(outs, dim=1)[:, :m]
    return body(xfull)


def _scatter_tree(xfull, topo: Topology, grid, radix: Optional[int],
                  root: int):
    """One unsegmented multi-object scatter tree (the chunks=1 body)."""
    N, Pl = topo.n_nodes, topo.n_local
    B = int(radix) if radix else Pl + 1
    R, rest = xfull.shape[0], tuple(xfull.shape[2:])
    m = xfull.shape[1] // topo.world
    root_node = root // Pl
    n = grid.axis_index(topo.node_axis)
    l = grid.axis_index(topo.local_axis)
    v = (n - root_node) % N  # relative node id; the root's is 0
    # Rn[j] = node-block of relative node j; valid only on the root so far
    Rn = torch.roll(xfull.reshape((R, N, Pl * m) + rest), -root_node, dims=1)
    Rn = grid.where(v == 0, Rn, torch.zeros_like(Rn))
    if N > 1:
        steps, cap = _tree_steps(N, B)
        # pad to the tree capacity so every send window [(l+1)S, (l+2)S)
        # lies in bounds
        if cap > N:
            Rn = torch.cat([Rn, Rn.new_zeros((R, cap - N) + Rn.shape[2:])],
                           dim=1)
        for S in steps:
            pairs = _tree_pairs(topo, S, B, root_node)
            if not pairs:
                continue
            send = grid.dynamic_slice(Rn, (l + 1) * S, S)
            recv = grid.ppermute(send, _axes(topo), pairs)
            is_dst = (v % S == 0) & ((v // S) % B == l + 1)
            Rn = torch.cat([_share_round(grid, topo, recv, Rn[:, :S], is_dst),
                            Rn[:, S:]], dim=1)
    # intra scatter: lane l takes slice l of the node block (a local copy)
    return grid.dynamic_slice(Rn[:, 0], l * m, m)


def binomial_scatter(xfull, topo: Topology, grid, root: int = 0):
    """Classic radix-2 binomial scatter over the flat rank space (log2(M)
    rounds, one object per node)."""
    M = topo.world
    R, rest = xfull.shape[0], tuple(xfull.shape[2:])
    m = xfull.shape[1] // M
    v = (grid.axis_index(_axes(topo)) - root) % M
    Rb = torch.roll(xfull.reshape((R, M, m) + rest), -root, dims=1)
    Rb = grid.where(v == 0, Rb, torch.zeros_like(Rb))
    S = 1
    while S < M:
        S *= 2
    if S > M:  # pad to the power-of-two capacity: windows stay in bounds
        Rb = torch.cat([Rb, Rb.new_zeros((R, S - M) + Rb.shape[2:])], dim=1)
    S //= 2
    while S >= 1:
        pairs = [((va + root) % M, (va + S + root) % M)
                 for va in range(0, M, S * 2) if va + S < M]
        if pairs:
            recv = grid.ppermute(Rb[:, S:2 * S], _axes(topo), pairs)
            is_dst = (v % S == 0) & ((v // S) % 2 == 1)
            Rb = torch.cat([grid.where(is_dst, recv, Rb[:, :S]), Rb[:, S:]],
                           dim=1)
        S //= 2
    return Rb[:, 0]


def linear_scatter(xfull, topo: Topology, grid, root: int = 0):
    """The root sends to every rank directly (M-1 serial messages) — the
    naive baseline, one per-rank row take from the replicated input."""
    M = topo.world
    R = xfull.shape[0]
    blocks = xfull.reshape((R, M, xfull.shape[1] // M)
                           + tuple(xfull.shape[2:]))
    return grid.take(blocks, grid.axis_index(_axes(topo)))


SCATTER = {
    "pip_mcoll": pip_mcoll_scatter,
    "binomial": binomial_scatter,
    "linear": linear_scatter,
}


# ---------------------------------------------------------------------------
# BROADCAST
# ---------------------------------------------------------------------------


def pip_mcoll_broadcast(x, topo: Topology, grid, radix: Optional[int] = None,
                        root: int = 0, chunks: int = 1, codec: str = "none"):
    """Multi-object broadcast: a radix-(P+1) tree over nodes (an active
    node's P lanes feed P children per round) plus the free intra share.
    ``chunks > 1`` runs one tree per segment of the payload; ``codec !=
    "none"`` is the root-encodes-once compressed execution."""
    c = _norm_chunks(chunks, x.shape[1] if x.dim() > 1 else 1)
    if codec != "none":
        def body(seg):
            return _compressed_broadcast(seg, topo, grid, codec, radix, root)
    else:
        def body(seg):
            return _broadcast_tree(seg, topo, grid, radix, root)
    if c > 1:
        segs, _ = _segments(x, c)
        return torch.cat([body(s) for s in segs], dim=1)[:, :x.shape[1]]
    return body(x)


def _broadcast_tree(x, topo: Topology, grid, radix: Optional[int],
                    root: int):
    """One unsegmented multi-object broadcast tree (the chunks=1 body)."""
    N, Pl = topo.n_nodes, topo.n_local
    B = int(radix) if radix else Pl + 1
    root_node = root // Pl
    n = grid.axis_index(topo.node_axis)
    l = grid.axis_index(topo.local_axis)
    v = (n - root_node) % N
    Rx = grid.where(v == 0, x, torch.zeros_like(x))
    if N > 1:
        steps, _ = _tree_steps(N, B)
        for S in steps:
            pairs = _tree_pairs(topo, S, B, root_node)
            if not pairs:
                continue
            recv = grid.ppermute(Rx, _axes(topo), pairs)
            is_dst = (v % S == 0) & ((v // S) % B == l + 1)
            Rx = _share_round(grid, topo, recv, Rx, is_dst)
    return Rx


def binomial_broadcast(x, topo: Topology, grid, root: int = 0):
    """Radix-2 binomial broadcast over the flat rank space."""
    M = topo.world
    v = (grid.axis_index(_axes(topo)) - root) % M
    Rx = grid.where(v == 0, x, torch.zeros_like(x))
    S = 1
    while S < M:
        S *= 2
    S //= 2
    while S >= 1:
        pairs = [((va + root) % M, (va + S + root) % M)
                 for va in range(0, M, S * 2) if va + S < M]
        if pairs:
            recv = grid.ppermute(Rx, _axes(topo), pairs)
            is_dst = (v % S == 0) & ((v // S) % 2 == 1)
            Rx = grid.where(is_dst, recv, Rx)
        S //= 2
    return Rx


def xla_broadcast(x, topo: Topology, grid, root: int = 0):
    """The vendor broadcast as a psum mask: every copy but the root's is
    zeroed, then one rank-ordered group sum propagates the root's value
    (real data flow from the root; a root value of -0.0 comes out +0.0,
    as the reference's psum gives it)."""
    r = grid.axis_index(_axes(topo))
    return grid.psum(grid.where(r == root, x, torch.zeros_like(x)),
                     _axes(topo))


BROADCAST = {
    "pip_mcoll": pip_mcoll_broadcast,
    "binomial": binomial_broadcast,
    "xla": xla_broadcast,
}


# ---------------------------------------------------------------------------
# ALLREDUCE
# ---------------------------------------------------------------------------


def pip_mcoll_allreduce(x, topo: Topology, grid, inter: str = "psum",
                        codec: str = "none", err=None):
    """Two-level multi-object allreduce: intra reduce-scatter (each lane owns
    1/P of the vector) -> per-lane inter allreduce over nodes (all P lanes
    drive inter links concurrently on disjoint slices) -> intra allgather.

    ``codec != "none"`` (or an ``err`` state) switches to the compressed
    execution, returning ``(out, new_err)`` when ``err`` is given."""
    if codec != "none" or err is not None:
        return _compressed_allreduce(x, topo, grid, codec, err)
    N, Pl = topo.n_nodes, topo.n_local
    orig = x.shape[1]
    xp, _ = _pad_to(x, Pl)
    slice_ = grid.psum_scatter(xp, topo.local_axis, tiled=True)
    if N > 1:
        if inter == "psum":
            slice_ = grid.psum(slice_, topo.node_axis)
        elif inter == "recursive_doubling":
            slice_ = _rd_allreduce_axis(slice_, grid, topo.node_axis, N)
        else:
            raise ValueError(inter)
    out = grid.all_gather(slice_, topo.local_axis, tiled=True)
    return out[:, :orig]


def _rd_allreduce_axis(x, grid, axis: str, size: int):
    """Recursive-doubling allreduce along one grid axis (power of 2)."""
    if size & (size - 1):
        return grid.psum(x, axis)
    S = 1
    while S < size:
        x = x + grid.ppermute(x, axis, [(i, i ^ S) for i in range(size)])
        S *= 2
    return x


def pip_pipeline_allreduce(x, topo: Topology, grid, chunks: int = 1,
                           codec: str = "none", err=None):
    """Pipelined two-phase allreduce: ``chunks`` segments, each an
    independent two-level reduce-scatter (nodes, then lanes) followed by the
    mirrored allgather. ``codec``/``err`` compress each segment on its own
    (``(out, new_err)`` when ``err`` is given)."""
    orig = x.shape[1]
    M = topo.world
    c = _norm_chunks(chunks, orig // M)
    if codec != "none" or err is not None:
        segs, _ = _segments(x, c, mult=M)
        if err is not None:
            err_segs, _ = _segments(err.float(), c, mult=M)
            pairs = [_compressed_allreduce(sg, topo, grid, codec, eg)
                     for sg, eg in zip(segs, err_segs)]
            out = torch.cat([p[0] for p in pairs], dim=1)[:, :orig]
            new_err = torch.cat([p[1] for p in pairs], dim=1)[:, :orig]
            return out, new_err
        outs = [_compressed_allreduce(sg, topo, grid, codec) for sg in segs]
        return torch.cat(outs, dim=1)[:, :orig]
    segs, _ = _segments(x, c, mult=M)
    outs = []
    for seg in segs:
        y = seg
        if topo.n_nodes > 1:
            y = grid.psum_scatter(y, topo.node_axis, tiled=True)
        if topo.n_local > 1:
            y = grid.psum_scatter(y, topo.local_axis, tiled=True)
        if topo.n_local > 1:
            y = grid.all_gather(y, topo.local_axis, tiled=True)
        if topo.n_nodes > 1:
            y = grid.all_gather(y, topo.node_axis, tiled=True)
        outs.append(y)
    return torch.cat(outs, dim=1)[:, :orig]


def flat_rd_allreduce(x, topo: Topology, grid):
    """Flat recursive doubling over all M ranks (single-object baseline)."""
    M = topo.world
    if M & (M - 1):
        return grid.psum(x, _axes(topo))
    S = 1
    while S < M:
        x = x + grid.ppermute(x, _axes(topo), [(i, i ^ S) for i in range(M)])
        S *= 2
    return x


def xla_allreduce(x, topo: Topology, grid):
    """The vendor baseline: the grid's plain group sum."""
    return grid.psum(x, _axes(topo))


ALLREDUCE = {
    "pip_mcoll": pip_mcoll_allreduce,
    "pip_pipeline": pip_pipeline_allreduce,
    "recursive_doubling": flat_rd_allreduce,
    "xla": xla_allreduce,
}


# ---------------------------------------------------------------------------
# REDUCE_SCATTER
# ---------------------------------------------------------------------------


def pip_mcoll_reduce_scatter(x, topo: Topology, grid, codec: str = "none"):
    """Two-level reduce-scatter: over nodes first (big contiguous chunks on
    the inter links, all lanes active), then over lanes. Per-rank input
    ``(M*s, ...)``, output this rank's reduced ``(s, ...)`` chunk. The
    float sums differ in order from ``xla``'s flat one, so the two give
    different bits, each its reference's.

    ``codec != "none"`` encodes the per-node slices before the node-axis
    exchange (see :func:`_compressed_reduce_scatter`)."""
    if codec != "none":
        return _compressed_reduce_scatter(x, topo, grid, codec)
    y = x
    if topo.n_nodes > 1:
        y = grid.psum_scatter(y, topo.node_axis, tiled=True)
    if topo.n_local > 1:
        y = grid.psum_scatter(y, topo.local_axis, tiled=True)
    return y


def xla_reduce_scatter(x, topo: Topology, grid):
    """The vendor baseline: one psum_scatter over every rank, summed in
    flat rank order."""
    return grid.psum_scatter(x, _axes(topo), tiled=True)


REDUCE_SCATTER = {
    "pip_mcoll": pip_mcoll_reduce_scatter,
    "xla": xla_reduce_scatter,
}


# ---------------------------------------------------------------------------
# ALLTOALL (MoE expert-parallel dispatch path)
# ---------------------------------------------------------------------------


def pip_mcoll_alltoall(x, topo: Topology, grid, codec: str = "none"):
    """Hierarchical multi-object all-to-all: intra regroup so each lane
    carries 1/P of every node-pair payload, inter all-to-all per lane (all
    P lanes drive inter links at once), already in flat order after.

    Per-rank input ``(M, s, ...)``: row g is the payload for rank g; output
    ``(M, s, ...)``: row g is the payload received from rank g."""
    if codec != "none":
        return _compressed_alltoall(x, topo, grid, codec)
    N, Pl = topo.n_nodes, topo.n_local
    R, s = x.shape[0], tuple(x.shape[2:])
    v = x.reshape((R, N, Pl) + s)  # (dst_node, dst_lane, s...)
    if Pl > 1:  # -> (dst_node, src_lane, s...)
        v = grid.all_to_all(v, topo.local_axis, 1, 1)
    if N > 1:   # -> (src_node, src_lane, s...)
        v = grid.all_to_all(v, topo.node_axis, 0, 0)
    return v.reshape((R, N * Pl) + s)


def pip_pipeline_alltoall(x, topo: Topology, grid, chunks: int = 1,
                          codec: str = "none"):
    """Segmented hierarchical all-to-all: the per-peer payload (per-rank
    axis 1) splits into ``chunks`` segments, each an independent
    :func:`pip_mcoll_alltoall` chain; compressed segments encode on their
    own. Payloads with no per-peer axis run unsegmented."""
    if x.dim() < 3:
        return pip_mcoll_alltoall(x, topo, grid, codec=codec)
    s0 = x.shape[2]
    c = _norm_chunks(chunks, s0)
    if c == 1:
        return pip_mcoll_alltoall(x, topo, grid, codec=codec)
    segs, _ = _segments(x, c, axis=1)
    outs = [pip_mcoll_alltoall(s, topo, grid, codec=codec) for s in segs]
    return torch.cat(outs, dim=2)[:, :, :s0]


def xla_alltoall(x, topo: Topology, grid):
    """The vendor baseline: one tiled all_to_all over every rank."""
    return grid.all_to_all(x, _axes(topo), 0, 0, tiled=True)


ALLTOALL = {
    "pip_mcoll": pip_mcoll_alltoall,
    "pip_pipeline": pip_pipeline_alltoall,
    "xla": xla_alltoall,
}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY = {
    "allgather": ALLGATHER,
    "scatter": SCATTER,
    "broadcast": BROADCAST,
    "allreduce": ALLREDUCE,
    "reduce_scatter": REDUCE_SCATTER,
    "alltoall": ALLTOALL,
}

#: collective -> algorithms accepting the ``chunks`` pipelining knob
CHUNKED = {
    "allgather": frozenset({"ring_pipeline"}),
    "scatter": frozenset({"pip_mcoll"}),
    "broadcast": frozenset({"pip_mcoll"}),
    "allreduce": frozenset({"pip_pipeline"}),
    "reduce_scatter": frozenset(),
    "alltoall": frozenset({"pip_pipeline"}),
}

#: collective -> algorithms accepting the ``codec`` compression knob
COMPRESSED = {
    "allgather": frozenset({"pip_mcoll"}),
    "scatter": frozenset({"pip_mcoll"}),
    "broadcast": frozenset({"pip_mcoll"}),
    "allreduce": frozenset({"pip_mcoll", "pip_pipeline"}),
    "reduce_scatter": frozenset({"pip_mcoll"}),
    "alltoall": frozenset({"pip_mcoll", "pip_pipeline"}),
}


def supports_chunks(collective: str, algo: str) -> bool:
    """True when ``algo`` accepts the ``chunks`` pipelining knob."""
    return algo in CHUNKED.get(collective, ())


def supports_codec(collective: str, algo: str) -> bool:
    """True when ``algo`` accepts the ``codec`` compression knob."""
    return algo in COMPRESSED.get(collective, ())


def algorithms(collective: str):
    return sorted(_REGISTRY[collective].keys())


def algorithm(collective: str, algo: str):
    """The raw algorithm function, taking ``(x, topo, grid, **knobs)``."""
    return _REGISTRY[collective][algo]
