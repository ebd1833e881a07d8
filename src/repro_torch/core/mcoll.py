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
arithmetic on those rows.

Ported in this slice: the allreduce family and the compressed allreduce
with error feedback. Codec work runs as one launch over all ranks: the
encode on ``(ranks * W, Ls)``, the decode-reduce on ``(ranks, W, nb, 256)``.
The other five collectives raise ``NotImplementedError`` (ROADMAP.md,
queue 1).

Algorithms: allreduce = pip_mcoll (two-level multi-lane) | pip_pipeline
(chunked two-phase) | recursive_doubling | xla (the grid's psum).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import compress as _codecs
from repro_torch.core.topology import Topology

#: the collectives of the reference that this package has not ported yet
_NOT_PORTED = ("allgather", "scatter", "broadcast", "reduce_scatter",
               "alltoall")

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
    ``(out, new_err)`` when ``err`` is given.
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
    g = x.float().reshape(R, -1)
    orig = g.shape[1]
    if err is not None:
        g = g + err.float().reshape(R, -1)
    gp, _ = _pad_to(g, Pl)
    s = grid.psum_scatter(gp, fast, tiled=True) if fast else gp
    Lp = s.shape[1]
    Ls = -(-Lp // W)
    sp, _ = _pad_to(s, W * Ls)
    xs = sp.reshape(R * W, Ls)
    # one encode launch for every rank's W sub-slices
    if err is not None:
        comp, r1 = cd.encode_residual(xs)
    else:
        comp = cd.encode(xs)
    # reduce-scatter over the wire: rank w of each wire group receives
    # sub-slice w of every peer and reduces it in one decode_reduce launch
    mine = cd.decode_reduce(_wire_all_to_all(grid, _split0(comp, (R, W)),
                                             wire), Ls)
    if err is not None:
        comp2, r2 = cd.encode_residual(mine)
    else:
        comp2 = cd.encode(mine)
    gathered = _wire_all_gather(grid, _split0(comp2, (R, 1)), wire)
    red = cd.decode(_merge01(gathered), Ls).reshape(R, W * Ls)[:, :Lp]
    out = grid.all_gather(red, fast, tiled=True) if fast else red
    out = out[:, :orig].to(dtype).reshape(shape)
    if err is None:
        return out
    # place both residuals at the positions each rank owns: r1 covers its
    # whole scattered slice; r2 belongs to the wire sub-slice it reduced
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
# registry
# ---------------------------------------------------------------------------

_REGISTRY = {"allreduce": ALLREDUCE}

#: collective -> algorithms accepting the ``chunks`` pipelining knob
CHUNKED = {"allreduce": frozenset({"pip_pipeline"})}

#: collective -> algorithms accepting the ``codec`` compression knob
COMPRESSED = {"allreduce": frozenset({"pip_mcoll", "pip_pipeline"})}


def supports_chunks(collective: str, algo: str) -> bool:
    """True when ``algo`` accepts the ``chunks`` pipelining knob."""
    return algo in CHUNKED.get(collective, ())


def supports_codec(collective: str, algo: str) -> bool:
    """True when ``algo`` accepts the ``codec`` compression knob."""
    return algo in COMPRESSED.get(collective, ())


def _registry(collective: str):
    if collective in _NOT_PORTED:
        raise NotImplementedError(
            f"{collective} is not ported to repro_torch yet (ROADMAP.md, "
            f"queue 1: the other five collectives' algorithms)")
    return _REGISTRY[collective]


def algorithms(collective: str):
    return sorted(_registry(collective).keys())


def algorithm(collective: str, algo: str):
    """The raw algorithm function, taking ``(x, topo, grid, **knobs)``."""
    return _registry(collective)[algo]
