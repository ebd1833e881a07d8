"""Plain-indexing oracles of the collectives, on their global operands
(the conventions of :mod:`repro_torch.core.runtime`), for checking any
algorithm's result without running another algorithm.

  * :func:`movement` is what allgather, scatter, broadcast and alltoall
    must deliver. Under a lossy codec it is the reference's wire-form
    invariant: each rank receives, bitwise, ``decode(encode(.))`` of the
    rows its source encoded;
  * :func:`exact_sum` is the float64 sum a reduction approximates;
  * :func:`moves_rows` says which plans move rows through the grid's
    staging primitives (``ppermute``, ``roll``, ``take``,
    ``dynamic_slice``), and so launch the staging kernels on the card.
"""
from __future__ import annotations

from repro_torch.core import compress

MOVEMENT = ("allgather", "scatter", "broadcast", "alltoall")

#: (collective, algorithm) pairs whose lossless form moves rows through the
#: staging primitives on a grid with more than one node: the trees, Bruck,
#: the rings and recursive doubling. The reductions' two-level forms, the
#: vendor baselines and the all-to-alls use only the grid's sums, gathers
#: and exchanges.
ROW_MOVERS = frozenset({
    ("allgather", "pip_mcoll"), ("allgather", "bruck"),
    ("allgather", "recursive_doubling"), ("allgather", "ring"),
    ("allgather", "ring_pipeline"), ("allgather", "single_leader"),
    ("scatter", "pip_mcoll"), ("scatter", "binomial"), ("scatter", "linear"),
    ("broadcast", "pip_mcoll"), ("broadcast", "binomial"),
    ("allreduce", "recursive_doubling"),
})


def moves_rows(coll: str, algo: str, codec: str = "none") -> bool:
    """Whether the plan reaches the staging primitives on a 2-node grid.
    A codec keeps the trees of broadcast and scatter (they forward the wire
    form), but the compressed allgather and allreduce gather and exchange
    their wire forms instead."""
    if codec != "none" and coll not in ("broadcast", "scatter"):
        return False
    return (coll, algo) in ROW_MOVERS


def round_trip(codec: str, rows):
    """``decode(encode(rows))`` of a 2-D payload, one wire slice per row,
    in float32."""
    cd = compress.codec(codec)
    rows = rows.float().contiguous()
    return cd.decode(cd.encode(rows), rows.shape[1])


def _wire_source(coll: str, x, n_nodes: int, n_local: int, codec: str):
    """The operand as it arrives after the wire: each slice the source
    encodes, decoded back in place."""
    world = n_nodes * n_local
    if coll == "allgather":  # one slice per node block
        return round_trip(codec, x.reshape(n_nodes, -1)).reshape(x.shape)
    if coll == "scatter":  # the root's per-destination rows
        return round_trip(codec, x.reshape(world, -1)).reshape(x.shape)
    if coll == "broadcast":  # the root's payload, encoded once
        return round_trip(codec, x[None])[0]
    # alltoall: rank (n, l) encodes, per destination node, the rows bound
    # for that node's lane-l ranks after the intra regroup
    N, P = n_nodes, n_local
    y = x.transpose(0, 1).reshape((N, P, N, P, -1))  # [dn, dl, sn, sl, s]
    enc = y.permute(2, 1, 0, 3, 4).reshape(N * P * N, -1)  # [sn, dl, dn, ..]
    dec = round_trip(codec, enc).reshape(N, P, N, P, -1)
    return dec.permute(2, 1, 0, 3, 4).reshape(x.shape[1], x.shape[0],
                                              *x.shape[2:]).transpose(0, 1)


def movement(coll: str, x, n_nodes: int, n_local: int, codec: str = "none"):
    """The result of the data-movement collective ``coll`` on the global
    operand ``x`` of an ``n_nodes x n_local`` grid (stacked where the
    collective stacks), as a view where it can be one."""
    if coll not in MOVEMENT:
        raise ValueError(f"{coll!r} is not a data-movement collective")
    world = n_nodes * n_local
    src = x if codec == "none" else _wire_source(coll, x, n_nodes, n_local,
                                                 codec)
    if coll in ("allgather", "broadcast"):
        return src.expand((world,) + tuple(src.shape))
    if coll == "scatter":
        return src
    return src.transpose(0, 1)


def exact_sum(coll: str, x):
    """The float64 sum over ranks of the stacked operand ``x`` of
    ``allreduce`` (on every rank) or ``reduce_scatter`` (concatenated)."""
    exact = x.double().sum(0)
    if coll == "allreduce":
        return exact.expand((x.shape[0],) + tuple(exact.shape))
    if coll == "reduce_scatter":
        return exact
    raise ValueError(f"{coll!r} is not a reduction")
