"""Alpha-beta-gamma cost models for multi-object collectives (a copy of
``repro.core.costmodel``: pure Python, so the port keeps it verbatim and
its priors match the reference's on every preset the reference has).

The paper evaluates end-to-end latency on a real cluster (128 x Xeon
Broadwell, 18 ppn, Intel OPA: 100 Gb/s, 97 M msg/s). The model is
instantiated with (a) the paper's cluster constants, (b) the reference's
TPU v5e and host presets and (c) the port's own ``h100_grid``: the preset
``topology.derive_link`` gives every CUDA grid, fitted by :func:`fit_net`
from calibration rows taken on an H100 (a CPU grid takes ``host_cpu``).

Model: a collective is a sequence of rounds. An inter-node round costs
    alpha_inter + (msgs_per_nic - 1)/msg_rate + bytes_per_nic * beta_inter
(the msg_rate term is how the paper's 97 M msg/s NIC injection rate enters —
multi-object designs deliberately spend it to buy rounds). An intra-node
round costs
    alpha_intra + bytes * beta_intra * copy_factor
where copy_factor models the library's intra-node mechanism (PiP = 1 single
copy & no syscall; POSIX SHMEM = 2 copies; CMA/XPMEM = 1 copy + syscall
latency folded into alpha_intra).

Every cost function also returns the round/volume breakdown so tests can
check the shard_map implementations emit exactly the predicted number of
collective-permute rounds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from repro_torch.core import compress as _codecs
from repro_torch.core.mcoll import mo_rounds
from repro_torch.core.topology import Topology

# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetParams:
    """Network/machine constants for the alpha-beta model."""
    name: str
    alpha_inter: float          # s per inter-node message
    beta_inter: float           # s per byte on one NIC / inter link
    alpha_intra: float          # s per intra-node transfer (incl. syscalls)
    beta_intra: float           # s per byte intra-node
    msg_rate: float             # NIC injection rate, messages/s
    copy_factor: float = 1.0    # intra-node copies per transfer
    sync_overhead: float = 0.0  # fixed per-collective sync cost
    flop_rate: float = 2.0e11   # codec elements/s per elementwise pass
    #                             (~HBM-bound: encode/decode are streaming)


# -- the paper's cluster (Sec. 3): Intel OPA, 100 Gb/s, 97 M msg/s ----------
# alpha_inter ~= 1.1 us is the standard MPI pt2pt small-message latency on
# OPA; intra-node constants encode each library's mechanism.

def paper_cluster_pip() -> NetParams:
    """PiP-MColl / PiP: shared address space — single copy, no syscalls."""
    return NetParams("pip", 1.1e-6, 1 / 12.5e9, 0.10e-6, 1 / 20e9, 97e6,
                     copy_factor=1.0)


def paper_cluster_posix_shmem() -> NetParams:
    """POSIX SHMEM (Intel MPI-style): double copy through a shared segment."""
    return NetParams("posix_shmem", 1.1e-6, 1 / 12.5e9, 0.25e-6, 1 / 20e9,
                     97e6, copy_factor=2.0)


def paper_cluster_cma() -> NetParams:
    """CMA/kernel-assisted (MVAPICH2-style): single copy but syscall+page
    fault overhead on every transfer."""
    return NetParams("cma", 1.1e-6, 1 / 12.5e9, 0.80e-6, 1 / 20e9, 97e6,
                     copy_factor=1.0)


def paper_cluster_openmpi() -> NetParams:
    """OpenMPI default (btl/vader two-sided): copy-in/copy-out."""
    return NetParams("openmpi", 1.2e-6, 1 / 12.5e9, 0.45e-6, 1 / 20e9, 97e6,
                     copy_factor=2.0)


def paper_cluster_pip_mpich() -> NetParams:
    """PiP-MPICH baseline: PiP memory but flat single-object algorithms and
    the message-size synchronization the paper calls out."""
    return NetParams("pip_mpich", 1.1e-6, 1 / 12.5e9, 0.10e-6, 1 / 20e9,
                     97e6, copy_factor=1.0, sync_overhead=1.5e-6)


# -- TPU v5e presets ---------------------------------------------------------
# intra = ICI (one pod axis), inter = DCN between pods.

def tpu_v5e_pod() -> NetParams:
    return NetParams("tpu_v5e_ici", alpha_inter=1.0e-6, beta_inter=1 / 4.5e10,
                     alpha_intra=0.8e-6, beta_intra=1 / 9.0e10, msg_rate=1e8)


def tpu_v5e_multipod() -> NetParams:
    return NetParams("tpu_v5e_dcn", alpha_inter=1.0e-5, beta_inter=1 / 2.5e10,
                     alpha_intra=1.0e-6, beta_intra=1 / 4.5e10, msg_rate=1e7)


def host_cpu() -> NetParams:
    """Forced host-platform CPU "devices" (dev boxes, CI): every transfer is
    an in-process memcpy; constants keep relative algorithm ordering sane for
    calibration runs, absolute times come from measurement."""
    return NetParams("host_cpu", alpha_inter=5.0e-7, beta_inter=1 / 2.0e10,
                     alpha_intra=2.0e-7, beta_intra=1 / 5.0e10, msg_rate=1e8)


def host_ipc() -> NetParams:
    """Cross-process boundary between local ``torch.distributed`` processes
    (gloo over loopback, ``core.grid.ProcessGrid``'s node axis): far higher
    latency and lower bandwidth than in-process memcpy, which is exactly
    the intra/inter asymmetry the multi-leader algorithms exploit. The
    reference's constants, not fitted to the port's transport."""
    return NetParams("host_ipc", alpha_inter=6.0e-6, beta_inter=1 / 8.0e9,
                     alpha_intra=2.0e-7, beta_intra=1 / 5.0e10, msg_rate=2e7)


def h100_grid() -> NetParams:
    """Ranks as rows of one H100's memory (``RankGrid`` on CUDA), where
    every "transfer" is a device copy that the host queues. Fitted by
    :func:`fit_net` to the 232 lossless rows of the calibration in
    ``chip_smoke.py`` phase 7 (the 2x4 grid and its ``("node",)``,
    ``("local",)`` and ``("node", "local")`` groups at 8 B and 4 MiB per
    rank; host clock around a device synchronize, median of 10) of run A
    in the slice-11 Findings of PERF.md (§5 lists the constants and
    residuals), on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit. The times are host-bound, so the per-call and per-round terms
    hold the host's dispatch. ``copy_factor`` is 1 by structure (one
    address space, the PiP premise); ``flop_rate`` is the model's default
    (it prices codec passes only, outside the fit)."""
    return NetParams("h100_grid", alpha_inter=7.982011259591635e-06,
                     beta_inter=2.9427982903096653e-12,
                     alpha_intra=1.184563558386481e-06,
                     beta_intra=1.6389123702408176e-12,
                     msg_rate=97774.70672865363, copy_factor=1.0,
                     sync_overhead=0.00010593640868191727)


# name -> factory; the string side of Topology.node_link / local_link.
NET_PRESETS = {
    "pip": paper_cluster_pip,
    "posix_shmem": paper_cluster_posix_shmem,
    "cma": paper_cluster_cma,
    "openmpi": paper_cluster_openmpi,
    "pip_mpich": paper_cluster_pip_mpich,
    "tpu_v5e_ici": tpu_v5e_pod,
    "tpu_v5e_dcn": tpu_v5e_multipod,
    "host_cpu": host_cpu,
    "host_ipc": host_ipc,
    "h100_grid": h100_grid,
}

_DEFAULT_PRESET = "tpu_v5e_dcn"


def resolve_net(spec) -> NetParams:
    """A NetParams from a preset name, a NetParams instance, or None
    (selector default)."""
    if spec is None:
        spec = _DEFAULT_PRESET
    if isinstance(spec, NetParams):
        return spec
    try:
        return NET_PRESETS[spec]()
    except KeyError:
        raise ValueError(f"unknown net preset {spec!r}; "
                         f"one of {sorted(NET_PRESETS)}") from None


def net_for(topo) -> NetParams:
    """Compose a Topology's per-axis link metadata into one NetParams.

    The inter-level constants (alpha_inter, beta_inter, msg_rate) come from
    ``topo.node_link``, the intra-level ones (alpha_intra, beta_intra,
    copy_factor, sync_overhead) from ``topo.local_link``; a missing link
    falls back to the other level's preset, then to the default preset.
    """
    inter = resolve_net(topo.node_link if topo.node_link is not None
                        else topo.local_link)
    intra = resolve_net(topo.local_link if topo.local_link is not None
                        else topo.node_link)
    if inter == intra:
        return inter
    return NetParams(
        name=f"{inter.name}+{intra.name}",
        alpha_inter=inter.alpha_inter, beta_inter=inter.beta_inter,
        alpha_intra=intra.alpha_intra, beta_intra=intra.beta_intra,
        msg_rate=inter.msg_rate, copy_factor=intra.copy_factor,
        sync_overhead=max(inter.sync_overhead, intra.sync_overhead),
        flop_rate=intra.flop_rate)


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CostBreakdown:
    algo: str
    inter_rounds: int
    inter_bytes_per_nic: float
    inter_msgs_per_nic: int
    intra_rounds: int
    intra_bytes: float
    time: float

    def us(self) -> float:
        return self.time * 1e6


def _round_time(net: NetParams, msgs: int, nic_bytes: float) -> float:
    if msgs == 0:
        return 0.0
    return net.alpha_inter + (msgs - 1) / net.msg_rate + nic_bytes * net.beta_inter


def _intra_time(net: NetParams, rounds: int, total_bytes: float) -> float:
    return rounds * net.alpha_intra + total_bytes * net.beta_intra * net.copy_factor


def _log2_rounds(x: int) -> int:
    return max(0, math.ceil(math.log2(x))) if x > 1 else 0


# ---------------------------------------------------------------------------
# chunked pipelining: (C + P/c·beta) · (rounds + c - 1)
# ---------------------------------------------------------------------------
#
# A chunked collective runs `rounds` uniform stages per segment with c
# independent segments in flight: total latency is the classic pipeline
# fill-drain form (C + B/c·beta)·(rounds + c − 1), where C is the per-stage
# latency (alpha + injection), B the per-stage NIC bytes at c=1. Chunking
# trades (c−1) extra stage latencies for a c-fold smaller serialized wire
# term — a large-message win, a small-message loss, with an analytic
# optimum c* = sqrt(B·beta·(rounds−1)/C).

#: default upper bound on planned chunk counts (keeps unrolled per-segment
#: chains bounded in compile time and exec-cache keys finite)
MAX_CHUNKS = 64


def pipeline_time(stage_alpha: float, stage_bytes: float, beta: float,
                  rounds: int, chunks: int) -> float:
    """Latency of ``rounds`` uniform pipelined stages over ``chunks``
    segments: ``(C + B/c·beta) · (rounds + c − 1)``."""
    c = max(1, int(chunks))
    return (stage_alpha + (stage_bytes / c) * beta) * (rounds + c - 1)


def optimal_pipeline_chunks(stage_alpha: float, stage_bytes: float,
                            beta: float, rounds: int,
                            cap: int = MAX_CHUNKS) -> int:
    """Analytic minimizer of :func:`pipeline_time` over c, clamped to
    [1, cap] and snapped to the better integer neighbor:
    ``c* = sqrt(B·beta·(rounds−1)/C)``."""
    if rounds <= 1 or stage_alpha <= 0 or stage_bytes <= 0 or beta <= 0:
        return 1
    c = math.sqrt(stage_bytes * beta * (rounds - 1) / stage_alpha)
    lo = int(max(1, min(cap, math.floor(c))))
    hi = int(max(1, min(cap, lo + 1)))
    return min((lo, hi), key=lambda k: pipeline_time(
        stage_alpha, stage_bytes, beta, rounds, k))


@dataclasses.dataclass(frozen=True)
class PipelineTerms:
    """Uniform-stage decomposition of one pipelined (collective, algo):
    latency = fixed + pipeline_time(stage_alpha, stage_bytes, beta,
    rounds, chunks)."""
    stage_alpha: float   # per-stage latency C (alpha + injection serialization)
    stage_bytes: float   # per-stage NIC bytes B at chunks=1
    beta: float          # s/byte on the stage's link
    rounds: int          # stages per segment
    fixed: float         # unpipelined cost (intra staging passes, sync)


def pipeline_terms(collective: str, algo: str, topo: Topology, m: int,
                   net: NetParams):
    """The stage decomposition for a pipelined (collective, algo) pair, or
    ``None`` when the pair has no pipelined form (or the topology leaves it
    no rounds to overlap). ``m`` follows each cost function's size
    convention."""
    N, P = topo.n_nodes, topo.n_local
    M = topo.world
    inter = N > 1
    alpha = net.alpha_inter if inter else net.alpha_intra
    beta = net.beta_inter if inter else net.beta_intra * net.copy_factor
    if collective == "allgather" and algo == "ring_pipeline":
        if M <= 1:
            return None
        # flat ring: M-1 stages, each boundary NIC carries one block of m
        return PipelineTerms(alpha, float(m), beta, M - 1,
                             net.sync_overhead)
    if collective == "allreduce" and algo == "pip_pipeline":
        if inter:
            # intra RS + AG (unpipelined staging) ...
            fixed = net.sync_overhead + _intra_time(
                net, 2 * _log2_rounds(P), 2 * (P - 1) / max(P, 1) * m)
            # ... then per-lane ring RS+AG over nodes: 2(N-1) stages, all P
            # lanes concurrently inject (m/P)/N each -> m/N per NIC stage
            stage_a = net.alpha_inter + (P - 1) / net.msg_rate
            return PipelineTerms(stage_a, m / N, net.beta_inter,
                                 2 * (N - 1), fixed)
        if P <= 1:
            return None
        # flat single level: ring RS+AG over the local axis
        return PipelineTerms(alpha, m / P, beta, 2 * (P - 1),
                             net.sync_overhead)
    if collective == "alltoall" and algo == "pip_pipeline":
        if inter:
            fixed = net.sync_overhead + _intra_time(
                net, 1, m * (P - 1) / max(P, 1))
            stage_a = net.alpha_inter + (P - 1) / net.msg_rate
            return PipelineTerms(stage_a, P * m / N, net.beta_inter,
                                 N - 1, fixed)
        if P <= 1:
            return None
        return PipelineTerms(alpha, m / P, beta, P - 1, net.sync_overhead)
    if collective == "scatter" and algo == "pip_mcoll":
        if not inter:
            return None  # pure intra slice: nothing to pipeline
        B = P + 1
        n_rounds, cap = 1, B
        while cap < N:
            cap *= B
            n_rounds += 1
        # total root-NIC bytes from the unchunked tree, spread uniformly
        total = 0.0
        for S in (B ** i for i in range(n_rounds - 1, -1, -1)):
            nlanes = min(B - 1, max(1, math.ceil(N / S) - 1))
            total += sum(min(S, max(0, N - (j + 1) * S)) * P * m
                         for j in range(nlanes))
        stage_a = net.alpha_inter + (B - 2) / net.msg_rate
        fixed = net.sync_overhead + _intra_time(net, 1, m)
        return PipelineTerms(stage_a, total / n_rounds, net.beta_inter,
                             n_rounds, fixed)
    if collective == "broadcast" and algo == "pip_mcoll":
        if not inter:
            return None
        B = P + 1
        n_rounds, cap = 1, B
        while cap < N:
            cap *= B
            n_rounds += 1
        lanes = min(P, max(1, N - 1))
        stage_a = net.alpha_inter + (lanes - 1) / net.msg_rate
        fixed = net.sync_overhead + _intra_time(net, 1, m)
        return PipelineTerms(stage_a, float(lanes * m), net.beta_inter,
                             n_rounds, fixed)
    return None


def optimal_chunks(collective: str, algo: str, topo: Topology, m: int,
                   net: NetParams, cap: int = MAX_CHUNKS) -> int:
    """Analytic optimal chunk count for one pipelined pair on one message
    size (1 when the pair is not pipelined or pipelining cannot help)."""
    terms = pipeline_terms(collective, algo, topo, m, net)
    if terms is None:
        return 1
    return optimal_pipeline_chunks(terms.stage_alpha, terms.stage_bytes,
                                   terms.beta, terms.rounds, cap)


def pipeline_crossover_bytes(collective: str, algo: str, topo: Topology,
                             net: NetParams, sizes=None):
    """Smallest swept message size at which the optimally-chunked variant
    strictly beats ``chunks=1`` for one pipelined pair — the pipelining
    crossover. None when chunking never wins on the sweep (latency-bound
    topology or no rounds to overlap)."""
    fn = COST_FNS[collective]
    for s in (tuple(sizes) if sizes else tuple(2 ** i for i in range(6, 27))):
        c = optimal_chunks(collective, algo, topo, s, net)
        if c > 1 and (fn(algo, topo, s, net, chunks=c).time
                      < fn(algo, topo, s, net, chunks=1).time):
            return int(s)
    return None


def _pipelined_breakdown(collective: str, algo: str, topo: Topology, m: int,
                         net: NetParams, chunks):
    """CostBreakdown for a pipelined pair via the uniform-stage model, or
    None when the topology leaves the pair nothing to pipeline."""
    terms = pipeline_terms(collective, algo, topo, m, net)
    if terms is None:
        return None
    c = max(1, int(chunks or 1))
    t = terms.fixed + pipeline_time(terms.stage_alpha, terms.stage_bytes,
                                    terms.beta, terms.rounds, c)
    ib = terms.stage_bytes * terms.rounds
    if topo.n_nodes > 1:
        return CostBreakdown(algo, terms.rounds, ib, terms.rounds, 0, 0.0, t)
    return CostBreakdown(algo, 0, 0.0, 0, terms.rounds, ib, t)


# ----------------------------- ALLGATHER -----------------------------------


def allgather_cost(algo: str, topo: Topology, m: int, net: NetParams,
                   radix: int | None = None,
                   chunks: int | None = None) -> CostBreakdown:
    """m = bytes contributed per process. Result = N*P*m bytes everywhere."""
    N, P = topo.n_nodes, topo.n_local
    M = topo.world
    t = net.sync_overhead
    if algo == "ring_pipeline":
        bd = _pipelined_breakdown("allgather", algo, topo, m, net, chunks)
        return bd or CostBreakdown(algo, 0, 0.0, 0, 0, 0.0, t)
    if algo == "pip_mcoll":
        B = radix or (P + 1)
        steps = mo_rounds(N, B)
        # intra gather (tree over P):
        ir = _log2_rounds(P)
        ib = (P - 1) * m
        t += _intra_time(net, ir, ib)
        inter_bytes = 0.0
        msgs = 0
        s_cum = 1
        for S in steps:
            K = min((B - 1) * S, N - s_cum)  # useful fresh blocks
            nlanes = min(B - 1, -(-K // S))  # only useful lanes send
            lane_bytes = min(S, K) * P * m   # single-lane remainder is exact
            s_cum += K
            nic_bytes = nlanes * lane_bytes
            inter_bytes += nic_bytes
            msgs += nlanes
            t += _round_time(net, nlanes, nic_bytes)
            # PiP shared-buffer write of the received fragments (per lane,
            # parallel): one store pass
            t += _intra_time(net, 1, lane_bytes)
            ir += 1
            ib += lane_bytes
        # final shift: single memcpy pass over the result
        t += _intra_time(net, 1, N * P * m)
        ir += 1
        ib += N * P * m
        return CostBreakdown(algo, len(steps), inter_bytes, msgs, ir, ib, t)
    if algo in ("recursive_doubling", "bruck"):
        rounds = _log2_rounds(M)
        inter_bytes = 0.0
        intra_bytes = 0.0
        inter_rounds = 0
        intra_rounds = 0
        msgs = 0
        S = 1
        for i in range(rounds):
            vol = min(S, M - S) * m          # per-process send volume
            if S < P:                         # mostly intra-node partners
                intra_rounds += 1
                intra_bytes += vol
                t += _intra_time(net, 1, vol)
            else:
                inter_rounds += 1
                nic_bytes = P * vol           # all P procs cross the NIC
                inter_bytes += nic_bytes
                msgs += P
                t += _round_time(net, P, nic_bytes)
            S *= 2
        return CostBreakdown(algo, inter_rounds, inter_bytes, msgs,
                             intra_rounds, intra_bytes, t)
    if algo == "ring":
        # M-1 rounds; each round the NIC carries one boundary message of m.
        rounds = M - 1
        for _ in range(rounds):
            t += max(_round_time(net, 1, m), _intra_time(net, 1, m))
        return CostBreakdown(algo, rounds, rounds * m, rounds, 0, (M - 1) * m, t)
    if algo == "single_leader":
        ir = _log2_rounds(P)
        ib = (P - 1) * m
        t += _intra_time(net, ir, ib)
        inter_bytes = 0.0
        msgs = 0
        S = 1
        steps = 0
        while S < N:
            vol = min(S, N - S) * P * m      # leader ships S node-blocks
            inter_bytes += vol
            msgs += 1
            t += _round_time(net, 1, vol)
            S += min(S, N - S)
            steps += 1
        # leader broadcasts the N*P*m result intra-node (tree)
        br = _log2_rounds(P)
        t += _intra_time(net, br, N * P * m)
        return CostBreakdown(algo, steps, inter_bytes, msgs, ir + br,
                             ib + N * P * m, t)
    if algo == "xla":
        # vendor collective: model as bidirectional ring (bandwidth optimal)
        rounds = M - 1
        for _ in range(rounds):
            t += max(net.alpha_inter / 2 + m * net.beta_inter / 2,
                     _intra_time(net, 1, m))
        return CostBreakdown(algo, rounds, rounds * m / 2, rounds, 0,
                             (M - 1) * m, t)
    raise ValueError(algo)


# ----------------------------- SCATTER --------------------------------------


def scatter_cost(algo: str, topo: Topology, m: int, net: NetParams,
                 radix: int | None = None,
                 chunks: int | None = None) -> CostBreakdown:
    """m = bytes delivered per process (root holds N*P*m)."""
    N, P = topo.n_nodes, topo.n_local
    M = topo.world
    t = net.sync_overhead
    if algo == "pip_mcoll" and chunks and int(chunks) > 1:
        bd = _pipelined_breakdown("scatter", algo, topo, m, net, chunks)
        if bd is not None:
            return bd
    if algo == "pip_mcoll":
        B = radix or (P + 1)
        n_rounds = max(1, math.ceil(round(math.log(N, B), 9))) if N > 1 else 0
        steps = [B ** i for i in range(n_rounds - 1, -1, -1)]
        inter_bytes = 0.0
        msgs = 0
        for S in steps:
            # the root's NIC is the bottleneck: B-1 lanes x S node-blocks
            nlanes = min(B - 1, max(1, math.ceil(N / S) - 1))
            nic_bytes = sum(min(S, max(0, N - (j + 1) * S)) * P * m
                            for j in range(nlanes))
            msgs += nlanes
            inter_bytes += nic_bytes
            t += _round_time(net, nlanes, nic_bytes)
        # intra: each lane slices its block from the node block (PiP: one copy)
        t += _intra_time(net, 1, m)
        return CostBreakdown(algo, len(steps), inter_bytes, msgs, 1, m, t)
    if algo == "binomial":
        rounds = _log2_rounds(M)
        inter_bytes = 0.0
        intra_bytes = 0.0
        ir = 0
        ii = 0
        msgs = 0
        S = 2 ** max(0, rounds - 1)
        while S >= 1:
            vol = min(S, M - S) * m
            if S < P:
                ii += 1
                intra_bytes += vol
                t += _intra_time(net, 1, vol)
            else:
                ir += 1
                inter_bytes += vol
                msgs += 1
                t += _round_time(net, 1, vol)
            S //= 2
        return CostBreakdown(algo, ir, inter_bytes, msgs, ii, intra_bytes, t)
    if algo == "linear":
        # root sends M-1 direct messages (serialized at the root NIC)
        inter = (M - P) * m
        t += (M - 1) / net.msg_rate + _round_time(net, 1, inter)
        t += _intra_time(net, 1, (P - 1) * m)
        return CostBreakdown(algo, 1, inter, M - P, 1, (P - 1) * m, t)
    raise ValueError(algo)


# ----------------------------- ALLREDUCE ------------------------------------


def allreduce_cost(algo: str, topo: Topology, m: int, net: NetParams,
                   chunks: int | None = None) -> CostBreakdown:
    """m = bytes per process (vector size)."""
    N, P = topo.n_nodes, topo.n_local
    M = topo.world
    t = net.sync_overhead
    if algo == "pip_pipeline":
        bd = _pipelined_breakdown("allreduce", algo, topo, m, net, chunks)
        return bd or CostBreakdown(algo, 0, 0.0, 0, 0, 0.0, t)
    if algo == "pip_mcoll":
        # intra reduce-scatter + per-lane inter allreduce (RD) + intra gather
        ir = _log2_rounds(P) * 2
        ib = 2 * (P - 1) / P * m
        t += _intra_time(net, ir, ib)
        rounds = _log2_rounds(N)
        slice_bytes = m / P
        inter_bytes = 0.0
        for _ in range(rounds):
            nic = P * slice_bytes            # all P lanes exchange slices
            inter_bytes += nic
            t += _round_time(net, P, nic)
        return CostBreakdown(algo, rounds, inter_bytes, rounds * P, ir, ib, t)
    if algo == "recursive_doubling":
        rounds = _log2_rounds(M)
        inter_bytes = 0.0
        ir = ii = 0
        intra_bytes = 0.0
        S = 1
        for i in range(rounds):
            if S < P:
                ii += 1
                intra_bytes += m
                t += _intra_time(net, 1, m)
            else:
                ir += 1
                inter_bytes += P * m
                t += _round_time(net, P, P * m)
            S *= 2
        return CostBreakdown(algo, ir, inter_bytes, ir * P, ii, intra_bytes, t)
    if algo == "xla":
        # ring reduce-scatter + ring allgather (bandwidth optimal)
        rounds = 2 * (M - 1)
        for _ in range(rounds):
            t += net.alpha_inter / 2 + (m / M) * net.beta_inter
        return CostBreakdown(algo, rounds, 2 * (M - 1) * m / M, rounds, 0, 0, t)
    raise ValueError(algo)


# ----------------------------- BROADCAST ------------------------------------


def broadcast_cost(algo: str, topo: Topology, m: int, net: NetParams,
                   radix: int | None = None,
                   chunks: int | None = None) -> CostBreakdown:
    """m = bytes delivered to every process (root holds m)."""
    N, P = topo.n_nodes, topo.n_local
    M = topo.world
    t = net.sync_overhead
    if algo == "pip_mcoll" and chunks and int(chunks) > 1:
        bd = _pipelined_breakdown("broadcast", algo, topo, m, net, chunks)
        if bd is not None:
            return bd
    if algo == "pip_mcoll":
        B = radix or (P + 1)
        n_rounds, cap = (1, B) if N > 1 else (0, 1)
        while cap < N:
            cap *= B
            n_rounds += 1
        inter_bytes = 0.0
        msgs = 0
        for _ in range(n_rounds):
            # an active node's P lanes feed up to P child nodes concurrently:
            # its NIC carries up to P messages of m in the round
            lanes = min(P, max(1, N - 1))
            nic = lanes * m
            inter_bytes += nic
            msgs += lanes
            t += _round_time(net, lanes, nic)
        # intra share of the node copy (PiP: one pass over shared memory)
        t += _intra_time(net, 1, m)
        return CostBreakdown(algo, n_rounds, inter_bytes, msgs, 1, m, t)
    if algo == "binomial":
        rounds = _log2_rounds(M)
        inter_bytes = intra_bytes = 0.0
        ir = ii = msgs = 0
        S = 2 ** max(0, rounds - 1)
        while S >= 1 and M > 1:
            if S < P:
                ii += 1
                intra_bytes += m
                t += _intra_time(net, 1, m)
            else:
                ir += 1
                inter_bytes += m
                msgs += 1
                t += _round_time(net, 1, m)
            S //= 2
        return CostBreakdown(algo, ir, inter_bytes, msgs, ii, intra_bytes, t)
    if algo == "xla":
        # the implemented vendor broadcast is a masked psum (mcoll), i.e. a
        # full allreduce of the payload: price it as the vendor ring
        # allreduce so the prior matches what actually runs
        rounds = 2 * max(0, M - 1)
        for _ in range(rounds):
            t += net.alpha_inter / 2 + (m / M) * net.beta_inter
        return CostBreakdown(algo, rounds, 2 * (M - 1) * m / max(M, 1),
                             rounds, 0, 0.0, t)
    raise ValueError(algo)


# ------------------------- REDUCE_SCATTER -----------------------------------


def reduce_scatter_cost(algo: str, topo: Topology, m: int, net: NetParams
                        ) -> CostBreakdown:
    """m = bytes input per process; each process ends with m/M reduced."""
    N, P = topo.n_nodes, topo.n_local
    M = topo.world
    t = net.sync_overhead
    if algo == "pip_mcoll":
        # two-level: ring reduce-scatter over nodes first (all P lanes active
        # on disjoint slices -> big contiguous inter chunks), then over lanes
        # (pure intra)
        inter_rounds = max(0, N - 1)
        inter_bytes = 0.0
        msgs = 0
        for _ in range(inter_rounds):
            nic = P * (m / max(N, 1))
            inter_bytes += nic
            msgs += P
            t += _round_time(net, P, nic)
        intra_rounds = max(0, P - 1)
        intra_bytes = intra_rounds * (m / max(N * P, 1))
        t += _intra_time(net, intra_rounds, intra_bytes)
        return CostBreakdown(algo, inter_rounds, inter_bytes, msgs,
                             intra_rounds, intra_bytes, t)
    if algo == "xla":
        # flat ring over M ranks: M-1 rounds of m/M (bandwidth optimal)
        rounds = max(0, M - 1)
        for _ in range(rounds):
            t += net.alpha_inter / 2 + (m / M) * net.beta_inter
        return CostBreakdown(algo, rounds, rounds * m / max(M, 1), rounds,
                             0, 0.0, t)
    raise ValueError(algo)


# ----------------------------- ALLTOALL -------------------------------------


def alltoall_cost(algo: str, topo: Topology, m: int, net: NetParams,
                  chunks: int | None = None) -> CostBreakdown:
    """m = bytes sent per process in total (m/M per peer)."""
    N, P = topo.n_nodes, topo.n_local
    M = topo.world
    t = net.sync_overhead
    if algo == "pip_pipeline":
        bd = _pipelined_breakdown("alltoall", algo, topo, m, net, chunks)
        return bd or CostBreakdown(algo, 0, 0.0, 0, 0, 0.0, t)
    if algo == "pip_mcoll":
        # phase 1 (intra): regroup by destination lane — one shared-memory
        # pass over the (P-1)/P fraction leaving this lane
        t += _intra_time(net, 1, m * (P - 1) / max(P, 1))
        # phase 2 (inter, multi-lane): per-lane all-to-all over nodes; each
        # of the N-1 rounds ships m/N per lane, P lanes per NIC concurrently
        inter_rounds = max(0, N - 1)
        inter_bytes = 0.0
        msgs = 0
        for _ in range(inter_rounds):
            nic = P * (m / max(N, 1))
            inter_bytes += nic
            msgs += P
            t += _round_time(net, P, nic)
        return CostBreakdown(algo, inter_rounds, inter_bytes, msgs, 1,
                             m * (P - 1) / max(P, 1), t)
    if algo == "xla":
        # flat pairwise exchange: M-1 rounds of m/M each
        rounds = max(0, M - 1)
        for _ in range(rounds):
            t += net.alpha_inter / 2 + (m / M) * net.beta_inter
        return CostBreakdown(algo, rounds, rounds * m / max(M, 1), rounds,
                             0, 0.0, t)
    raise ValueError(algo)


COST_FNS = {
    "allgather": allgather_cost,
    "scatter": scatter_cost,
    "broadcast": broadcast_cost,
    "allreduce": allreduce_cost,
    "reduce_scatter": reduce_scatter_cost,
    "alltoall": alltoall_cost,
}


# ---------------------------------------------------------------------------
# compressed plans: (C + B/ratio·beta) · rounds + codec_flops
# ---------------------------------------------------------------------------
#
# A codec shrinks every wire-axis byte term by its wire ratio (the alpha and
# injection terms are unchanged — compression buys bandwidth, not rounds)
# and adds the encode/decode streaming passes, priced against the machine's
# elementwise throughput (NetParams.flop_rate). Crossovers therefore shift
# per codec: small messages stay lossless (the flop term dominates), large
# wire-bound messages go compressed.


def codec_seconds(codec: str, nbytes: float, net: NetParams) -> float:
    """Modeled encode+decode time for ``nbytes`` of fp32 payload.

    Prices :func:`compress.effective_flops_per_elem` — codecs with fused
    Pallas lowerings (encode+error-feedback and decode+reduce in one memory
    pass each) cost fewer streaming passes while fusion is enabled, so the
    autotuned compression crossover moves to smaller messages."""
    return (_codecs.effective_flops_per_elem(codec)
            * (float(nbytes) / 4.0) / net.flop_rate)


def codec_net(net: NetParams, topo: Topology, codec: str) -> NetParams:
    """``net`` with the wire-axis beta divided by the codec's wire ratio
    (the wire axis is the node level when present, else the local level —
    matching ``core.mcoll``'s compressed execution)."""
    if not codec or codec == _codecs.NONE:
        return net
    ratio = max(_codecs.meta(codec).wire_ratio, 1e-9)
    if topo.n_nodes > 1:
        return dataclasses.replace(net, beta_inter=net.beta_inter / ratio)
    return dataclasses.replace(net, beta_intra=net.beta_intra / ratio)


def plan_cost(collective: str, algo: str, topo: Topology, m: int,
              net: NetParams, chunks: int = 1,
              codec: str = "none") -> CostBreakdown:
    """Cost of one full ``(algo, chunks, codec)`` plan — the selection
    subsystem's single pricing entry point. ``codec="none"`` falls through
    to the plain cost function; a lossy codec scales the wire beta by its
    ratio and adds the encode/decode term."""
    fn = COST_FNS[collective]
    kw = {"chunks": int(chunks)} if chunks and int(chunks) > 1 else {}
    if not codec or codec == _codecs.NONE:
        return fn(algo, topo, m, net, **kw)
    ratio = max(_codecs.meta(codec).wire_ratio, 1e-9)
    bd = fn(algo, topo, m, codec_net(net, topo, codec), **kw)
    extra = codec_seconds(codec, m, net)
    return CostBreakdown(bd.algo, bd.inter_rounds,
                         bd.inter_bytes_per_nic / ratio,
                         bd.inter_msgs_per_nic, bd.intra_rounds,
                         bd.intra_bytes, bd.time + extra)


def plan_seconds(collective: str, algo: str, topo: Topology, m: int,
                 chunks: int = 1, codec: str = "none",
                 net=None) -> float:
    """Modeled seconds for one plan with the net defaulted from the
    topology's link metadata — the reference the telemetry drift detector
    prices observed plans against (``autotune.predicted_seconds`` decodes
    plan keys into this)."""
    net_p = net_for(topo) if net is None else resolve_net(net)
    return plan_cost(collective, algo, topo, m, net_p, chunks=chunks,
                     codec=codec).time


def compressed_crossover_bytes(collective: str, algo: str, topo: Topology,
                               net: NetParams, codec: str, sizes=None):
    """Smallest swept message size where the codec plan (at its optimal
    chunk count) strictly beats the lossless plan of the same algorithm —
    the compression crossover. None when the codec never wins the sweep
    (latency-bound topology, or flop cost exceeds the wire savings)."""
    cnet = codec_net(net, topo, codec)
    for s in (tuple(sizes) if sizes else tuple(2 ** i for i in range(6, 27))):
        c_lossless = optimal_chunks(collective, algo, topo, s, net)
        c_codec = optimal_chunks(collective, algo, topo, s, cnet)
        if (plan_cost(collective, algo, topo, s, net, c_codec, codec).time
                < plan_cost(collective, algo, topo, s, net, c_lossless).time):
            return int(s)
    return None


def sweep(collective: str, topo: Topology, sizes: List[int], net_by_algo:
          Dict[str, NetParams]) -> Dict[str, List[float]]:
    """Latency (us) per algorithm across message sizes; net params may differ
    per algorithm (modeling different MPI libraries)."""
    out: Dict[str, List[float]] = {}
    fn = COST_FNS[collective]
    for algo, net in net_by_algo.items():
        name = algo.split(":")[-1]
        out[algo] = [fn(name, topo, s, net).us() for s in sizes]
    return out


# ---------------------------------------------------------------------------
# fitting a preset from calibration rows
# ---------------------------------------------------------------------------

#: the constants :func:`fit_net` fits, in its design matrix's column order
#: (``inv_msg_rate`` is ``1 / msg_rate``). Not fitted: ``copy_factor``, 1
#: by structure (ranks share one address space, the PiP premise), and
#: ``flop_rate``, the model's default (it prices codec passes only, and
#: the fit takes lossless plans only).
FIT_PARAMS = ("sync_overhead", "alpha_inter", "inv_msg_rate", "beta_inter",
              "alpha_intra", "beta_intra")

#: the most non-negative least-squares solves :func:`fit_net` takes
FIT_SOLVES = 20


def _fit_net(name: str, values) -> NetParams:
    v = dict(zip(FIT_PARAMS, (float(x) for x in values)))
    inv = v.pop("inv_msg_rate")
    return NetParams(name, msg_rate=1.0 / inv if inv > 0 else math.inf,
                     copy_factor=1.0, **v)


def _fit_rows(samples, x, scale):
    """Each sample's cost coefficients at constants ``x``: the gradient of
    its modeled time. Every cost function is linear in the constants on
    each side of its ``max()`` terms (ring and vendor allgather take the
    slower of a node and a local round), so a forward difference inside the
    active side (a step of 1e-3 of ``max(x, scale)``) is exact up to
    rounding."""
    import numpy as np

    rows = []
    for c, a, t, nb, ch, _ in samples:
        base = plan_cost(c, a, t, int(nb), _fit_net("x", x), chunks=ch).time
        row = []
        for j in range(len(FIT_PARAMS)):
            h = 1e-3 * max(x[j], scale[j])
            xh = np.array(x, dtype=float)
            xh[j] += h
            row.append((plan_cost(c, a, t, int(nb), _fit_net("x", xh),
                                  chunks=ch).time - base) / h)
        rows.append(row)
    return np.array(rows)


def fit_net(samples, name: str):
    """Fit a preset's constants to measured plans.

    ``samples`` yields ``(collective, algo, topo, nbytes, chunks,
    seconds)`` of lossless plans. A plan's modeled time is linear in the
    :data:`FIT_PARAMS` on each side of its cost function's ``max()`` terms
    (:func:`_fit_rows`), so the fit is a non-negative least-squares solve
    on the relative error ``(model - measured) / measured``, repeated with
    the sides the last solve makes active, from ``host_cpu``'s constants,
    until a solve repeats earlier constants (they settled, or alternate
    between the sides of a ``max()`` term) or after ``FIT_SOLVES`` solves;
    the solve whose constants give the least squared relative error under
    the full model is kept. Returns ``(NetParams, report)``; ``report``
    holds the fitted values, the solves taken and, per sample in order,
    ``rel_err``: ``(model - measured) / measured`` under the fit."""
    import numpy as np
    from scipy.optimize import nnls

    samples = list(samples)
    if not samples:
        raise ValueError("fit_net needs at least one sample")
    s0 = host_cpu()
    x = np.array([s0.sync_overhead, s0.alpha_inter, 1.0 / s0.msg_rate,
                  s0.beta_inter, s0.alpha_intra, s0.beta_intra])
    # difference steps: 1e-3 of each constant, or of host_cpu's where the
    # constant is 0 (its intra-level latency for the per-call cost)
    scale = np.where(x > 0, x, s0.alpha_intra)
    meas = np.array([float(s[-1]) for s in samples])

    def modeled(x):
        net = _fit_net(name, x)
        return net, np.array([plan_cost(c, a, t, int(nb), net,
                                        chunks=ch).time
                              for c, a, t, nb, ch, _ in samples])

    rows = _fit_rows(samples, x, scale)
    best, seen = None, [x]
    for solves in range(1, FIT_SOLVES + 1):
        x = nnls(rows / meas[:, None], np.ones(len(samples)))[0]
        net, model = modeled(x)
        rows = _fit_rows(samples, x, scale)
        # linear on each side: a step that straddles a max() kink mixes
        # the two sides' coefficients by at most the step's 1e-3
        if not np.allclose(model, rows @ x, rtol=1e-3, atol=0.0):
            raise AssertionError("the cost model is not linear in the "
                                 "fitted constants for these plans")
        cost = float(np.sum((model / meas - 1.0) ** 2))
        if best is None or cost < best[0]:
            best = (cost, x, net, model)
        if any(np.allclose(x, y, rtol=1e-6, atol=0.0) for y in seen):
            break  # settled, or cycling between sides of a max() term
        seen.append(x)
    _, x, net, model = best
    rel = model / meas - 1.0
    return net, {"params": dict(zip(FIT_PARAMS, x.tolist())),
                 "solves": solves, "samples": len(samples),
                 "rel_err": rel.tolist(),
                 "rms_rel_err": float(np.sqrt(np.mean(rel ** 2))),
                 "median_abs_rel_err": float(np.median(np.abs(rel)))}
