"""PiP-MColl in action: run every collective algorithm on a (4 nodes x 2
locals) rank grid, verify identical results, and print the cost model's
predicted latency on the paper's cluster and on the port's H100
production grid.

  PYTHONPATH=src python -m repro_torch.examples.collectives_demo [--device cpu]

The ranks are rows of one device's tensors (``RankGrid(4, 2)``, the card
unless ``--device cpu`` is given). The production grid is the shape of
``launch.mesh.make_production_grid()`` (32 nodes of 8 GPUs) under the
``h100_grid`` link preset, the one fitted to calibration rows of ranks
held by one H100 (``core/costmodel.py``): a model, not a measurement of
NVLink or the network.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import autotune, compress, costmodel, mcoll
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid
from repro_torch.core.topology import Topology
from repro_torch.launch.mesh import GPUS_PER_NODE

N, P = 4, 2
#: the production grid's shape: 32 nodes of GPUS_PER_NODE
PROD_NODES = 32


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    grid = RankGrid(N, P, dev)
    topo = Topology(N, P)
    comm = Communicator(grid, topo)
    x = torch.arange(N * P * 4, dtype=torch.float32, device=dev)

    print(f"== allgather on {N}x{P} ranks (Communicator API, cached) ==")
    for algo in mcoll.algorithms("allgather"):
        out = _np(comm.allgather(x, algo=algo, stacked=True))
        ok = all((out[d] == _np(x)).all() for d in range(N * P))
        print(f"  {algo:20s} correct={ok}")
        assert ok
        comm.allgather(x, algo=algo, stacked=True)
    stats = comm.cache_stats()
    print(f"  runtime cache: {stats.exec_hits} hits / "
          f"{stats.exec_misses} builds")

    print("\n== persistent nonblocking allreduce (init once, start/wait) ==")
    zp = (torch.arange(N * P * 16, dtype=torch.float32, device=dev)
          % 9).reshape(N * P, 16)
    blocking = _np(comm.allreduce(zp, algo="pip_mcoll"))
    op = comm.allreduce_init(zp, algo="pip_mcoll", depth=2)
    misses0 = comm.cache_stats().exec_misses
    h1 = op.start(zp)            # returns at once (queued on the stream)
    h2 = op.start(zp)            # double-buffered: 2nd start before 1st wait
    outs = [_np(h1.wait()), _np(h2.wait())]
    for o in outs:
        np.testing.assert_array_equal(o, blocking)
    assert comm.cache_stats().exec_misses == misses0, "start must not build"
    print(f"  plan={op.plan} starts={op.starts} "
          f"builds_after_init=0 bitwise==blocking=True")

    print("\n== modeled small-message latency, paper cluster (128x18) ==")
    big = Topology(128, 18)
    for m in (64, 256, 1024):
        pip = costmodel.allgather_cost("pip_mcoll", big, m,
                                       costmodel.paper_cluster_pip())
        rd = costmodel.allgather_cost("recursive_doubling", big, m,
                                      costmodel.paper_cluster_cma())
        print(f"  {m:5d}B  pip_mcoll {pip.us():9.1f}us  "
              f"({pip.inter_rounds} inter rounds)   flat-RD {rd.us():9.1f}us "
              f"({rd.inter_rounds} rounds)  speedup "
              f"{rd.time / pip.time:.1f}x")

    prod = Topology(PROD_NODES, GPUS_PER_NODE)
    net = costmodel.h100_grid()
    print(f"\n== modeled on the H100 production grid ({PROD_NODES} x "
          f"{GPUS_PER_NODE}, h100_grid link) ==")
    for m in (256, 4096, 1 << 20):
        pip = costmodel.allgather_cost("pip_mcoll", prod, m, net)
        sl = costmodel.allgather_cost("single_leader", prod, m, net)
        print(f"  {m:8d}B  pip_mcoll {pip.us():9.1f}us  single-leader "
              f"{sl.us():9.1f}us  speedup {sl.time / pip.time:.2f}x")

    print("\n== chunked pipelining: pip_pipeline allreduce (runtime, "
          "chunks=) ==")
    z = (torch.arange(N * P * 12, dtype=torch.float32, device=dev)
         % 13).reshape(N * P, 12)
    expect = _np(z).sum(0)
    for c in (1, 2, 4):
        out = _np(comm.allreduce(z, algo="pip_pipeline", chunks=c))
        assert all((out[d] == expect).all() for d in range(N * P))
        print(f"  chunks={c} correct=True")
    for m in (4096, 1 << 20, 1 << 24):
        c = costmodel.optimal_chunks("allreduce", "pip_pipeline", prod, m,
                                     net)
        t1 = costmodel.allreduce_cost("pip_pipeline", prod, m, net, chunks=1)
        tc = costmodel.allreduce_cost("pip_pipeline", prod, m, net, chunks=c)
        print(f"  modeled {m:8d}B  c*={c:3d}  unchunked {t1.us():9.1f}us  "
              f"chunked {tc.us():9.1f}us  win {t1.time / tc.time:.2f}x")
    xo = costmodel.pipeline_crossover_bytes("allreduce", "pip_pipeline",
                                            prod, net)
    print(f"  modeled pipelining crossover: {xo}B")

    print("\n== error-bounded compressed collectives (codec=) ==")
    gen = torch.Generator(dev).manual_seed(0)
    zr = torch.randn((N * P, 2048), generator=gen, device=dev) * 0.01
    exact = _np(zr).sum(0)
    A = float(np.abs(_np(zr)).max())
    for cd in compress.lossy():
        out = _np(comm.allreduce(zr, algo="pip_mcoll", codec=cd))
        err = np.abs(out[0] - exact).max()
        tol = compress.collective_tolerance(cd, "allreduce", N * P, A)
        assert err <= tol + 1e-7, (cd, err, tol)
        m = compress.meta(cd)
        print(f"  {cd:11s} ratio={m.wire_ratio:4.1f}x stated_bound="
              f"{m.error_bound:.4f}  achieved_err={err:.2e} (tol {tol:.2e})")

    print(f"\n== codec selection under an error budget ({PROD_NODES}x"
          f"{GPUS_PER_NODE} production grid) ==")
    h100 = Topology(PROD_NODES, GPUS_PER_NODE, node_link="h100_grid",
                    local_link="h100_grid")
    sel = autotune.Selector()
    budgets = (0.0, 0.004, 0.07, 1.0)
    print(f"  {'size':>10s}  " + "  ".join(f"budget={b:<7g}"
                                           for b in budgets))
    for size in (256, 65536, 1 << 20, 1 << 24):
        plans = []
        for b in budgets:
            s = sel.choose("allreduce", h100, size, error_budget=b)
            plans.append(autotune.encode_plan(s.algo, s.chunks, s.codec))
        print(f"  {size:>9d}B  " + "  ".join(f"{p:<14s}" for p in plans))
    zero = sel.choose("allreduce", h100, 1 << 24, error_budget=0.0)
    assert zero.codec == "none", "error_budget=0.0 must stay lossless"
    print("collectives_demo OK")


if __name__ == "__main__":
    main()
