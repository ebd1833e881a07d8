"""Where an 8-byte collective's time goes under the ``"shm"`` transport.

    python3 scripts/shm_exchange_trace.py            # on the card
    python3 scripts/shm_exchange_trace.py --cpu      # CPU ranks only

Eight one-rank workers (``distributed.launch.run``) on a
``ProcessGrid(2, 4)`` over the ``"shm"`` transport (the grid's own choice
on the card, a ``ShmTransport("cpu")`` handed to CPU ranks) call a few
lossless 8 B-per-rank collectives, ``ITERS`` times each after a warm
call, and split each call's host time into

  * ``issue_ms``: the Python of the algorithm and its exchanges, up to the
    call's return (the transport's waits on its peers' counters included);
  * ``sync_ms``: the ``torch.cuda.synchronize()`` after it, the device
    finishing the chain of copies that the interprocess events order
    across the eight CUDA contexts;
  * ``exchange_ms``: the host time inside the transport's exchanges
    (telemetry's ``transport/*`` spans, a second run of the calls with
    telemetry on).

The same on CPU ranks (a second spawn, ``device="cpu"``) gives the host
protocol alone. On the card, worker 0 also profiles ``PROFILE_ITERS``
calls of ``allreduce``/``pip_mcoll`` with ``torch.profiler`` (CPU and
CUDA activities) and writes the trace to
``build/shm_trace_rank0.json``; its device busy time per call is
the sum of its kernels' and copies' durations. Prints one JSON line per
device with the medians over the calls and, per collective, the slowest
worker's, then the card's name and power limit.
"""
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: (collective, algorithm) pairs timed at 8 B per rank
CASES = (("allreduce", "pip_mcoll"), ("allreduce", "xla"),
         ("alltoall", "xla"), ("broadcast", "xla"))
NBYTES, ITERS, PROFILE_ITERS = 8, 20, 5
OUT = ROOT / "build"


def _median(xs):
    return statistics.median(xs) if xs else None


def worker(device):
    """One worker: per case the per-call issue, synchronize and exchange
    times (ms, medians); worker 0 on the card also the profile."""
    import torch
    from repro_torch.core import runtime, telemetry
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.distributed.transport import ShmTransport

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(torch.device(device))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # on the card the grid chooses "shm"; CPU ranks are handed it
    comm = Communicator(ProcessGrid(2, 4, device, transport=None if cuda
                                    else ShmTransport(device)))
    if comm.grid.transport.name != "shm":
        raise AssertionError(f"the grid runs over "
                             f"{comm.grid.transport.name}")
    out = {"rank": comm.grid.rank, "cases": {}}
    for coll, algo in CASES:
        x = runtime.example_input(coll, comm.topo, NBYTES,
                                  device=comm.grid.device)
        comm.invoke(coll, x, algo=algo)
        sync()
        issue, synced = [], []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            comm.invoke(coll, x, algo=algo)
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            issue.append((t1 - t0) * 1e3)
            synced.append((t2 - t1) * 1e3)
        telemetry.reset()
        telemetry.enable()
        try:
            for _ in range(ITERS):
                comm.invoke(coll, x, algo=algo)
                sync()
        finally:
            telemetry.disable()
        spans = [s for s in telemetry.spans() if s.cat == "transport"]
        out["cases"][f"{coll}/{algo}"] = {
            "issue_ms": _median(issue), "sync_ms": _median(synced),
            "call_ms": _median([a + b for a, b in zip(issue, synced)]),
            "exchange_ms": sum(s.duration for s in spans) * 1e3 / ITERS,
            "exchanges_per_call": len(spans) / ITERS}
    if cuda:
        profiled = _profile(torch, comm)
        if comm.grid.rank == 0:
            out["profile"] = profiled
    return out


def _profile(torch, comm):
    """``PROFILE_ITERS`` calls of allreduce/pip_mcoll on every worker, under
    the profiler on worker 0: its device busy time per call and the
    trace's path."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import runtime

    x = runtime.example_input("allreduce", comm.topo, NBYTES,
                              device=comm.grid.device)
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if comm.grid.rank == 0 else contextlib.nullcontext())
    with prof:
        for _ in range(PROFILE_ITERS):
            comm.invoke("allreduce", x, algo="pip_mcoll")
            torch.cuda.synchronize()
    if comm.grid.rank:
        return None
    OUT.mkdir(exist_ok=True)
    path = OUT / "shm_trace_rank0.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset")]
    return {"device_busy_ms_per_call": sum(e.get("dur", 0) for e in device)
            / 1e3 / PROFILE_ITERS,
            "device_events_per_call": len(device) / PROFILE_ITERS,
            "trace": str(path.relative_to(ROOT))}


def main() -> int:
    import torch
    from repro_torch.distributed import launch
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    devices = ["cpu"]
    if "--cpu" not in sys.argv:
        if not torch.cuda.is_available():
            print("no CUDA card (pass --cpu for CPU ranks only)")
            return 1
        devices.insert(0, "cuda:0")
    for device in devices:
        t0 = time.perf_counter()
        res = launch.run(worker, device, processes=8, ranks_per_process=1,
                         timeout=600)
        rec = {"device": device, "workers": 8, "nbytes": NBYTES,
               "iters": ITERS, "spawn_s": time.perf_counter() - t0,
               "cases": {}}
        for key in res[0]["cases"]:
            rec["cases"][key] = {
                k: max(r["cases"][key][k] for r in res)
                for k in res[0]["cases"][key]}
        if "profile" in res[0]:
            rec["profile_rank0"] = res[0]["profile"]
        print(json.dumps({"shm_exchange_trace": rec}))
    if "--cpu" not in sys.argv:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
