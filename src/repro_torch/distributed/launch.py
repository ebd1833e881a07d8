"""Launcher for local multi-process runs: spawn K coordinated processes
(port of ``repro.distributed.launch``).

Each worker process gets, via its environment (so ordering can never go
wrong): ``REPRO_TORCH_DIST_PROCS`` / ``_RANK`` / ``_COORD`` / ``_SCRATCH``
and ``_RANKS_PER_PROCESS`` (the contract :func:`repro_torch.distributed
.backend.auto_initialize` and ``launch.mesh.make_process_grid`` read),
``PYTHONPATH`` including ``src/``, and its share of the host's cores as
``OMP_NUM_THREADS`` unless the caller set it. The coordinator is rank 0's
``torch.distributed`` TCP store on a free loopback port picked by the
parent.

Two entry styles:

  * :func:`run` — run a Python function in K processes and collect each
    rank's (pickled) return value. The function must be module-level;
    functions defined in a script run as ``__main__`` are addressed by file
    path and re-imported in the worker, so guard the script's side effects
    under ``if __name__ == "__main__":``.
  * :func:`spawn` / the CLI — re-exec an arbitrary ``argv`` K times::

        python -m repro_torch.distributed.launch --processes 2 \\
            --ranks-per-process 4 -- script.py [args...]

    The child script calls ``backend.auto_initialize()`` before its first
    collective; rank 0's stdout is re-printed by the parent.

Every worker has a deadline: a worker still running at ``timeout`` is
killed and :class:`LaunchError` carries each failed rank's output tails.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.distributed import backend as _backend

SRC = pathlib.Path(__file__).resolve().parents[2]


class LaunchError(RuntimeError):
    """One or more worker processes failed (message carries per-rank
    stdout/stderr tails)."""


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env(base: Dict[str, str], rank: int, processes: int,
                ranks_per_process: int, coord: str,
                scratch: str) -> Dict[str, str]:
    env = dict(base)
    env[_backend.ENV_PROCS] = str(int(processes))
    env[_backend.ENV_RANK] = str(int(rank))
    env[_backend.ENV_COORD] = coord
    env[_backend.ENV_SCRATCH] = scratch
    env[_backend.ENV_RANKS] = str(int(ranks_per_process))
    env["PYTHONPATH"] = f"{SRC}:{env.get('PYTHONPATH', '')}"
    # each worker takes its share of the cores for its intra-op threads,
    # unless the caller chose (K workers with a thread per core each would
    # oversubscribe the host that also runs the transport)
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // int(processes))))
    return env


def spawn(argv: Sequence[str], processes: int = 2,
          ranks_per_process: int = 4, *, timeout: float = 900.0,
          env: Optional[Dict[str, str]] = None,
          scratch: Optional[str] = None) -> List[str]:
    """Run ``argv`` in ``processes`` coordinated workers; return each
    rank's stdout (rank order). Raises :class:`LaunchError` with per-rank
    output tails if any worker exits nonzero or the deadline passes (the
    workers still running are killed)."""
    if int(processes) < 1:
        raise ValueError(f"processes must be >= 1, got {processes}")
    coord = f"127.0.0.1:{free_port()}"
    scratch = scratch or tempfile.mkdtemp(prefix="repro_torch_dist_")
    base = dict(env if env is not None else os.environ)
    procs: List[subprocess.Popen] = []
    outs: List[Tuple[pathlib.Path, pathlib.Path]] = []
    rcs: List[Optional[int]] = []
    try:
        for rank in range(int(processes)):
            op = pathlib.Path(scratch) / f"rank{rank}.out"
            ep = pathlib.Path(scratch) / f"rank{rank}.err"
            outs.append((op, ep))
            with op.open("w") as so, ep.open("w") as se:
                procs.append(subprocess.Popen(
                    list(argv), stdout=so, stderr=se,
                    env=_worker_env(base, rank, processes,
                                    ranks_per_process, coord, scratch)))
        deadline = time.monotonic() + float(timeout)
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(0.1,
                                              deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def tail(path: pathlib.Path, n: int = 3000) -> str:
        try:
            return path.read_text()[-n:]
        except OSError:
            return "<unreadable>"

    if any(rc != 0 for rc in rcs):
        detail = "\n".join(
            f"--- rank {i} rc={rc} ---\nstdout:\n{tail(op)}\n"
            f"stderr:\n{tail(ep)}"
            for i, (rc, (op, ep)) in enumerate(zip(rcs, outs))
            if rc != 0)
        raise LaunchError(
            f"{sum(rc != 0 for rc in rcs)}/{len(procs)} workers failed "
            f"(rc={rcs}, timeout={'yes' if None in rcs else 'no'})\n"
            f"{detail}")
    return [op.read_text() for op, _ in outs]


# ---------------------------------------------------------------------------
# function-payload entry: run(fn, ...) across K processes
# ---------------------------------------------------------------------------


def _fn_ref(fn) -> Dict[str, str]:
    """An importable reference to a module-level function. Functions from
    a ``__main__`` script are addressed by source path and re-imported in
    the worker under a private module name."""
    if isinstance(fn, str):
        mod, _, name = fn.partition(":")
        if not name:
            raise ValueError(f"string fn spec must be 'module:function', "
                             f"got {fn!r}")
        return {"kind": "module", "module": mod, "name": name}
    mod = getattr(fn, "__module__", None)
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", None))
    if not mod or not name or "<" in name or "." in name:
        raise ValueError(
            f"run() needs a module-level function, got {fn!r}")
    if mod == "__main__":
        path = getattr(sys.modules.get("__main__"), "__file__", None)
        if not path:
            raise ValueError("cannot address a __main__ function without "
                             "a source file")
        return {"kind": "path", "path": str(pathlib.Path(path).resolve()),
                "name": name}
    return {"kind": "module", "module": mod, "name": name}


def _resolve_fn(ref: Dict[str, str]) -> Callable:
    if ref["kind"] == "module":
        import importlib
        return getattr(importlib.import_module(ref["module"]), ref["name"])
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_repro_torch_dist_payload", ref["path"])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, ref["name"])


def run(fn, *args: Any, processes: int = 2, ranks_per_process: int = 4,
        kwargs: Optional[Dict[str, Any]] = None,
        timeout: float = 900.0) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` in ``processes`` coordinated workers of
    ``ranks_per_process`` ranks each; return the per-rank results (rank
    order).

    ``fn`` is a module-level callable or a ``"module:function"`` string —
    each worker initializes the gloo process group, imports the function,
    calls it, and pickles its return value back."""
    scratch = tempfile.mkdtemp(prefix="repro_torch_dist_")
    payload = pathlib.Path(scratch) / "payload.pkl"
    payload.write_bytes(pickle.dumps(
        {"fn": _fn_ref(fn), "args": tuple(args),
         "kwargs": dict(kwargs or {})}))
    spawn([sys.executable, "-m", "repro_torch.distributed.launch",
           "--payload", str(payload)],
          processes=processes, ranks_per_process=ranks_per_process,
          timeout=timeout, scratch=scratch)
    results = []
    for rank in range(int(processes)):
        out = pathlib.Path(scratch) / f"result.rank{rank}.pkl"
        if not out.exists():
            raise LaunchError(f"rank {rank} exited 0 without a result "
                              f"payload ({out})")
        results.append(pickle.loads(out.read_bytes()))
    return results


def _worker_main(payload_path: str) -> None:
    be = _backend.auto_initialize()  # BEFORE the first collective
    try:
        payload = pickle.loads(pathlib.Path(payload_path).read_bytes())
        fn = _resolve_fn(payload["fn"])
        result = fn(*payload["args"], **payload["kwargs"])
        out = (pathlib.Path(payload_path).parent
               / f"result.rank{be.process_index}.pkl")
        tmp = out.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(result))
        tmp.replace(out)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.distributed.launch",
        description="spawn K coordinated torch.distributed (gloo) processes")
    ap.add_argument("--payload", default=None,
                    help="(internal) worker mode: run a pickled function "
                         "payload under the REPRO_TORCH_DIST_* environment")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--ranks-per-process", type=int, default=4,
                    help="ranks each process holds (the grid's local axis)")
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("argv", nargs=argparse.REMAINDER,
                    help="script (+args) to re-exec per rank; "
                         "separate with --")
    ns = ap.parse_args(argv)
    if ns.payload:
        _worker_main(ns.payload)
        return 0
    child = [a for a in ns.argv if a != "--"]
    if not child:
        ap.error("nothing to launch: pass -- script.py [args...]")
    outs = spawn([sys.executable, *child], processes=ns.processes,
                 ranks_per_process=ns.ranks_per_process, timeout=ns.timeout)
    sys.stdout.write(outs[0])  # rank 0 speaks for the program
    return 0


if __name__ == "__main__":
    sys.exit(main())
