"""Process-level runtime backend for the Communicator stack (port of
``repro.distributed.backend``).

``core.grid``, ``core.runtime`` and ``core.comm`` consult this module so
the same ``Communicator(grid)`` call works whether the grid spans one
process or many. The contract:

  * :func:`auto_initialize` bootstraps a ``torch.distributed`` process
    group from the ``REPRO_TORCH_DIST_*`` environment the launcher
    (:mod:`repro_torch.distributed.launch`) sets: gloo over TCP to the
    coordinator, with a timeout, so a lost peer fails instead of hanging.
    It is a no-op in a plain single-process run, so every script can call
    it unconditionally, and idempotent.
  * The process group is gloo: the control plane (barriers, the
    calibration merge, ``all_gather_object``) and the data transport of
    grids whose processes do not share one card. A process group of any
    other backend raises ``NotImplementedError``: NCCL with one process
    per card on several cards is ROADMAP queue 1 item 5b. A grid's axis
    and color groups may span any processes, down to one rank a process;
    their payloads go through the ``"shm"`` transport's shared slots when
    every process is on this card, else through gloo's host copies
    (``distributed/transport.py``, whose ``choose`` decides).
  * :func:`to_host` is the full logical value of a
    :class:`~repro_torch.core.grid.ProcessGrid` result on every process,
    its rows gathered from the grid's processes. (The reference's
    ``global_array`` has its counterpart in ``core.runtime``: every process
    passes the full logical operand and keeps its own rows.)
  * :func:`merge_tuning_table` is the calibration merge: each rank writes
    its measured :class:`~repro_torch.core.autotune.TuningTable` to the
    launcher's shared scratch directory, and every rank folds all ranks'
    rows in rank order with ``reduce=max``, so ``algo="auto"`` resolves to
    the same plan on every process (the reference folds on rank 0 only).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pathlib
import tempfile

import torch
import torch.distributed as dist

#: environment contract between the launcher and worker processes
ENV_PROCS = "REPRO_TORCH_DIST_PROCS"
ENV_RANK = "REPRO_TORCH_DIST_RANK"
ENV_COORD = "REPRO_TORCH_DIST_COORD"
ENV_SCRATCH = "REPRO_TORCH_DIST_SCRATCH"
#: ranks each process holds: the local axis of ``launch.mesh
#: .make_process_grid`` (the reference sets its devices per process through
#: ``XLA_FLAGS``)
ENV_RANKS = "REPRO_TORCH_DIST_RANKS_PER_PROCESS"

#: the process group's backend (the control plane, and the default data
#: transport; ``distributed/transport.py`` has the other)
TRANSPORT = "gloo"

#: seconds a process-group operation may wait for its peers
TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Backend:
    """Descriptor of the process-level runtime this process runs under.

    ``name`` is ``"single"`` for the ordinary one-process runtime and
    ``"multiprocess"`` for a ``torch.distributed`` process group of
    several processes; both land verbatim in the calibration artifact's
    ``backend`` field (schema: ``core.artifact``).
    """

    name: str
    process_count: int
    process_index: int
    coordinator: str = ""

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1


def _not_gloo(backend: str) -> NotImplementedError:
    return NotImplementedError(
        f"torch.distributed backend {backend!r}: this transport implements "
        f"{TRANSPORT!r} only; NCCL with one process per card on several "
        f"cards is ROADMAP queue 1 item 5b")


def auto_initialize() -> Backend:
    """Initialize the gloo process group from the launcher's environment.

    Reads ``REPRO_TORCH_DIST_PROCS`` / ``_RANK`` / ``_COORD``; when absent
    (or one process) this is a no-op returning the single backend, so
    scripts call it unconditionally before their first collective.
    Idempotent; a failed initialization raises, and every operation of
    the group raises after ``TIMEOUT_S`` seconds without its peers."""
    nprocs = int(os.environ.get(ENV_PROCS, "1"))
    if nprocs <= 1:
        return current_backend()
    if not dist.is_initialized():
        dist.init_process_group(
            TRANSPORT, init_method=f"tcp://{os.environ[ENV_COORD]}",
            world_size=nprocs, rank=int(os.environ[ENV_RANK]),
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return current_backend()


def current_backend() -> Backend:
    """The live backend descriptor (queries the process group); raises
    ``NotImplementedError`` for a group whose backend is not gloo."""
    if dist.is_available() and dist.is_initialized():
        backend = str(dist.get_backend())
        if backend != TRANSPORT:
            raise _not_gloo(backend)
        n = int(dist.get_world_size())
        if n > 1:
            return Backend("multiprocess", n, int(dist.get_rank()),
                           os.environ.get(ENV_COORD, ""))
    return Backend("single", 1, 0)


def is_multiprocess() -> bool:
    return current_backend().multiprocess


def process_rank() -> int:
    return current_backend().process_index


def process_count() -> int:
    return current_backend().process_count


def ranks_per_process() -> int:
    """The ranks each process holds, as the launcher set them (1 when not
    launched)."""
    return int(os.environ.get(ENV_RANKS, "1"))


# ---------------------------------------------------------------------------
# values across processes
# ---------------------------------------------------------------------------


def to_host(x: torch.Tensor, grid=None) -> torch.Tensor:
    """The full logical value of ``x`` as a CPU tensor on every process.

    ``x`` is a result on ``grid``: on a :class:`ProcessGrid` of several
    processes it holds this process's rows (stacked results) or shards
    (sharded ones), dim 0 in the order of its held ranks, and the grid's
    processes exchange their parts and place them in flat rank order.
    Anything else (a one-process grid, no grid) is copied as it is; an
    allgather result with ``stacked=False``, which every process holds
    whole, is not a part and must not be passed. The parts travel as
    bytes, so every dtype comes back bit for bit."""
    if grid is None or getattr(grid, "process_count", 1) <= 1:
        return x.detach().cpu()
    rows = grid.rows
    if x.shape[0] % max(rows, 1):
        raise ValueError(f"a part of {tuple(x.shape)} does not split over "
                         f"the {rows} held ranks")
    per = x.shape[0] // rows
    part = x.detach().reshape((rows, per) + tuple(x.shape[1:]))
    full = grid.all_rows(part, device="cpu")
    return full.reshape((grid.world * per,) + tuple(x.shape[1:]))


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op in one process).

    ``name`` must match across processes: the processes exchange it, and a
    mismatch is a programming error that raises on every process."""
    if not is_multiprocess():
        return
    names = [None] * process_count()
    dist.all_gather_object(names, str(name))
    if len(set(names)) != 1:
        raise RuntimeError(f"barrier names differ across processes: "
                           f"{names}")


# ---------------------------------------------------------------------------
# cross-process calibration merge
# ---------------------------------------------------------------------------


def scratch_dir() -> pathlib.Path:
    """The launcher's shared scratch directory (all ranks see one path);
    a stable per-coordinator temporary directory when launched by other
    means."""
    path = os.environ.get(ENV_SCRATCH)
    if not path:
        tag = os.environ.get(ENV_COORD, "single").replace(":", "_")
        path = os.path.join(tempfile.gettempdir(), f"repro_torch_dist_{tag}")
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def merge_tuning_table(table, tag: str = "calibrate") -> int:
    """Fold every rank's tuning-table rows into ``table``, on every rank.

    Each rank writes its table JSON to the shared scratch directory and
    synchronizes; every rank then folds all ranks' tables, in rank order,
    into an empty table with ``TuningTable.merge(..., reduce=max)`` (ranks
    time the same SPMD plans, and a collective is only as fast as its
    slowest rank) and takes the result, so every process holds the same
    table and ``algo="auto"`` resolves alike everywhere. Returns the
    number of other ranks merged (0 in a single-process runtime, where
    this is a no-op). A trailing barrier keeps every file in place until
    every rank has read it."""
    if not is_multiprocess():
        return 0
    from repro_torch.core.autotune import TuningTable  # lazy: no cycle
    rank, nprocs = process_rank(), process_count()
    base = scratch_dir()
    table.save(base / f"table.{tag}.rank{rank}.json")
    barrier(f"merge_tuning_table/{tag}/written")
    merged = TuningTable()
    for r in range(nprocs):
        merged.merge(TuningTable.load(base / f"table.{tag}.rank{r}.json"),
                     reduce=max)
    table.entries.clear()
    table.merge(merged)
    barrier(f"merge_tuning_table/{tag}/merged")
    return nprocs - 1


def stamp_artifact(data: dict) -> dict:
    """Add the ``backend`` / ``process_count`` schema fields describing the
    runtime an artifact was measured under (see ``core.artifact``)."""
    be = current_backend()
    data["backend"] = be.name
    data["process_count"] = be.process_count
    return data
