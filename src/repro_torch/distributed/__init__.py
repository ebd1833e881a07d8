"""Multi-process backend: a ``torch.distributed`` gloo process group
behind the Communicator stack (port of ``repro.distributed``).

Two pieces:

  * :mod:`repro_torch.distributed.backend` — the process-level runtime
    descriptor and the helpers ``core.grid`` / ``core.runtime`` /
    ``core.comm`` consult so ``Communicator(grid)`` works unchanged whether
    the grid spans one process or many (the full value of a result,
    cross-process barriers, the tuning-table merge, artifact stamping);
  * :mod:`repro_torch.distributed.launch` — a launcher that spawns K
    coordinated local processes (a gloo process group against a TCP store
    on loopback, the ranks per process configurable) and runs a user
    function, or re-execs a script, in each.

The grid itself is :class:`repro_torch.core.grid.ProcessGrid`, built by
``launch.mesh.make_process_grid``.
"""
from repro_torch.distributed.backend import (Backend, auto_initialize,
                                             barrier, current_backend,
                                             is_multiprocess,
                                             merge_tuning_table,
                                             process_count, process_rank,
                                             to_host)
from repro_torch.distributed.launch import LaunchError, run, spawn

__all__ = [
    "Backend", "auto_initialize", "barrier", "current_backend",
    "is_multiprocess", "merge_tuning_table", "process_count",
    "process_rank", "to_host", "LaunchError", "run", "spawn",
]
