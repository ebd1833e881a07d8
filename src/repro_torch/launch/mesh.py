"""The process grid of a launched run (port of ``repro.launch.mesh``'s
``make_process_mesh``; the rest of that module comes with ROADMAP queue 1
item 8)."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.core.grid import ProcessGrid
from repro_torch.distributed import backend as _backend


def make_process_grid(device: Union[str, torch.device] = "cuda"
                      ) -> ProcessGrid:
    """The ``(process_count, ranks_per_process)`` :class:`ProcessGrid` of
    the initialized backend, whose node axis is exactly the process
    boundary: process ``p`` holds flat ranks ``p * ranks_per_process`` on.
    ``ranks_per_process`` is the launcher's (``--ranks-per-process``; 1
    when not launched). ``derive_link`` then classifies the node axis
    ``host_ipc`` and the local axis as the grid's in-process link. Its
    ranks live on ``device``, the card unless the caller passes
    ``"cpu"``."""
    return ProcessGrid(_backend.process_count(),
                       _backend.ranks_per_process(), device)
