"""The collective stack: rank grid, topology, codecs, algorithms, cost
model, selector, runtime caches and the Communicator."""
from repro_torch.core.topology import Topology
from repro_torch.core.grid import RankGrid
from repro_torch.core.autotune import Selector, TuningTable
from repro_torch.core.comm import Communicator, PersistentOp, CollHandle, \
    PlanSpec

__all__ = ["Topology", "RankGrid", "Selector", "TuningTable",
           "Communicator", "PersistentOp", "CollHandle", "PlanSpec"]
