"""Running a cell at the tests' small size: its configuration's widths
and its mix's sequence length cut (``conftest.SMALL``)."""
from __future__ import annotations

from portbench import harness

from conftest import small_config, small_traffic


def run_small(name: str, seed: int, trace: bool = False, hooks=None,
              device="cpu", seconds: float = 0.3):
    bench = harness.benchmark()
    cell = harness.workload(bench, name)
    return harness.run_cell(
        name, seed, seconds, trace, device, bench=bench, hooks=hooks,
        config=small_config(cell["config"]),
        traffic=small_traffic(harness.load_json("traffic", cell["traffic"])))
