"""The readers of the program's own ranges (``portbench/spans.py`` and the
ten metrics that use it) on synthetic profiler records: device time of
the kernels launched inside the named ranges a profiled step, counts of
``host_read/*`` ranges, and nothing at all where the program has no such
range (an older program)."""
import pytest

from portbench import harness, spans

#: metric -> the ranges it reads
MS = {"allreduce_intra_rs_ms.sync": ("allreduce/intra_reduce_scatter",),
      "allreduce_wire_ms.sync": ("allreduce/wire_reduce_scatter",
                                 "allreduce/wire_allgather"),
      "allreduce_intra_ag_ms.sync": ("allreduce/intra_allgather",),
      "allreduce_residual_ms.sync": ("allreduce/residual",),
      "persistent_writeback_ms.sync": ("persistent/writeback",),
      "fwd_bwd_ms.train": ("train/fwd_bwd",),
      "optimizer_ms.train": ("train/optimizer",),
      "grad_sync_ms.train": ("train/grad_sync",),
      "moe_alltoall_ms.train": ("moe/alltoall",)}


def _run(host, kernels, steps=2):
    prof = {"kernels": kernels, "host": host, "wall_s": 1.0}
    return {"trace": {"busy_s": 1.0, "steps": steps, "profile": prof}}


def _launch(t, corr):
    return ("cudaLaunchKernel", t, t + 5, corr)


def _two_steps(name):
    """Each of two steps: ``name`` over one launch of 3 ms, another range
    over one of 5 ms, and a launch outside every range (7 ms)."""
    host, kernels = [], []
    for k, base in enumerate((0, 10**9)):
        host += [(name, base + 100, base + 200, 0),
                 _launch(base + 150, 10 * k + 1),
                 ("other/range", base + 300, base + 400, 0),
                 _launch(base + 350, 10 * k + 2),
                 _launch(base + 500, 10 * k + 3)]
        kernels += [("k1", base + 1000, 3_000_000, 10 * k + 1),
                    ("k2", base + 5_000_000, 5_000_000, 10 * k + 2),
                    ("k3", base + 11_000_000, 7_000_000, 10 * k + 3)]
    return host, kernels


@pytest.mark.parametrize("metric", sorted(MS))
def test_each_ms_reader_reads_its_ranges_a_step(metric):
    mod = harness.load_module("metrics", metric)
    host, kernels = _two_steps(MS[metric][0])
    assert mod.read(_run(host, kernels)) == pytest.approx(3.0)


@pytest.mark.parametrize("metric", sorted(MS))
def test_each_ms_reader_is_silent_without_its_ranges(metric):
    mod = harness.load_module("metrics", metric)
    host, kernels = _two_steps("not/the_program")
    assert mod.read(_run(host, kernels)) is None
    assert mod.read({"trace": None}) is None
    assert mod.read(dict(_run(host, kernels), trace=dict(
        _run(host, kernels)["trace"], busy_s=0.0))) is None


def test_the_wire_reads_both_wire_phases():
    host, kernels = _two_steps("allreduce/wire_reduce_scatter")
    host = [("allreduce/wire_allgather", *h[1:]) if h[0] == "other/range"
            else h for h in host]
    mod = harness.load_module("metrics", "allreduce_wire_ms.sync")
    assert mod.read(_run(host, kernels)) == pytest.approx(8.0)
    assert spans.device_ms(_run(host, kernels), "allreduce/wire_allgather",
                           "absent/range") == pytest.approx(5.0)


def test_host_reads_count_a_step_and_zero_is_a_reading():
    mod = harness.load_module("metrics", "host_reads.train")
    steps = [("train/fwd_bwd", 0, 10, 0), ("train/fwd_bwd", 20, 30, 0)]
    reads = [("host_read/moe_group_sizes", 1, 2, 0),
             ("host_read/moe_lead_rows", 3, 4, 0),
             ("host_read/moe_group_sizes", 21, 22, 0),
             ("host_read/moe_lead_rows", 23, 24, 0)]
    kernels = [("k", 0, 1, 1)]
    assert mod.read(_run(steps + reads, kernels)) == 2.0
    assert mod.read(_run(steps, kernels)) == 0.0
    # no train/fwd_bwd range: a program without the ranges
    assert mod.read(_run(reads, kernels)) is None
    assert mod.read({"trace": None}) is None


def test_the_new_metrics_are_listed_with_their_cells():
    bench = harness.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in list(MS) + ["host_reads.train"]:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        cells = {w["name"] for w in bench["workloads"]}
        assert set(m["workloads"]) <= cells
        kind = name.rsplit(".", 1)[1]
        assert all(kind in w for w in m["workloads"])
