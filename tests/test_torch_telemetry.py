"""The port's telemetry against the reference's.

The first seventeen cases mirror ``tests/test_telemetry.py`` one for one on
the port (1x1 CPU rank grids where the reference uses 1-device meshes).
Where the function is pure, the port is held to the reference on the same
numpy-seeded inputs, exactly: ``plan_tags``, the ``Histogram`` quantiles
and ``summary``, the ``should_sample`` sequence, the ``DriftRow``s of
``drift_report`` from the same table and observations, ``Selector.ingest``'s
count and the choice that follows it, and the events of
``export_chrome_trace`` but for their timestamps. (The reference's
telemetry module imports only the standard library; its autotune loads
in this process as ``tests/test_torch_autotune.py`` loads it.)

The acceptance cases after them run on a CPU ``RankGrid(2, 4)``, after
``tests/checks/telemetry_check.py``: a bucketed gradient sync with the
tracer on gives one window a bucket, each on its own track, inside the
sync's span; a poisoned tuning-table row is flagged and healed by
``Selector.ingest``; outputs and exec-cache keys are bitwise the same with
telemetry on and off; a plan change counts a bucket rebuild.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core import autotune, runtime, telemetry
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid
from repro_torch.core.topology import Topology

pytest.importorskip("jax")
from repro.core import autotune as jautotune  # noqa: E402
from repro.core import telemetry as jtelemetry  # noqa: E402
from repro.core.topology import Topology as JTopology  # noqa: E402


@pytest.fixture(autouse=True)
def _telemetry_off():
    """Every test starts (and leaves the process) with both packages'
    telemetry disabled and empty."""
    for tm in (telemetry, jtelemetry):
        tm.disable()
        tm.reset()
    yield
    for tm in (telemetry, jtelemetry):
        tm.disable()
        tm.reset()


def _grid_comm(n=1, p=1):
    grid = RankGrid(n, p, device="cpu")
    return grid, Communicator(grid, Topology.from_grid(grid))


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_disabled_tracer_records_nothing_and_allocates_no_context():
    assert not telemetry.enabled()
    ctx = telemetry.span("x", cat="test", plan="p")
    assert ctx is telemetry.span("y")  # shared null context
    with ctx:
        pass
    assert telemetry.begin("x") is None
    telemetry.end(None)
    telemetry.emit("x", 0.0, 1.0)
    telemetry.instant("x")
    telemetry.observe_plan(Topology(1, 1), "allreduce", "float32", 64,
                           "pip_mcoll", 1e-3)
    assert telemetry.spans() == []
    assert telemetry.plan_observations() == []
    assert not telemetry.should_sample("k", every=1)


def test_span_and_begin_end_record_tagged_windows():
    telemetry.enable()
    with telemetry.span("build/allreduce", cat="build", plan="pip_mcoll"):
        pass
    tok = telemetry.begin("allreduce[pip_mcoll]", cat="comm",
                          track="comm:allreduce#1", bucket=0)
    telemetry.end(tok)
    s1, s2 = telemetry.spans()
    assert s1.name == "build/allreduce" and s1.track == "main"
    assert dict(s1.args)["plan"] == "pip_mcoll"
    assert s2.track == "comm:allreduce#1" and s2.duration >= 0.0
    assert s2.start >= s1.start


def test_ring_buffer_bounds_and_drop_counter():
    for tm in (telemetry, jtelemetry):
        tm.enable(capacity=8)
        try:
            for i in range(20):
                tm.instant(f"s{i}")
            assert len(tm.spans()) == 8
            assert tm.spans_dropped() == 12
            assert [s.name for s in tm.spans()][0] == "s12"
        finally:
            tm.enable(capacity=65536)


def _trace_events(tm, tmp_path):
    """One nested step with a bucket window, exported: the written file,
    the returned dict, and its events without their timestamps."""
    tm.enable()
    with tm.span("train/step", cat="train"):
        with tm.span("train/fwd", cat="train"):
            pass
        tok = tm.begin("bucket0[pip_pipeline]", cat="bucket",
                       track="bucket:0", collective="allreduce", bucket=0)
        tm.end(tok)
    tm.instant("persistent_release/allreduce", cat="persistent", starts=3)
    out = tmp_path / f"{tm.__name__}.json"
    trace = tm.export_chrome_trace(out)
    stripped = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in trace["traceEvents"]]
    return out, trace, stripped


def test_export_chrome_trace_tracks_and_events(tmp_path):
    out, trace, mine = _trace_events(telemetry, tmp_path)
    assert json.loads(out.read_text()) == trace
    meta = {e["args"]["name"]: e["tid"] for e in trace["traceEvents"]
            if e["ph"] == "M"}
    assert meta["main"] == 0 and "bucket:0" in meta
    evs = {e["name"]: e for e in trace["traceEvents"] if e["ph"] == "X"}
    assert set(evs) == {"train/step", "train/fwd", "bucket0[pip_pipeline]",
                        "persistent_release/allreduce"}
    step, fwd = evs["train/step"], evs["train/fwd"]
    assert fwd["tid"] == 0 and evs["bucket0[pip_pipeline]"]["tid"] != 0
    assert step["ts"] <= fwd["ts"]
    assert fwd["ts"] + fwd["dur"] <= step["ts"] + step["dur"] + 1e-3
    assert trace["otherData"]["spans_dropped"] == 0
    # the reference's export of the same spans: equal but for timestamps
    _, jtrace, theirs = _trace_events(jtelemetry, tmp_path)
    assert mine == theirs
    assert trace["displayTimeUnit"] == jtrace["displayTimeUnit"]
    # the port adds the earliest span's start on the profiler's clock
    other = dict(trace["otherData"])
    assert other.pop("epoch_ns") == min(s.start_ns
                                        for s in telemetry.spans())
    assert other == jtrace["otherData"]


def test_plan_tags_schema():
    rng = np.random.default_rng(0)
    tags = telemetry.plan_tags("allreduce", "pip_pipeline", chunks=4,
                               codec="int8_block", group="node", nbytes=5000)
    assert tags == {"collective": "allreduce", "algo": "pip_pipeline",
                    "chunks": 4, "codec": "int8_block", "group": "node",
                    "size_bucket": 8192}
    assert "size_bucket" not in telemetry.plan_tags("broadcast", "binomial")
    for nbytes in [None, 1, 2, 3] + rng.integers(1, 1 << 30, 50).tolist():
        for args in (("allgather", "bruck"),
                     ("reduce_scatter", "pip_mcoll", 2, None, "local")):
            assert telemetry.plan_tags(*args, nbytes=nbytes) == \
                jtelemetry.plan_tags(*args, nbytes=nbytes)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_histogram_quantiles_and_summary():
    h = telemetry.Histogram("t")
    for v in (1e-3, 2e-3, 3e-3, 4e-3, 100e-3):
        h.observe(v)
    assert h.count == 5 and np.isclose(h.mean, 0.022)
    assert h.vmin == 1e-3 and h.vmax == 100e-3
    assert 1e-3 <= h.quantile(0.5) <= 4e-3
    assert h.quantile(0.99) <= 100e-3
    assert h.quantile(0.0) == 1e-3  # clamped to the observed min
    s = h.summary()
    assert s["count"] == 5 and s["p99"] >= s["p50"]
    assert telemetry.Histogram("e").quantile(0.5) == 0.0
    assert telemetry.Histogram("e").summary() == {"count": 0}
    # the reference's histogram on the same seeded samples, custom bounds
    # too: every quantile and the summary equal
    rng = np.random.default_rng(7)
    samples = np.concatenate([rng.lognormal(-6, 2, 300), [0.0, 1e3]])
    for bounds in (telemetry.LATENCY_BUCKETS,
                   tuple(10.0 ** e for e in range(-12, 3))):
        got, want = telemetry.Histogram("t", bounds), \
            jtelemetry.Histogram("t", bounds)
        for v in samples:
            got.observe(v)
            want.observe(v)
        for q in np.linspace(0.0, 1.0, 21):
            assert got.quantile(q) == want.quantile(q), q
        assert got.summary() == want.summary()


def test_registry_counters_always_on_and_reset():
    assert not telemetry.enabled()
    telemetry.counter("x.hits").inc()
    telemetry.counter("x.hits").inc(2)
    telemetry.histogram("x.lat").observe(1e-3)
    d = telemetry.registry().to_dict()
    assert d["counters"]["x.hits"] == 3
    assert d["histograms"]["x.lat"]["count"] == 1
    telemetry.reset()
    assert telemetry.registry().to_dict() == {"counters": {},
                                              "histograms": {}}


# ---------------------------------------------------------------------------
# plan observations + drift detection
# ---------------------------------------------------------------------------


def _observe(tm, topo, plan="pip_mcoll", seconds=(1e-3, 2e-3, 3e-3),
             coll="allreduce", nbytes=4096):
    for s in seconds:
        tm.observe_plan(topo, coll, "float32", nbytes, plan, s)


def test_observe_plan_median_keeps_sync_and_dispatch_separate():
    """Every plan observation is a window that ended in a device wait:
    the port keeps no dispatch-only samples, so a blocking method's call
    leaves none beside the synced ones the median is taken over."""
    telemetry.enable()
    topo = Topology(4, 2)
    _observe(telemetry, topo, seconds=(1e-3, 2e-3, 3e-3))
    grid, comm = _grid_comm()
    comm.allreduce(torch.ones((1, 16), dtype=torch.float32))
    (obs,) = telemetry.plan_observations()
    assert obs.median() == 2e-3 and len(obs.samples) == 3
    assert not hasattr(obs, "dispatch_samples")
    reg = telemetry.registry().to_dict()["histograms"]
    assert reg["plan.allreduce.pip_mcoll.sync_seconds"]["count"] == 3
    assert not any(k.endswith(".dispatch_seconds") for k in reg)
    (row,) = telemetry.snapshot()["plans"]
    assert row["observed_median_s"] == 2e-3 and row["samples"] == 3
    assert "dispatch_samples" not in row and "dispatch_median_s" not in row


def _both(fn):
    """``fn(tm, autotune, Topology)`` on the port and on the reference."""
    telemetry.enable()
    jtelemetry.enable()
    return (fn(telemetry, autotune, Topology),
            fn(jtelemetry, jautotune, JTopology))


def _drift_rows(rows):
    return [dataclasses.asdict(r) for r in rows]


def test_drift_report_flags_table_divergence_both_directions():
    rng = np.random.default_rng(11)
    noise = rng.uniform(0.9, 1.1, 9) * 2e-3

    def build(tm, at, T):
        topo = T(4, 2, node_link="host_ipc", local_link="host_cpu")
        sel = at.Selector(table=at.TuningTable())
        # in-band row: table within 1.5x of the observed median
        _observe(tm, topo, plan="pip_mcoll", seconds=noise[:3])
        sel.table.record(topo, "allreduce", "float32", 4096, "pip_mcoll",
                         1.5e-3)
        # poisoned-fast row: the table claims 1000x faster
        _observe(tm, topo, plan="ring", seconds=noise[3:6])
        sel.table.record(topo, "allreduce", "float32", 4096, "ring", 2e-6)
        # poisoned-slow row: the table claims 1000x slower
        _observe(tm, topo, plan="recursive_doubling", seconds=noise[6:])
        sel.table.record(topo, "allreduce", "float32", 4096,
                         "recursive_doubling", 2.0)
        return (_drift_rows(tm.drift_report(selector=sel)),
                _drift_rows(tm.drifted_plans(selector=sel)))

    (report, flagged), (jreport, jflagged) = _both(build)
    assert report == jreport and flagged == jflagged
    rows = {r["plan"]: r for r in report}
    assert not rows["pip_mcoll"]["flagged"]
    assert rows["ring"]["flagged"] and rows["ring"]["drift_vs_table"] > 0
    assert rows["recursive_doubling"]["flagged"]
    assert rows["recursive_doubling"]["drift_vs_table"] < 0
    assert abs(report[0]["drift_vs_table"]) >= \
        abs(report[-1]["drift_vs_table"])
    assert {r["plan"] for r in flagged} == {"ring", "recursive_doubling"}


def test_drift_report_without_table_entry_reports_model_only():
    def build(tm, at, T):
        _observe(tm, T(4, 2), plan="pip_mcoll", seconds=(2e-3,) * 3)
        return _drift_rows(tm.drift_report(selector=at.Selector(
            table=at.TuningTable())))

    (row,), jrows = _both(build)
    assert [row] == jrows
    assert row["table_s"] is None and row["drift_vs_table"] is None
    assert not row["flagged"]  # no table promise: nothing to flag
    assert row["model_s"] is not None and row["drift_vs_model"] is not None


def test_drift_report_min_samples_gate():
    telemetry.enable()
    topo = Topology(4, 2)
    _observe(telemetry, topo, seconds=(2e-3,))
    sel = autotune.Selector(table=autotune.TuningTable())
    assert telemetry.drift_report(selector=sel, min_samples=2) == []
    assert len(telemetry.drift_report(selector=sel, min_samples=1)) == 1


def test_selector_ingest_folds_observed_medians_into_table():
    rng = np.random.default_rng(5)
    fast = rng.uniform(1e-3, 3e-3, 3)

    def build(tm, at, T):
        topo = T(4, 2, node_link="host_cpu", local_link="host_cpu")
        _observe(tm, topo, plan="pip_mcoll", seconds=fast)
        _observe(tm, topo, plan="ring", seconds=(5e-3,))
        sel = at.Selector(table=at.TuningTable())
        gen0 = sel.table.generation
        first = sel.ingest(tm, min_samples=2)  # ring gated out
        entry = dict(sel.table.lookup(topo, "allreduce", "float32", 4096))
        assert sel.table.generation > gen0
        second = sel.ingest(tm, min_samples=1)  # both qualify now
        pick = sel.choose("allreduce", topo, 4096)
        return (first, entry, second,
                sel.table.lookup(topo, "allreduce", "float32", 4096),
                (pick.algo, pick.chunks, pick.codec, pick.source,
                 pick.seconds))

    got, want = _both(build)
    assert got == want
    first, entry, second, table, pick = got
    assert first == 1 and entry == {"pip_mcoll": float(np.median(fast))}
    assert second == 2 and table["ring"] == 5e-3
    assert pick[:4] == ("pip_mcoll", 1, "none", "measured")


def test_should_sample_is_deterministic_one_in_n():
    telemetry.enable()
    hits = [telemetry.should_sample("k", every=4) for _ in range(8)]
    assert hits == [True, False, False, False, True, False, False, False]
    jtelemetry.enable()
    rng = np.random.default_rng(2)
    keys = [f"ef:{k}" for k in rng.integers(0, 5, 200)]
    for every in (1, 3, telemetry.SAMPLE_EVERY):
        assert [telemetry.should_sample(k, every) for k in keys] == \
            [jtelemetry.should_sample(k, every) for k in keys]


# ---------------------------------------------------------------------------
# disabled-path invariance: telemetry never changes results or caching
# ---------------------------------------------------------------------------


def _run_all(comm, topo):
    outs = {}
    for name in runtime.collectives():
        x = runtime.example_input(name, topo, 256, devices=comm.grid.world,
                                  device="cpu")
        outs[name] = comm.invoke(name, x).clone()
    return outs


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)], ids=["1x1", "2x4"])
def test_outputs_and_exec_cache_keys_invariant_under_telemetry(shape):
    grid, comm = _grid_comm(*shape)
    runtime.clear_cache()
    base = _run_all(comm, comm.topo)
    keys_off = set(runtime._EXEC_CACHE)
    telemetry.enable()
    runtime.clear_cache()
    traced = _run_all(comm, comm.topo)
    keys_on = set(runtime._EXEC_CACHE)
    assert keys_on == keys_off, "telemetry state leaked into cache keys"
    for name, out in base.items():
        assert torch.equal(out, traced[name]), name
    names = {s.name for s in telemetry.spans()}
    assert {f"build/{n}" for n in runtime.collectives()} <= names
    assert {f"plan_resolve/{n}" for n in runtime.collectives()} <= names
    assert set(runtime.collectives()) <= names  # the per-call emits
    # a blocking method's call ends in no device wait: no plan sample
    assert telemetry.plan_observations() == []


def test_persistent_op_bitwise_invariant_and_sampled_probe_gated():
    grid, comm = _grid_comm()
    x = torch.arange(64, dtype=torch.float32).reshape(1, 64)
    op = comm.allreduce_init(x, algo="pip_mcoll")
    off = op.start(x).wait().clone()
    telemetry.enable()
    on = op.start(x).wait().clone()
    assert torch.equal(off, on)
    comm_spans = [s for s in telemetry.spans() if s.cat == "comm"]
    assert comm_spans and dict(comm_spans[-1].args)["algo"] == "pip_mcoll"
    assert comm_spans[-1].track.startswith("comm:allreduce#")
    (obs,) = [o for o in telemetry.plan_observations()
              if o.collective == "allreduce"]
    assert len(obs.samples) == 1  # blocking wait: one synced sample
    op.start(x).wait(block=False)  # non-blocking: a window, no sample
    assert len(obs.samples) == 1
    assert len([s for s in telemetry.spans() if s.cat == "comm"]) == 2
    released = telemetry.counter("comm.persistent_releases").value
    op.release()
    assert telemetry.counter("comm.persistent_releases").value == \
        released + 1
    assert telemetry.spans()[-1].name == "persistent_release/allreduce"


def test_snapshot_unifies_observables_when_disabled():
    grid, comm = _grid_comm()
    runtime.clear_cache()
    comm.allreduce(torch.ones((1, 16), dtype=torch.float32))
    snap = telemetry.snapshot()
    assert snap["enabled"] is False
    assert snap["process"] == {"index": 0, "count": 1}
    assert snap["tracer"]["spans"] == 0
    assert snap["cache"]["exec_misses"] >= 1
    assert snap["selection"]["total"] >= 1
    assert isinstance(snap["live_persistent_ops"], int)
    assert snap["plans"] == []


def test_cache_stats_reset_zeroes_in_place():
    grid, comm = _grid_comm()
    runtime.clear_cache()
    comm.allreduce(torch.ones((1, 16), dtype=torch.float32))
    s = runtime.cache_stats()
    assert s.exec_misses >= 1
    s.reset()
    assert runtime.cache_stats().exec_misses == 0
    assert runtime.cache_stats().exec_hits == 0


# ---------------------------------------------------------------------------
# acceptance on a CPU RankGrid(2, 4) (telemetry_check.py's legs)
# ---------------------------------------------------------------------------


def test_bucket_windows_nest_in_the_sync_span(tmp_path):
    """A bucketed int8 sync with error feedback, traced: one window a
    bucket, each on its own ``bucket:<i>`` track and inside the sync's
    span, exported and loaded back equal; the sampled error-feedback and
    ratio probes land in ``snapshot()``; the results and the carry are
    bitwise those of the same step untraced."""
    from repro_torch.train import manual_step as ms

    grid, comm = _grid_comm(2, 4)
    n_buckets, n = 5, 4 * 300
    slices = ms.bucket_slices(n_buckets * n, n)
    gs = ms.OverlappedGradSync(comm, slices, metric_len=4, algo="pip_mcoll",
                               codec="int8_block", error_budget=0.5 / 127)
    g = torch.Generator().manual_seed(0)
    grads = torch.randn((8, n_buckets * n), generator=g) * 1e-2
    buckets = [grads[:, s:s + k] for s, k in slices]
    mvec = torch.ones((8, 4))
    gs.ensure_ops(0)
    gs.sync(buckets, mvec)  # a first step leaves a carry behind
    carry = [e.clone() for e in gs.errs]
    # the same step untraced and traced, from the same carry
    want = [y.clone() for y in gs.sync(buckets, mvec)[0]]
    want_errs = [e.clone() for e in gs.errs]
    for e, c in zip(gs.errs, carry):
        e.copy_(c)
    telemetry.enable()
    with telemetry.span("train/sync", cat="train"):
        synced, _ = gs.sync(buckets, mvec)
    for y, w, e, we in zip(synced, want, gs.errs, want_errs):
        assert torch.equal(y, w) and torch.equal(e, we)
    spans = telemetry.spans()
    (step,) = [s for s in spans if s.name == "train/sync"]
    windows = [s for s in spans if s.cat == "bucket"]
    assert len(windows) == n_buckets
    assert sorted(s.track for s in windows) == \
        sorted(f"bucket:{i}" for i in range(n_buckets))
    for s in windows:
        assert step.start <= s.start and s.end <= step.end + 1e-9
        tags = dict(s.args)
        assert tags["collective"] == "allreduce" and tags["algo"] == \
            "pip_mcoll" and tags["codec"] == "int8_block"
    trace = telemetry.export_chrome_trace(tmp_path / "trace.json")
    assert json.loads((tmp_path / "trace.json").read_text()) == trace
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    assert {f"bucket:{i}" for i in range(n_buckets)} <= names
    # one probe per bucket: each bucket's first traced wait is sampled
    hist = telemetry.snapshot()["histograms"]
    assert hist["codec.int8_block.ef_rel_error"]["count"] == n_buckets
    ratio = hist["codec.int8_block.achieved_ratio"]
    assert ratio["count"] == n_buckets and ratio["min"] > 3.0
    gs.release()


def test_poisoned_row_is_flagged_and_healed_by_ingest():
    grid, comm = _grid_comm(2, 4)
    comm = Communicator(grid, comm.topo, selector=autotune.Selector())
    topo, sel, nbytes = comm.topo, comm.selector, 4096
    telemetry.enable()
    rows = comm.calibrate(names=("allreduce",), sizes=(nbytes,), iters=4,
                          codecs=())
    obs = [o for o in telemetry.plan_observations() if o.samples]
    assert sum(len(o.samples) for o in obs) == 4 * len(rows)
    good = sel.choose("allreduce", topo, nbytes)
    good_plan = autotune.encode_plan(good.algo, good.chunks, good.codec)
    entry = sel.table.lookup(topo, "allreduce", "float32", nbytes)
    # the victim: the slowest lossless plan, so its own observations keep
    # it above the argmin once they are folded back in
    victim = max(entry, key=entry.get)
    assert victim != good_plan
    sel.table.record(topo, "allreduce", "float32", nbytes, victim, 1e-9)
    hijacked = sel.choose("allreduce", topo, nbytes)
    assert autotune.encode_plan(hijacked.algo, hijacked.chunks,
                                hijacked.codec) == victim
    algo, chunks, codec = autotune.decode_plan(victim)
    x = runtime.example_input("allreduce", topo, nbytes, device="cpu")
    op = comm.allreduce_init(x, algo=algo,
                             chunks=chunks if chunks > 1 else None)
    assert op.plan == victim
    for _ in range(3):
        op.start(x).wait(block=True)
    op.release()
    flagged = {r.plan: r for r in telemetry.drifted_plans(selector=sel)}
    assert victim in flagged and flagged[victim].table_s == 1e-9
    assert flagged[victim].drift_vs_table > 0.5
    assert sel.ingest(min_samples=2) >= len(entry)
    repaired = sel.choose("allreduce", topo, nbytes)
    assert autotune.encode_plan(repaired.algo, repaired.chunks,
                                repaired.codec) == good_plan
    assert victim not in {r.plan for r in
                          telemetry.drifted_plans(selector=sel)}


def test_bucket_rebuild_counter_and_instant():
    """A budget schedule that moves the buckets' plan rebuilds the ops:
    the ``train.bucket_rebuilds`` counter (always live) and, telemetry on,
    a ``bucket_rebuild`` instant naming the new plans."""
    from repro_torch.train import manual_step as ms

    grid, comm = _grid_comm(2, 4)
    slices = ms.bucket_slices(2 * 512, 512)
    gs = ms.OverlappedGradSync(
        comm, slices, metric_len=4, algo="pip_mcoll",
        error_budget=lambda step: 0.0 if step == 0 else 0.5 / 127)
    gs.ensure_ops(0)
    assert gs.plans() == ["pip_mcoll"] * 2
    telemetry.enable()
    gs.ensure_ops(1)
    assert gs.rebuilds == 1
    assert telemetry.counter("train.bucket_rebuilds").value == 1
    (inst,) = [s for s in telemetry.spans() if s.name == "bucket_rebuild"]
    args = dict(inst.args)
    assert inst.duration == 0.0 and args["step"] == 1
    assert args["plans"] == ",".join(gs.plans()) and "@" in args["plans"]
    gs.release()
