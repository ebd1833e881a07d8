"""The harness on the CPU: lookup by name, a cell added from files alone,
the window's statistics, the frozen yardstick's arithmetic, the import
rules, every cell end to end at a small size, and on the card (``cuda``)
one small run."""
import ast
import json
import math
import pathlib
import shutil
import time

import pytest

from portbench import costs, harness, trace, window

from conftest import small_config, small_traffic
from small import run_small

PB = harness.HERE
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


# -- lookup by name -----------------------------------------------------------

def test_every_name_in_the_benchmark_has_its_files():
    bench = harness.benchmark()
    for c in bench["configs"]:
        assert harness.find("configs", c["name"]) == \
            harness.REPO / c["file"]
    for w in bench["workloads"]:
        tr = harness.load_json("traffic", w["traffic"])
        harness.find("drivers", tr["driver"])
        harness.find("limits", w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("kind", sorted(harness.KINDS))
def test_an_unknown_name_fails(kind):
    with pytest.raises(KeyError):
        harness.find(kind, "no-such-name")


def test_a_cell_added_from_files_alone(tmp_path):
    """A configuration, a mix, a metric and limits added under another
    folder, the benchmark's entries extended in memory: the harness runs
    the new cell and reports the new metric, no file of it edited."""
    for kind in ("drivers", "metrics"):
        shutil.copytree(PB / kind, tmp_path / kind)
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    conf = json.loads((PB / "configs" / "smollm-360m.dp2x4.json")
                      .read_text())
    conf["name"] = "tiny.dp2x4"
    conf["model"] = dict(conf["model"], n_layers=1, d_model=32,
                         n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                         vocab=256)
    (tmp_path / "configs" / "tiny.dp2x4.json").write_text(json.dumps(conf))
    mix = dict(harness.load_json("traffic", "gradsync.int8ef.b128m"),
               bucket_bytes=4096)
    (tmp_path / "traffic" / "gradsync.small.json").write_text(
        json.dumps(mix))
    (tmp_path / "limits" / "tiny.gradsync.json").write_text(
        (PB / "limits" / "smollm360m.gradsync.int8ef.b128m.json").read_text())
    (tmp_path / "metrics" / "sync_steps.py").write_text(
        "def read(run):\n    return run['window']['steps']\n")
    bench = harness.benchmark()
    bench["workloads"].append({"name": "tiny.gradsync", "config":
                               "tiny.dp2x4", "traffic": "gradsync.small",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "sync_step_ms":
            m["workloads"].append("tiny.gradsync")
    bench["end_to_end"].append({"name": "sync_steps", "unit": "steps",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.gradsync"]})
    r = harness.run_cell("tiny.gradsync", 2 ** 31 + 99, 0.2, False, "cpu",
                         bench=bench, base=tmp_path)
    assert r["correct"], r["checks"]
    assert r["metrics"]["sync_steps"]["value"] >= 1
    assert {"sync_step_ms", "setup_s"} <= set(r["metrics"])


# -- the window ---------------------------------------------------------------

def test_window_rate_and_percentile_over_all_steps():
    steps = [0.1] * 99 + [1.0]
    win = {"step_s": steps, "window_s": sum(steps), "steps": 100}
    assert window.per_step_ms(win) == pytest.approx(1e3 * 10.9 / 100)
    assert window.rate(512, win) == pytest.approx(512 * 100 / 10.9)
    assert window.percentile(steps, 90) == 0.1
    assert window.percentile(steps, 100) == 1.0
    # ten stalls: the p90 is one of the steps beyond the 90th of 100
    stalled = [0.1] * 89 + [1.0] * 11
    assert window.percentile(stalled, 90) == 1.0


def test_a_stall_moves_the_rate_and_the_p90():
    def timed(stall_every):
        n = {"i": 0}

        def step(i):
            n["i"] += 1
            time.sleep(0.03 if stall_every and i % stall_every == 0
                       else 0.002)
        return window.run(step, lambda: None, 0.25)

    calm, stalled = timed(0), timed(3)
    assert calm["steps"] > stalled["steps"]
    assert window.per_step_ms(stalled) > 2 * window.per_step_ms(calm)
    assert window.percentile(stalled["step_s"], 90) > \
        5 * window.percentile(calm["step_s"], 90)
    # the window's time is all of its steps' and nothing else's
    assert stalled["window_s"] == pytest.approx(sum(stalled["step_s"]),
                                                rel=0.05)


class _Device:
    """A device that runs each step's work ``per_step`` seconds after the
    host dispatched it or after its previous work ends, whichever is
    later: events and synchronizes wait on the host clock."""

    def __init__(self, per_step):
        self.per_step, self.free_at, self.waited = per_step, 0.0, []

    def dispatch(self):
        self.free_at = max(self.free_at, time.perf_counter()) \
            + self.per_step

    def _until(self, t):
        time.sleep(max(0.0, t - time.perf_counter()))

    def sync(self):
        self._until(self.free_at)

    def mark(self):
        dev, t = self, self.free_at

        class Done:
            def synchronize(self):
                dev._until(t)
                dev.waited.append(t)
        return Done()


def test_a_window_that_dispatches_ahead_hides_host_stalls():
    """A host stall shorter than the steps in flight leaves the device
    fed: the window dispatching ahead reads the device's pace, the one
    ending each step in a synchronize the host's stalls besides; every
    step sent is waited for, and the window's time is all of its steps'
    and ends after the last of them."""
    def timed(ahead):
        dev = _Device(0.005)

        def step(i):
            time.sleep(0.015 if i % 5 == 0 else 0.001)
            dev.dispatch()
        t0 = time.perf_counter()
        win = window.run(step, dev.sync, 0.3, ahead=ahead, mark=dev.mark)
        return win, dev, t0

    plain, _, _ = timed(0)
    ahead, dev, t0 = timed(8)
    assert window.per_step_ms(ahead) < 0.8 * window.per_step_ms(plain)
    assert len(dev.waited) == ahead["steps"] == len(ahead["step_s"])
    assert ahead["window_s"] == pytest.approx(sum(ahead["step_s"]))
    assert t0 + ahead["window_s"] >= max(dev.waited)
    assert ahead["window_s"] >= 0.3


def test_the_mixs_ahead_steps_reach_the_window(monkeypatch):
    name = CELLS[0]
    cell = harness.workload(harness.benchmark(), name)
    tr = small_traffic(harness.load_json("traffic", cell["traffic"]))
    seen = []
    run = window.run

    def spy(*a, **kw):
        seen.append(kw.get("ahead"))
        return run(*a, **kw)
    monkeypatch.setattr(window, "run", spy)
    for ahead in (0, 3):
        seen.clear()
        r = harness.run_cell(name, 2 ** 31 + 7, 0.0, False, "cpu",
                             config=small_config(cell["config"]),
                             traffic=dict(tr, ahead_steps=ahead))
        assert r["correct"] and seen == [ahead]


# -- the yardstick ------------------------------------------------------------

def test_encode_and_decode_costs_by_hand():
    # (16, 819200): 3200 blocks a slice
    nbytes, ops = costs.block_encode_cost("int8", 16, 819200)
    assert nbytes == 4 * 16 * 819200 + 16 * 3200 * 256 + 4 * 16 * 3200 \
        + 4 * 16 * 819200 == 118_169_600
    assert ops == 117_964_800
    assert costs.bound_s(nbytes, ops) == pytest.approx(118_169_600 / 3.35e12)
    nbytes, ops = costs.block_decode_reduce_cost("int8", 8, 2, 3200, 819200)
    assert nbytes == 13_107_200 + 204_800 + 26_214_400
    assert ops == 2 * 8 * 2 * 819200
    assert costs.block_encode_cost("int8", 1, 257, True)[0] == \
        8 * 257 + 2 * 256 + 8 + 4 * 257


def test_model_flops_by_hand():
    smollm = json.loads((PB / "configs" / "smollm-360m.dp2x4.json")
                        .read_text())["model"]
    per_token = 32 * (960 * 960 * 2 + 960 * 320 * 2 + 3 * 960 * 2560) \
        + 960 * 49152
    assert costs.matmul_params_per_token(smollm) == per_token == 361_758_720
    attn = 3 * 2 * 8 * 15 * 2048 * 2048 * 64 * 32
    assert costs.train_step_flops(smollm, 8, 2048) == \
        6 * per_token * 8 * 2048 + attn
    qwen = json.loads((PB / "configs" / "qwen3-moe-235b-a22b.l1.ep2x4.json")
                      .read_text())["model"]
    per_token = (4096 * 8192 * 2 + 4096 * 512 * 2) + 4096 * 128 \
        + 8 * 3 * 4096 * 1536 + 4096 * 151936
    assert costs.matmul_params_per_token(qwen) == per_token
    # 3 x 2·B·H·S²·hd a layer
    assert costs.train_step_flops(qwen, 8, 512) == \
        6 * per_token * 4096 + 3 * 2 * 8 * 64 * 512 * 512 * 128
    assert costs.sync_least_bytes(409_007_040, 8) == 52_352_901_120


def _run(tr, **kw):
    return dict({"trace": tr, "setup_s": 1.0}, **kw)


def test_roofline_and_mfu_readers_by_hand():
    us = 1000  # ns
    prof = {"kernels": [("int8_block_encode<false>", 0, 50 * us, 1),
                        ("int8_decode_reduce<>", 60 * us, 20 * us, 2),
                        ("elementwise_kernel", 100 * us, 30 * us, 3)],
            "host": [], "wall_s": 200e-6}
    tr = {"steps": 1, "busy_s": trace.busy_s(prof), "profile": prof,
          "encodes": [("int8", 16, 819200, False)],
          "decodes": [("int8", 8, 2, 3200, 819200)],
          "window": {"window_s": 300e-6, "steps": 1},
          "untraced": {"window_s": 600e-6, "steps": 3}, "n_params": 1000,
          "world": 8}
    assert tr["busy_s"] == pytest.approx(100e-6)
    read = lambda name, run: harness.load_module("metrics", name).read(run)
    enc = read("int8_encode_roofline.sync", _run(tr))
    assert enc == pytest.approx(100 * (118_169_600 / 3.35e12) / 50e-6)
    dec = read("int8_decode_reduce_roofline.sync", _run(tr))
    assert dec == pytest.approx(100 * (39_526_400 / 3.35e12) / 20e-6)
    assert read("grid_device_ms.sync", _run(tr)) == pytest.approx(0.03)
    # 100 us busy from the first kernel's start to the last one's end, 130
    assert read("device_idle.sync", _run(tr)) == pytest.approx(
        100 * (1 - 100 / 130))
    assert read("mfu_hbm.sync", _run(tr)) == pytest.approx(
        100 * 16 * 1000 * 8 / 3.35e12 / 200e-6)
    cfg = json.loads((PB / "configs" / "smollm-360m.dp2x4.json")
                     .read_text())["model"]
    tr["untraced"] = {"window_s": 4.0, "steps": 2}
    mfu = read("train_mfu", _run(tr, cfg=cfg, traffic={"batch": 8,
                                                       "seq_len": 2048}))
    assert mfu == pytest.approx(
        100 * costs.train_step_flops(cfg, 8, 2048) / 989.4e12 / 2.0)
    # nothing to read: no value, never a 0
    empty = dict(tr, busy_s=0.0)
    for name in ("int8_encode_roofline.sync", "train_mfu",
                 "device_idle.train", "device_idle.sync", "mfu_hbm.sync"):
        assert read(name, _run(empty, cfg=cfg, traffic={
            "batch": 8, "seq_len": 2048})) is None


def test_the_traced_step_is_the_untraced_windows():
    """The shares of a traced run divide by the step time of an untraced
    window as long as an untraced run's, taken as that run takes it, and
    the profiled steps follow it: a slow start moves both alike."""
    import torch
    calls, marks = [], []

    def step(i):
        calls.append(i)
        time.sleep(0.02 if len(calls) <= 3 else 0.004)

    tr = trace.traced_window(torch, step, 5, 0.3, 2, lambda: None,
                             on_profile=lambda: marks.append(len(calls)))
    n = tr["untraced"]["steps"]
    assert calls == list(range(5, 5 + n + 2)) and marks == [n]
    assert tr["untraced"]["window_s"] >= 0.3
    assert trace.step_s(tr) == pytest.approx(
        window.per_step_ms(tr["untraced"]) / 1e3)
    calls.clear()
    plain = window.run(step, lambda: None, 0.3)
    assert trace.step_s(tr) == pytest.approx(
        window.per_step_ms(plain) / 1e3, rel=0.3)
    assert tr["steps"] == 2 and tr["next_step"] == 5 + n + 2


def test_set_up_runs_the_mixs_warm_steps_before_the_window():
    name = CELLS[0]
    cell = harness.workload(harness.benchmark(), name)
    tr = small_traffic(harness.load_json("traffic", cell["traffic"]))
    seen = []

    def spy(st, ctx):
        sync = st.gs.sync

        def counted(*a, **kw):
            seen.append(1)
            return sync(*a, **kw)
        st.gs.sync = counted
    for warm in (0, 4):
        seen.clear()
        r = harness.run_cell(name, 2 ** 31 + 5, 0.0, False, "cpu",
                             hooks={"fault": spy},
                             config=small_config(cell["config"]),
                             traffic=dict(tr, warm_steps=warm))
        assert r["correct"], r["checks"]
        # check steps and the one after the window, warm steps, one window
        # step (a window of 0 s ends after its first)
        assert len(seen) == 3 + warm + 1 + 1
        assert r["attempted"] == 3 + 1 + warm + 1


def test_idle_gaps_and_ranges():
    prof = {"kernels": [("a", 100, 10, 7), ("b", 200, 10, 8)],
            "host": [("step", 0, 300, 0), ("wait_for_host", 110, 200, 0),
                     ("ep_alltoall", 150, 215, 0),
                     ("cudaLaunchKernel", 160, 165, 8),
                     ("cudaLaunchKernel", 90, 95, 7)],
            "wall_s": 300e-9}
    gaps = dict((k, v) for k, v in trace.idle_gaps(prof))
    assert gaps["wait_for_host"] == pytest.approx(90e-9)
    assert gaps["step"] == pytest.approx(100e-9)
    assert gaps["ep_alltoall"] == pytest.approx(90e-9)
    assert trace.range_kernel_s(prof, "ep_alltoall") == pytest.approx(10e-9)
    assert trace.range_kernel_s(prof, "absent") is None
    assert trace.top_kernels(prof)[0][1] == pytest.approx(10e-9)


# -- imports ------------------------------------------------------------------

def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        bad = set(_imports(path)) & {"jax", "repro", "repro_torch",
                                      "portbench"}
        assert not bad, f"{path} imports {bad}"


def test_a_forbidden_module_is_found_by_its_whole_top_level_name(
        monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torchish", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["repro"]


# -- every cell, small, on the CPU ---------------------------------------------

@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_small_and_prints_its_metrics(name, trace_on):
    r = run_small(name, 2 ** 31 + 17, trace=trace_on)
    bench = harness.benchmark()
    assert r["device"]["platform"] == "cpu"
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device",
                      "checks"}
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1
    assert set(r["checks"]) == set(harness.load_json("limits", name))
    if not trace_on:
        want = {m["name"] for m in harness.metrics_of(bench, name, False)}
        assert set(r["metrics"]) == want
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        # the CPU records no device activity: the device readers are silent
        assert r["device"]["busy_s"] == 0.0
        assert r["device"]["window_s"] > 0


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_small_on_the_card(name, cuda_device):
    r = run_small(name, 2 ** 31 + 23, trace=True, device=cuda_device)
    # the limits hold at the cells' own sizes; here the run, the
    # reference and every reader have to go through on the card
    assert all(math.isfinite(c["value"]) for c in r["checks"].values())
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
    for m in r["metrics"].values():
        assert math.isfinite(m["value"])
