"""The benchmark's general part: it finds a cell's configuration, traffic
mix, driver, limits and metric readers by name, runs set-up, the measured
window and the correctness check in that order, and prints the result.

Files are found by the names ``BENCHMARK.json`` gives (``<kind>/<name>``
under this folder, or under another ``base`` a test hands in):

- ``configs/<config>.json``: the configuration as run, its source and
  every key changed from it;
- ``traffic/<mix>.json``: the mix's parameters, among them the
  ``driver`` that runs it, the ``warm_steps`` that set-up runs after
  the driver's own, so that the window starts in the steady state, and
  ``ahead_steps``, how many steps the window may dispatch ahead of the
  one it waits for (0, each step ended by a synchronize, where absent);
- ``drivers/<driver>.py``: ``setup``, ``step``, ``after_window``,
  ``trace`` and ``check`` for one kind of traffic;
- ``limits/<workload>.json``: each number ``check`` compares, with its
  limit and the readings it was set from;
- ``metrics/<metric>.py``: ``read(run)`` of one metric, None when there is
  nothing to read.

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries; nothing here names one.
"""
from __future__ import annotations

import functools
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time
import types
from typing import Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
KINDS = {"configs": ".json", "traffic": ".json", "limits": ".json",
         "metrics": ".py", "drivers": ".py"}
#: top-level module names that may not be loaded in a measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def find(kind: str, name: str, base: pathlib.Path = HERE) -> pathlib.Path:
    """``<base>/<kind>/<name><ext>``; raises ``KeyError`` when absent."""
    if kind not in KINDS:
        raise KeyError(f"unknown kind {kind!r}")
    path = pathlib.Path(base) / kind / f"{name}{KINDS[kind]}"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str, base: pathlib.Path = HERE) -> Dict:
    return json.loads(find(kind, name, base).read_text())


def load_module(kind: str, name: str, base: pathlib.Path = HERE
                ) -> types.ModuleType:
    path = find(kind, name, base)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(path: pathlib.Path = REPO / "BENCHMARK.json") -> Dict:
    return json.loads(pathlib.Path(path).read_text())


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r}")


def metrics_of(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones (a metric without ``workloads`` is every cell's)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def compare(numbers: Dict[str, float], limits: Dict[str, Dict]
            ) -> Dict[str, Dict]:
    """Each compared number beside its limit; a number missing, not
    finite or over its limit fails."""
    out = {}
    for name, spec in limits.items():
        v = numbers.get(name)
        ok = v is not None and math.isfinite(v) and v <= spec["limit"]
        out[name] = {"value": v, "limit": spec["limit"], "ok": bool(ok)}
    return out


def device_info(torch, device) -> Dict:
    if getattr(device, "type", str(device)) == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             bench: Optional[Dict] = None, base: pathlib.Path = HERE,
             t_start: Optional[float] = None, hooks: Optional[Dict] = None,
             config: Optional[Dict] = None,
             traffic: Optional[Dict] = None) -> Optional[Dict]:
    """One run of cell ``name``. Returns the result (``None`` when a
    forbidden module was loaded). ``config`` replaces the cell's
    configuration's ``model`` and ``traffic`` its mix (the tests' small
    sizes); ``hooks`` reach the driver (the tests' planted faults)."""
    import torch

    from portbench import window as _window

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench if bench is not None else benchmark()
    cell = workload(bench, name)
    conf = load_json("configs", cell["config"], base)
    if traffic is None:
        traffic = load_json("traffic", cell["traffic"], base)
    limits = load_json("limits", name, base)
    driver = load_module("drivers", traffic["driver"], base)
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else \
        (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def mark():
        if not cuda:
            return None
        done = torch.cuda.Event()
        done.record()
        return done

    window = functools.partial(_window.run,
                               ahead=int(traffic.get("ahead_steps", 0)),
                               mark=mark)
    ctx = types.SimpleNamespace(
        torch=torch, device=device, seed=int(seed), seconds=float(seconds),
        cfg=config if config is not None else conf["model"],
        grid=conf["grid"], traffic=traffic, sync=sync, window=window,
        hooks=hooks or {})
    state = driver.setup(ctx)
    warm = int(traffic.get("warm_steps", 0))
    for k in range(warm):
        driver.step(state, state.next_step + k)
    state.next_step += warm
    sync()
    # set-up's objects out of the collector's way: the window's
    # collections scan only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    run = {"setup_s": setup_s, "cfg": ctx.cfg, "traffic": traffic,
           "cell": name, "trace": None}
    if trace:
        run["trace"] = driver.trace(state, ctx)
        win = run["trace"]["window"]
        steps = run["trace"]["untraced"]["steps"] + win["steps"] \
            + run["trace"].get("extra_steps", 0)
    else:
        win = window(lambda i: driver.step(state, i), sync, ctx.seconds,
                     first=state.next_step)
        state.next_step += win["steps"]
        steps = win["steps"]
    run["window"] = win
    driver.after_window(state, ctx)
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    values = {}
    for m in metrics_of(bench, name, trace):
        v = load_module("metrics", m["name"], base).read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    gc.unfreeze()
    numbers = driver.check(state, ctx)
    checks = compare(numbers, limits)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return None
    n_bad = sum(not c["ok"] for c in checks.values())
    dev = dict(device_info(torch, device), memory_peak_bytes=int(peak))
    result = {"correct": n_bad == 0 and bool(checks),
              "attempted": int(steps + warm + state.check_steps),
              "failed": n_bad, "metrics": values, "device": dev}
    if trace:
        tr = run["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window"]["window_s"]
        result["breakdown"] = {"device_ops": tr.get("device_ops", []),
                               "idle_gaps": tr.get("idle_gaps", [])}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def emit(result: Dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
