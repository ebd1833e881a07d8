"""The port's serving engine: the mirrors of ``tests/test_serve.py`` (on
the reduced smollm config, on the CPU), the tick sync on a 2x4 CPU rank
grid, and the port's engine against the reference ``Engine`` token for
token.

The reference side — this file's ``__main__``, run once per module in a
subprocess — serves ``_requests()`` with ``repro.serve.engine.Engine`` on
``decoder.init(PRNGKey(0))`` and records every generated token with the
top-2 logit margin of the logits it was picked from; the port serves the
same requests on the same weights (``interop.params_from_reference``).
Both serve in bfloat16, where the two packages round at different places
(``tests/test_torch_decoder.py`` holds their logits within ``BF16_TOL``
times the largest logit), so a greedy pick may flip where the reference's
top-2 margin is within that tolerance of both sides: at a request's first
differing token the reference's margin must be under ``2 * BF16_TOL *
max|logit|``, and the request's later tokens follow another context.
"""
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.core import runtime, telemetry
from repro_torch.core.grid import RankGrid
from repro_torch.models.decoder import DecoderLM, RunFlags
from repro_torch.serve.engine import REBIND_WARN_THRESHOLD, Engine, Request

#: bfloat16 logits of the two packages: relative to the largest |logit|
#: (``tests/test_torch_decoder.py``)
BF16_TOL = 2.0 ** -6
MAX_BATCH, MAX_LEN, NEW = 2, 64, 6


def _requests():
    rng = np.random.default_rng(3)
    return [Request(prompt=rng.integers(0, 512, size=(n,), dtype=np.int32),
                    max_new_tokens=NEW)
            for n in (12, 3, 7, 9, 5)]


def _reference(out_path: str) -> None:
    import jax
    from repro.configs import reduced_config as jreduced
    from repro.models import decoder
    from repro.serve.engine import Engine as JEngine

    cfg = jreduced("smollm-360m")
    params = decoder.init(jax.random.PRNGKey(0), cfg)
    eng = JEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN)
    margins = {}  # id(request) -> [(margin, max|logit|) per token]

    def top2(row):
        row = np.asarray(row, np.float32)
        a, b = np.sort(row)[-2:]
        return b - a, np.abs(row).max()

    prefill, decode, admit = eng._prefill, eng._decode, eng._admit

    def rec_admit(req, slot):
        def rec_prefill(*args):
            last, caches = prefill(*args)
            margins[id(req)] = [top2(last[0, 0])]
            return last, caches
        eng._prefill = rec_prefill
        admit(req, slot)

    def rec_decode(*args):
        logits, caches = decode(*args)
        for slot, req in enumerate(eng.active):
            if req is not None:
                margins[id(req)].append(top2(logits[slot, 0]))
        return logits, caches

    eng._admit, eng._decode = rec_admit, rec_decode
    reqs = _requests()
    eng.run(reqs)
    res = {f"param/{'/'.join(str(k.key) for k in path)}":
           np.asarray(leaf, np.float32)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    for i, r in enumerate(reqs):
        res[f"tokens{i}"] = np.array(r.out_tokens, np.int64)
        res[f"margins{i}"] = np.array(margins[id(r)], np.float64)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("serve_ref") / "ref.npz"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def cfg():
    return reduced_config("smollm-360m")


@pytest.fixture(scope="module")
def model(cfg):
    return DecoderLM(cfg, torch.Generator().manual_seed(0), device="cpu")


def _outputs(model, cfg, prompts, max_batch, **kw):
    eng = Engine(model, cfg, max_batch=max_batch, max_len=MAX_LEN, **kw)
    done = eng.run([Request(prompt=p.copy(), max_new_tokens=NEW)
                    for p in prompts])
    return {tuple(r.prompt.tolist()): r.out_tokens for r in done}


def test_engine_continuous_batching(model, cfg):
    eng = Engine(model, cfg, max_batch=2, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(n,),
                                        dtype=np.int32), max_new_tokens=4)
            for n in (5, 9, 3, 12, 7)]  # 5 requests through 2 slots
    done = eng.run(reqs)
    assert len(done) == 5
    for r in done:
        assert len(r.out_tokens) >= 4
        assert all(0 <= t < cfg.vocab for t in r.out_tokens)


@pytest.mark.parametrize("flash", [False, True])
def test_engine_greedy_matches_direct_decode(model, cfg, flash):
    """A single request through the engine == manual prefill + decode."""
    flags = RunFlags(use_flash_decode=flash)
    prompt = np.arange(6, dtype=np.int32) + 3
    eng = Engine(model, cfg, max_batch=1, max_len=32, flags=flags)
    out = eng.run([Request(prompt=prompt, max_new_tokens=4)])[0].out_tokens

    caches = model.init_cache(1, 32)
    logits, _, caches = model(torch.from_numpy(prompt)[None], caches,
                              flags=flags)
    toks = [int(logits[0, -1].argmax())]
    for i in range(3):
        logits, _, caches = model(torch.tensor([[toks[-1]]]), caches,
                                  len(prompt) + i, flags=flags)
        toks.append(int(logits[0, 0].argmax()))
    assert out == toks, (out, toks)


@pytest.mark.parametrize("flash", [False, True])
def test_engine_mixed_length_admission_matches_solo_runs(model, cfg, flash):
    """A short prompt admitted beside a longer in-flight one decodes as it
    would alone: every slot writes and masks at its own length."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=(n,), dtype=np.int32)
               for n in (12, 3, 7)]
    flags = RunFlags(use_flash_decode=flash)
    solo = {}
    for p in prompts:
        solo.update(_outputs(model, cfg, [p], 1, flags=flags))
    batched = _outputs(model, cfg, prompts, 2, flags=flags)
    assert batched == solo, {k: (batched[k], solo[k]) for k in solo
                             if batched[k] != solo[k]}


def test_engine_degenerate_grid_skips_sync_dispatch(model, cfg):
    """On a world-1 grid there is nothing to reconcile: same tokens, no
    plan resolved, no op built."""
    prompt = np.arange(5, dtype=np.int32) + 2
    want = _outputs(model, cfg, [prompt], 1)
    runtime.clear_cache()
    runtime.selection_stats().reset()
    got = _outputs(model, cfg, [prompt], 1,
                   mesh=RankGrid(1, 1, device="cpu"))
    assert got == want
    s = runtime.cache_stats()
    assert s.exec_misses == 0 and s.exec_hits == 0, s
    assert runtime.selection_stats().total == 0


def test_engine_token_sync_on_a_2x4_grid(model, cfg):
    """Every tick broadcasts its tokens through one persistent op resolved
    once by the selector: the sync-free tokens, one plan resolution, one
    exec-cache entry, a start per tick."""
    prompts = [r.prompt for r in _requests()]
    want = _outputs(model, cfg, prompts, MAX_BATCH)
    runtime.clear_cache()
    runtime.selection_stats().reset()
    eng = Engine(model, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 mesh=RankGrid(2, 4, device="cpu"))
    done = eng.run([Request(prompt=p.copy(), max_new_tokens=NEW)
                    for p in prompts])
    assert {tuple(r.prompt.tolist()): r.out_tokens for r in done} == want
    assert runtime.selection_stats().total == 1
    assert runtime.cache_stats().exec_misses == 1
    m = eng.metrics()
    assert m["sync_starts"] == m["ticks"] >= NEW - 1
    assert m["plan_rebinds"] == 0


def test_engine_sync_knobs_default_and_topo_is_honoured(model, cfg):
    """The reference's knobs (``tests/test_serve.py``): ``sync_algo``
    defaults to ``"auto"`` and the budget to 0; a given ``topo`` reaches
    the Communicator, and the tick sync resolves on it (here with host_ipc
    links between nodes) to the selector's plan for that topology."""
    from repro_torch.core import autotune
    from repro_torch.core.topology import Topology

    grid = RankGrid(2, 4, device="cpu")
    eng = Engine(model, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 mesh=grid)
    assert eng.sync_algo == "auto" and eng.sync_error_budget == 0.0
    assert eng.topo == Topology.from_grid(grid)
    topo = Topology.from_grid(grid, node_link="host_ipc")
    eng = Engine(model, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 mesh=grid, topo=topo)
    assert eng.topo is topo and eng.comm.topo is topo
    eng.run([Request(prompt=np.arange(5, dtype=np.int32) + 2,
                     max_new_tokens=3)])
    assert eng._sync_op.comm.topo is topo
    want = autotune.Selector().choose("broadcast", topo, MAX_BATCH * 4,
                                      dtype="int32")
    assert eng._sync_op.plan == autotune.encode_plan(want.algo, want.chunks,
                                                     want.codec)
    assert Engine(model, cfg, topo=topo).topo is topo  # no mesh: kept


@pytest.mark.parametrize("algo", ["pip_mcoll", "binomial", "xla"])
def test_engine_pinned_sync_algo_gives_the_sync_free_tokens(model, cfg,
                                                             algo):
    """A pinned ``sync_algo`` is the tick sync's plan, and every pinned
    plan gives the sync-free engine's tokens."""
    prompts = [r.prompt for r in _requests()]
    want = _outputs(model, cfg, prompts, MAX_BATCH)
    eng = Engine(model, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 mesh=RankGrid(2, 4, device="cpu"), sync_algo=algo)
    done = eng.run([Request(prompt=p.copy(), max_new_tokens=NEW)
                    for p in prompts])
    assert {tuple(r.prompt.tolist()): r.out_tokens for r in done} == want
    assert eng._sync_op.algo == algo


def test_engine_sync_error_budget_reaches_the_plan_and_stays_lossless(
        model, cfg, monkeypatch):
    """``sync_error_budget`` reaches ``broadcast_init`` with ``sync_algo``;
    integer tokens resolve to a lossless plan for any budget, so the
    tokens are the sync-free engine's."""
    from repro_torch.core import compress
    from repro_torch.core.comm import Communicator

    calls = []
    init = Communicator.broadcast_init

    def spy(self, x=None, **knobs):
        calls.append(knobs)
        return init(self, x, **knobs)

    monkeypatch.setattr(Communicator, "broadcast_init", spy)
    prompts = [r.prompt for r in _requests()]
    want = _outputs(model, cfg, prompts, MAX_BATCH)
    for budget in (0.1, 1.0):
        eng = Engine(model, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                     mesh=RankGrid(2, 4, device="cpu"),
                     sync_error_budget=budget)
        done = eng.run([Request(prompt=p.copy(), max_new_tokens=NEW)
                        for p in prompts])
        assert calls[-1] == {"algo": "auto", "error_budget": budget}
        assert compress.meta(eng._sync_op.codec).error_bound == 0.0
        assert {tuple(r.prompt.tolist()): r.out_tokens
                for r in done} == want


def test_engine_metrics_and_rebind_on_generation_bump(model, cfg):
    prompt = np.arange(5, dtype=np.int32) + 2
    eng = Engine(model, cfg, max_batch=1, max_len=32,
                 mesh=RankGrid(2, 4, device="cpu"))
    want = eng.run([Request(prompt=prompt.copy(), max_new_tokens=4)])
    op = eng._sync_op
    m = eng.metrics()
    assert m["ticks"] == 3 and m["sync_starts"] == 3
    assert m["tick_p99_s"] >= m["tick_p50_s"] > 0.0
    assert m["tick_mean_s"] > 0.0 and m["slot_occupancy"] == pytest.approx(
        2 / 3)
    # a tuning-table mutation mid-serving rebinds the op (an exec-cache hit
    # for the unchanged plan) and keeps the tokens
    hits = runtime.cache_stats().exec_hits
    eng.comm.selector.table.generation += 1
    got = eng.run([Request(prompt=prompt.copy(), max_new_tokens=4)])
    assert got[0].out_tokens == want[0].out_tokens
    assert eng._sync_op is not op and op.released
    assert runtime.cache_stats().exec_hits == hits + 1
    assert eng.metrics()["plan_rebinds"] == 1
    # a table churning every run trips one warning past the threshold
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(REBIND_WARN_THRESHOLD + 2):
            eng.comm.selector.table.generation += 1
            eng.run([Request(prompt=prompt.copy(), max_new_tokens=2)])
    storm = [w for w in rec if "rebind storm" in str(w.message)]
    assert len(storm) == 1, [str(w.message) for w in rec]
    assert eng.metrics()["plan_rebinds"] == REBIND_WARN_THRESHOLD + 3


def test_telemetry_histogram_matches_reference():
    """The port's Histogram gives the reference's quantiles and mean on the
    same samples (the reference module imports only the standard
    library)."""
    jtel = pytest.importorskip("repro.core.telemetry")
    rng = np.random.default_rng(1)
    samples = np.concatenate([rng.lognormal(-4, 1, 200), [0.0, 3e-7, 500.0]])
    got, want = telemetry.Histogram("t"), jtel.Histogram("t")
    assert got.quantile(0.5) == want.quantile(0.5) == 0.0
    for v in samples:
        got.observe(v)
        want.observe(v)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q), q
    assert got.mean == want.mean and got.count == want.count == 203


def test_engine_records_tick_spans_and_rebind_counter(model, cfg):
    """Enabled, the tracer holds one ``serve/tick`` span per tick with the
    active-slot count, and the tick sync's plan resolution, init and
    windows; disabled, it records nothing; the rebind counter is always
    live."""
    prompt = np.arange(5, dtype=np.int32) + 2
    telemetry.reset()
    try:
        telemetry.enable()
        eng = Engine(model, cfg, max_batch=2, max_len=32,
                     mesh=RankGrid(2, 4, device="cpu"))
        eng.run([Request(prompt=prompt.copy(), max_new_tokens=3)])
        ticks = [s for s in telemetry.spans() if s.name == "serve/tick"]
        assert len(ticks) == 2 and ticks[0].cat == "serve"
        assert dict(ticks[0].args) == {"active": 1}
        assert dict(ticks[1].args) == {"active": 0}
        assert all(s.duration > 0 for s in ticks)
        # the tick sync's own spans: its plan resolution, the op's init and
        # one start->wait window per tick
        names = [s.name for s in telemetry.spans()]
        assert names.count("plan_resolve/broadcast") == 1
        assert names.count("persistent_init/broadcast") == 1
        assert len([s for s in telemetry.spans() if s.cat == "comm"]) == 2
        recorded = len(telemetry.spans())
        telemetry.disable()
        eng.comm.selector.table.generation += 1
        eng.run([Request(prompt=prompt.copy(), max_new_tokens=3)])
        assert len(telemetry.spans()) == recorded
        assert telemetry.counter("serve.plan_rebinds").value == 1
        with telemetry.span("x"):
            pass
        assert len(telemetry.spans()) == recorded
    finally:
        telemetry.disable()
        telemetry.reset()


def test_engine_refuses_what_it_cannot_serve(model, cfg):
    with pytest.raises(ValueError, match="not in grid axes"):
        Engine(model, cfg, mesh=RankGrid(2, 4, device="cpu"),
               sync_axes="tp")
    with pytest.raises(ValueError, match="sync grid on meta"):
        Engine(model, cfg, mesh=RankGrid(2, 4, device="meta"))
    with pytest.raises(TypeError, match="greedy"):
        Engine(model, cfg, greedy=False)
    eng = Engine(model, cfg, max_batch=1, max_len=8)
    with pytest.raises(ValueError, match="does not fit"):
        eng.run([Request(prompt=np.arange(8, dtype=np.int32))])


def test_engine_takes_a_default_grid_beside_a_model_on_the_card(
        cfg, monkeypatch):
    """``RankGrid(2, 4)`` names the card as ``cuda`` while a model's
    tensors report ``cuda:0``: the engine holds them to one device. (The
    model is a stand-in reporting the card's device; nothing is
    allocated.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    class OnTheCard:
        device = torch.device("cuda", 0)

        def init_cache(self, batch, max_len):
            return []

    eng = Engine(OnTheCard(), cfg, mesh=RankGrid(2, 4))
    assert eng.comm.topo.world == 8
    with pytest.raises(ValueError, match="sync grid on cuda:1"):
        Engine(OnTheCard(), cfg, mesh=RankGrid(2, 4, device="cuda:1"))


@pytest.mark.cuda
def test_engine_on_the_card_with_default_devices(cfg):
    """The README's serving example at the reduced width: the model's
    default device, a generator on the card and the default grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    model = DecoderLM(cfg, torch.Generator("cuda").manual_seed(0))
    eng = Engine(model, cfg, max_batch=2, max_len=32, mesh=RankGrid(2, 4))
    done = eng.run([Request(prompt=np.arange(5, dtype=np.int32) + 2,
                            max_new_tokens=3)])
    assert model.device.type == "cuda" and len(done[0].out_tokens) == 3


@pytest.mark.parametrize("flash", [False, True])
def test_engine_matches_reference_engine(reference, cfg, flash):
    """Token for token against the reference ``Engine`` on the same
    weights, up to the bf16 guard of the module note."""
    tree = {}
    ml_dtypes = pytest.importorskip("ml_dtypes")
    for key, a in reference.items():
        if key.startswith("param/"):
            node = tree
            *parents, leaf = key.split("/")[1:]
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = a.astype(ml_dtypes.bfloat16)
    model = interop.params_from_reference(tree, cfg, device="cpu")
    eng = Engine(model, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 flags=RunFlags(use_flash_decode=flash))
    reqs = _requests()
    eng.run(reqs)
    same = 0
    for i, r in enumerate(reqs):
        want = reference[f"tokens{i}"].tolist()
        assert len(r.out_tokens) == len(want) == NEW
        diff = [j for j, (a, b) in enumerate(zip(r.out_tokens, want))
                if a != b]
        if not diff:
            same += 1
            continue
        margin, top = reference[f"margins{i}"][diff[0]]
        assert margin <= 2 * BF16_TOL * top, (
            f"request {i} token {diff[0]}: {r.out_tokens} vs {want}, "
            f"reference top-2 margin {margin} (max |logit| {top})")
    assert same >= len(reqs) - 1, f"only {same} requests agree"


if __name__ == "__main__":
    _reference(sys.argv[1])
