"""The program's spans as ``torch.profiler`` ranges (``core.telemetry``):
with telemetry off, a recording profiler sees the ranges that split the
train steps, the compressed allreduce's phases, the expert-parallel
all-to-alls and the blocking host reads, each where its work runs, in
order; nothing records, and ``span()`` is the shared no-op context, where
neither is on; results are bitwise the same with the ranges recorded or
not; and a ring-buffer span starts on the profiler's own clock.

Reduced smollm (2 layers, d_model 128, vocab 512) for the dense steps and
reduced qwen3-moe (2 layers, 8 experts top-2) for the expert-parallel
step, weights drawn on the CPU from a fixed generator, on CPU
``RankGrid``s of (2, 2).
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import reduced_config
from repro_torch.core import mcoll, telemetry
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid
from repro_torch.core.topology import Topology
from repro_torch.models.decoder import DecoderLM, RunFlags
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.sharding.rules import Rules
from repro_torch.train import manual_step as ms
from repro_torch.train.step import TrainConfig, train_step

#: the prefixes of the program's range names
PREFIXES = ("train/", "sync/", "allreduce/", "persistent/", "moe/",
            "host_read/")
PHASES = ("allreduce/intra_reduce_scatter", "allreduce/wire_reduce_scatter",
          "allreduce/wire_allgather", "allreduce/intra_allgather",
          "allreduce/residual")
BUDGET = 0.5 / 127
OPT = adamw.AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=0)
TCFG = TrainConfig(optimizer=OPT, flags=RunFlags(remat="none"))


@pytest.fixture(autouse=True)
def _telemetry_off():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _recorded(fn):
    """``fn()`` under a CPU profiler: (its result, every recorded event as
    ``(name, start_ns, end_ns)`` sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    return out, sorted(evs, key=lambda e: (e[1], -e[2]))


def _profiling():
    return torch.autograd.profiler._is_profiler_enabled


def _program(evs):
    return [e for e in evs if e[0].startswith(PREFIXES)]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _model(arch, seed=0):
    cfg = reduced_config(arch)
    model = DecoderLM(cfg, torch.Generator().manual_seed(seed), device="cpu")
    model.trainable()
    return model, FlatParams.of(model)


def _batch(B, T, vocab=512, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, vocab, (B, T + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _fused(bucket_bytes=64 << 10):
    grid = RankGrid(2, 2, device="cpu")
    model, flat = _model("smollm-360m")
    fn = ms.make_manual_train_step(model.cfg, TCFG, grid, algo="pip_mcoll",
                                   error_budget=BUDGET,
                                   bucket_bytes=bucket_bytes)
    errs = ms.init_error_state(flat.n, Communicator(grid), BUDGET,
                               bucket_bytes)
    opt = adamw.init(flat, OPT)
    return model, flat, opt, errs, fn, grid


def test_fused_step_splits_into_fwd_bwd_sync_and_optimizer():
    model, flat, opt, errs, fn, grid = _fused()
    n_buckets = len(ms.bucket_slices(flat.n, (64 << 10) // 4))
    _, evs = _recorded(lambda: fn(model, opt, errs, _batch(4, 16)))
    prog = _program(evs)
    names = [n for n, _, _ in prog]
    fb = [e for e in prog if e[0] == "train/fwd_bwd"]
    (gs,) = [e for e in prog if e[0] == "train/grad_sync"]
    (op,) = [e for e in prog if e[0] == "train/optimizer"]
    assert len(fb) == grid.rows  # once per held rank
    assert all(e[2] <= gs[1] for e in fb)  # every backward, then the sync
    assert gs[2] <= op[1]  # then the optimizer
    buckets = [e for e in prog if e[0] == "sync/bucket"]
    assert len(buckets) == n_buckets
    assert all(_inside(b, gs) for b in buckets)
    for p in PHASES:  # each bucket's allreduce, phase by phase
        hits = [e for e in prog if e[0] == p]
        assert len(hits) == n_buckets
        assert all(any(_inside(h, b) for b in buckets) for h in hits)
    metric = [e for e in prog if e[0] == "train/metric_sync"]
    assert len(metric) == 2 and metric[0][2] <= op[1] <= op[2] <= metric[1][1]
    # the held ranks' shard indices are read to the host once a step
    assert names.count("host_read/train_shard_index") == 1
    assert names[0] == "host_read/train_shard_index"


def test_train_step_records_fwd_bwd_then_optimizer():
    model, flat = _model("smollm-360m")
    opt = adamw.init(flat, OPT)
    _, evs = _recorded(lambda: train_step(model, opt, _batch(2, 16), TCFG,
                                          flat))
    prog = [e for e in _program(evs) if e[0].startswith("train/")]
    assert [n for n, _, _ in prog] == ["train/fwd_bwd", "train/optimizer"]
    assert prog[0][2] <= prog[1][1]


def test_compressed_allreduce_records_its_five_phases_in_order():
    grid = RankGrid(2, 2, device="cpu")
    topo = Topology.from_grid(grid)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 3000), generator=g) * 1e-2
    err = torch.randn((4, 3000), generator=g) * 1e-4

    def run():
        return mcoll.pip_mcoll_allreduce(x, topo, grid, codec="int8_block",
                                         err=err)
    (out, new_err), evs = _recorded(run)
    prog = [e for e in _program(evs) if e[0].startswith("allreduce/")]
    assert [n for n, _, _ in prog] == list(PHASES)
    assert all(a[2] <= b[1] for a, b in zip(prog, prog[1:]))
    # the same call unrecorded: bitwise the same result and carry
    out2, err2 = run()
    assert torch.equal(out, out2) and torch.equal(new_err, err2)


def test_expert_parallel_step_records_alltoalls_and_group_size_reads():
    model, flat = _model("qwen3-moe-235b-a22b")
    layers = model.cfg.n_layers
    opt = adamw.init(flat, OPT)
    grid = RankGrid(2, 2, device="cpu")
    rules = Rules(batch=("node",), tp="local")
    before = telemetry.counter("host_reads.moe_group_sizes").value
    _, evs = _recorded(lambda: train_step(model, opt, _batch(4, 32), TCFG,
                                          flat, rules=rules, grid=grid))
    a2a = [e for e in evs if e[0] == "moe/alltoall"]
    backward = [e for e in evs if e[0] == "_AllToAllBackward"]
    # forward: three dispatches and the combine a layer; backward: the
    # tokens' dispatch and the combine, each inside autograd's node
    assert len(a2a) == 6 * layers and len(backward) == 2 * layers
    inside = [a for a in a2a if any(_inside(a, b) for b in backward)]
    assert len(inside) == 2 * layers
    reads = [e for e in evs if e[0] == "host_read/moe_group_sizes"]
    assert len(reads) == layers  # one a call
    assert telemetry.counter("host_reads.moe_group_sizes").value == \
        before + layers
    (fb,) = [e for e in evs if e[0] == "train/fwd_bwd"]
    assert all(_inside(e, fb) for e in a2a + reads)


def test_no_profiler_and_telemetry_off_records_nothing():
    assert not telemetry.enabled() and not _profiling()
    ctx = telemetry.span("train/fwd_bwd", cat="train")
    assert ctx is telemetry.span("allreduce/residual")  # the shared no-op
    n = telemetry.counter("host_reads.x").value
    assert telemetry.host_read("x") is ctx
    assert telemetry.counter("host_reads.x").value == n + 1
    with ctx:
        pass
    assert telemetry.spans() == []


def test_a_recording_profiler_alone_gets_ranges_and_no_ring_buffer():
    def run():
        assert _profiling()
        ctx = telemetry.span("sync/bucket")
        assert ctx is not telemetry.span("sync/bucket")
        with ctx:
            torch.ones(4).sum()
        tok = telemetry.begin("bucket0[x]", track="bucket:0")
        telemetry.end(tok)
    _, evs = _recorded(run)
    assert [n for n, _, _ in _program(evs)] == ["sync/bucket"]
    assert not any(n.startswith("bucket0") for n, _, _ in evs)
    assert telemetry.spans() == [] and not _profiling()


def test_fused_step_bitwise_the_same_recorded_or_not():
    runs = []
    for recorded in (False, True):
        model, flat, opt, errs, fn, _ = _fused()
        step = lambda: fn(model, opt, errs, _batch(4, 16))  # noqa: E731
        errs, metrics = _recorded(step)[0] if recorded else step()
        runs.append((flat.read(), opt["m"].clone(), [e.clone() for e in errs],
                     {k: v.clone() for k, v in metrics.items()}))
    (w0, m0, e0, k0), (w1, m1, e1, k1) = runs
    assert torch.equal(w0, w1) and torch.equal(m0, m1)
    assert all(torch.equal(a, b) for a, b in zip(e0, e1))
    assert all(torch.equal(k0[k], k1[k]) for k in k0)


def test_span_starts_on_the_profilers_clock():
    telemetry.enable()

    def run():
        with telemetry.span("train/optimizer", cat="train"):
            torch.ones(8).sum()
    _, evs = _recorded(run)
    (rng,) = [e for e in evs if e[0] == "train/optimizer"]
    (sp,) = telemetry.spans()
    assert abs(sp.start_ns - rng[1]) < 1_000_000  # within 1 ms
    assert sp.start_ns <= rng[2] and sp.duration_ns <= rng[2] - rng[1] \
        + 1_000_000
    trace = telemetry.export_chrome_trace()
    assert trace["otherData"]["epoch_ns"] == sp.start_ns


def test_deferred_observations_wait_for_their_values():
    """The error-feedback probe's values come back behind an event: a
    sample records the observations whose values have landed, in order,
    and waits for none; ``snapshot()`` records the rest."""
    telemetry.enable()
    landed, seen = [False], []

    def observe(tag):
        def record(block):
            if not (landed[0] or block):
                return False
            seen.append((tag, block))
            return True
        return record
    telemetry.defer(observe("a"))
    telemetry.defer(observe("b"))
    assert telemetry.should_sample("k", every=1) and seen == []
    landed[0] = True
    assert not telemetry.should_sample("k", every=2)  # no sample: no record
    assert seen == []
    assert telemetry.should_sample("k", every=2)
    assert seen == [("a", False), ("b", False)]
    landed[0] = False
    telemetry.defer(observe("c"))
    telemetry.snapshot()
    assert seen[-1] == ("c", True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch's sync debug mode reports "
                    "CUDA synchronizations only")
    return torch.device("cuda")


def _syncs_and_reads(step):
    """One call of ``step`` under a profiler and torch's sync debug mode:
    (the synchronizing calls it reports, the ``host_read/*`` ranges)."""
    import warnings

    def run():
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, evs = _recorded(run)
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    return syncs, sum(e[0].startswith("host_read/") for e in evs)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
def test_every_synchronizing_call_is_a_host_read_on_the_card(cuda, arch):
    cfg = reduced_config(arch)
    model = DecoderLM(cfg, torch.Generator(cuda).manual_seed(0), device=cuda)
    model.trainable()
    flat = FlatParams.of(model)
    opt = adamw.init(flat, OPT)
    grid = RankGrid(2, 2, device=cuda)
    batch = {k: v.to(cuda) for k, v in _batch(4, 32).items()}
    if cfg.moe is None:
        bucket = 64 << 10
        fn = ms.make_manual_train_step(cfg, TCFG, grid, algo="pip_mcoll",
                                       error_budget=BUDGET,
                                       bucket_bytes=bucket)
        errs = ms.init_error_state(flat.n, Communicator(grid), BUDGET,
                                   bucket)
        step = lambda: fn(model, opt, errs, batch)  # noqa: E731
    else:
        rules = Rules(batch=("node",), tp="local")
        step = lambda: train_step(model, opt, batch, TCFG, flat,  # noqa
                                  rules=rules, grid=grid)
    step()  # plans resolved, kernels built
    torch.cuda.synchronize()
    syncs, reads = _syncs_and_reads(step)
    assert syncs == reads and reads > 0
