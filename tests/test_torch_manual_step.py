"""The port's data-parallel train steps (``train/manual_step.py``) on a
CPU ``RankGrid(2, 4)``, the reduced smollm config (2 layers, d_model 128,
vocab 512; the reduced rwkv6 and jamba for the family check), against the
reference's and against each other: the legs of the reference's
``tests/checks/manual_step_check.py`` and part 1 of its
``tests/checks/telemetry_check.py``.

The reference side (``tests/manual_step_reference.py``, once per module
in a subprocess with 8 forced host devices) runs ``make_manual_train_step``
with int8 error feedback on a (2, 4) mesh for three steps, and the
reference ``loss_fn`` of reduced rwkv6 and jamba on each rank's shard;
the weights are drawn from numpy (``torch_family.draw_params``) and its
programs compiled at XLA's lowest backend optimisation level
(``torch_family.fast_compile``).

Bars: the lossless fused step and both decompositions of the overlapped
one against ``train_step`` over 8 microbatches (the chip's legs (b) and
(c)): two steps' losses ``rtol=1e-5``, weights within 5e-2, and the first
step's gradient, read from AdamW's ``m``, within 1e-4 of each leaf's
largest |m|; bucketed
against per-tensor sync and every overlap twin: bitwise. The int8 EF
losses against the reference's: ``EF_RTOL`` (bf16 weights updated from
gradients that differ in rounding drift apart a little each step).
"""
import numpy as np
import pytest
import torch

import torch_family as tf
import manual_step_reference as msr
from manual_step_reference import (BUCKET, BUDGET, EF_STEPS, F32_LEAVES,
                                   FAMILIES, FAMILY_T, N, OPT, P, WORLD,
                                   _batch)
from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.core import comm as tcomm
from repro_torch.core import telemetry
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid
from repro_torch.models.decoder import RunFlags
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.train import manual_step as ms
from repro_torch.train.step import TrainConfig, train_step

#: the int8 EF step's losses against the reference's
EF_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its steps are many small
    operations over 8 ranks, and the suite runs files in parallel
    workers, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tf.reference_npz(msr.__file__, tmp_path_factory,
                            "manual_step_ref", devices=WORLD)


@pytest.fixture
def grid():
    return RankGrid(N, P, device="cpu")


def _ocfg():
    return adamw.AdamWConfig(**OPT)


def _tcfg(**kw):
    return TrainConfig(optimizer=_ocfg(), flags=RunFlags(remat="none"), **kw)


def _model(reference, arch="smollm-360m", dtype="bfloat16"):
    prefix = f"{arch}/param/"
    tree = tf.tree({"param/" + k[len(prefix):]: v
                    for k, v in reference.items() if k.startswith(prefix)},
                   dtype, F32_LEAVES)
    return interop.params_from_reference(tree, reduced_config(arch),
                                         device="cpu")


def _fresh(reference, arch="smollm-360m", dtype="bfloat16"):
    model = _model(reference, arch, dtype)
    flat = FlatParams.of(model)
    return model, flat, adamw.init(flat, _ocfg())


def _torch_batch(**kw):
    return {k: torch.from_numpy(v).long() for k, v in _batch(**kw).items()}


def _same(a, b):
    """Weights, m and v bitwise equal."""
    (fa, oa), (fb, ob) = a, b
    return (torch.equal(fa.read(), fb.read())
            and torch.equal(oa["m"], ob["m"]) and torch.equal(oa["v"],
                                                               ob["v"]))


def _two_steps(run, flat, opt):
    """Two steps of ``run() -> metrics``: both losses, and the weights and
    AdamW's first moment after the first step."""
    losses, first = [], None
    for _ in range(2):
        losses.append(float(run()["loss"]))
        if first is None:
            first = (flat.read(), opt["m"].clone())
    return losses, first


def _train_step_twice(reference, batch, microbatches):
    """``train_step`` over ``microbatches`` of ``batch``, two steps from
    the drawn weights, as :func:`_two_steps` gives them."""
    model, flat, opt = _fresh(reference)
    tcfg = _tcfg(microbatches=microbatches)
    return _two_steps(lambda: train_step(model, opt, batch, tcfg, flat),
                      flat, opt), flat.spans


def _matches(got, want, spans):
    """The chip's bars of leg (b): both steps' losses within ``rtol=1e-5``
    and the weights after the first within 5e-2; and the gradient the
    first step applied, read from AdamW's first moment ((1 - b1) times the
    clipped mean gradient), leaf by leaf within 1e-4 of the leaf's largest
    |m|. A weight moves about ``lr`` in the first step, so only ``m`` can
    tell a gradient routed to the wrong leaf or layer."""
    (got_l, (got_w, got_m)), (want_l, (want_w, want_m)) = got, want
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert float((got_w - want_w).abs().max()) < 5e-2
    for path, s, e, _ in spans:
        diff = float((got_m[s:e] - want_m[s:e]).abs().max())
        bound = 1e-4 * float(want_m[s:e].abs().max())
        assert diff <= bound, (path, diff, bound)


def test_fused_int8_ef_step_tracks_reference(reference, grid):
    """Three fused steps with int8 error feedback (``pip_mcoll``): the
    loss falls at every step and stays within ``EF_RTOL`` of the
    reference's; every rank's error state is non-zero."""
    model, flat, opt = _fresh(reference)
    step = ms.make_manual_train_step(
        model.cfg, _tcfg(), grid, algo="pip_mcoll", error_budget=BUDGET,
        codec="int8_block", bucket_bytes=BUCKET)
    err = ms.init_error_state(flat.n, Communicator(grid), BUDGET, BUCKET)
    assert len(err) == len(ms.bucket_slices(flat.n, BUCKET // 4)) > 1
    batch = _torch_batch()
    losses = []
    for _ in range(EF_STEPS):
        err2, mets = step(model, opt, err, batch)
        assert err2 is err or all(a is b for a, b in zip(err2, err))
        losses.append(float(mets["loss"]))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    np.testing.assert_allclose(losses, reference["ef/losses"], rtol=EF_RTOL)
    assert all(float(err[0][d].abs().max()) > 0 for d in range(WORLD))


def test_fused_lossless_step_matches_train_step(reference, grid):
    """The chip's leg (b) on the CPU: the lossless fused step
    (``algo="auto"``) against ``train_step`` over 8 microbatches of the
    global batch, two steps (:func:`_matches`)."""
    batch = _torch_batch()
    want, spans = _train_step_twice(reference, batch, WORLD)
    model, flat, opt = _fresh(reference)
    step = ms.make_manual_train_step(model.cfg, _tcfg(), grid)
    mets = []

    def run():
        err, got = step(model, opt, (), batch)
        assert err == ()
        mets.append(got)
        return got

    _matches(_two_steps(run, flat, opt), want, spans)
    assert set(mets[0]) == {"aux", "ce", "tokens", "grad_norm", "lr",
                            "loss"}


def test_bucketed_sync_is_bitwise_per_tensor_sync(reference, grid):
    batch = _torch_batch()
    runs = []
    for bucketed in (True, False):
        model, flat, opt = _fresh(reference)
        step = ms.make_manual_train_step(
            model.cfg, _tcfg(), grid, algo="pip_pipeline", bucketed=bucketed,
            bucket_bytes=BUCKET)
        _, mets = step(model, opt, (), batch)
        runs.append(((flat, opt), float(mets["loss"])))
    assert _same(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


@pytest.mark.parametrize("segmented", [True, False])
@pytest.mark.parametrize("ef", [False, True])
def test_overlap_twins_are_bitwise(reference, grid, segmented, ef):
    """``overlap=True`` and its barrier twin: weights, m, v and losses
    bitwise over two steps, both decompositions, lossless and int8 EF
    (every bucket a carry op, its state engaged)."""
    batch = _torch_batch()
    kw = (dict(algo="pip_mcoll", error_budget=BUDGET, codec="int8_block",
               bucket_bytes=64 << 10) if ef
          else dict(algo="pip_pipeline", bucket_bytes=BUCKET))
    runs = []
    for overlap in (True, False):
        model, flat, opt = _fresh(reference)
        step = ms.make_overlapped_train_step(
            model.cfg, _tcfg(), grid, overlap=overlap, segmented=segmented,
            **kw)
        losses = [float(step(model, opt, batch)["loss"]) for _ in range(2)]
        assert step.mode == ("segmented" if segmented else "monolithic")
        runs.append(((flat, opt), losses, step))
    assert _same(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    gs = runs[0][2].grad_sync
    assert len(gs.plans()) > 1
    if ef:
        assert all(op.carry for op in gs._ops), gs.plans()
        assert all(float(e.abs().max()) > 0 for e in gs.errs)
    if segmented:
        # one cycle a segment here: head, chunk 1, chunk 0, embed
        assert runs[0][2].bounds == [(0, 1), (1, 2)]
        assert len(gs.plans()) == 4


def test_segmented_matches_monolithic_and_train_step(reference, grid):
    """Both decompositions of the overlapped step against ``train_step``
    over 8 microbatches (:func:`_matches`): each segment's and the head's
    and embedding's buckets land on their own leaves and layers."""
    batch = _torch_batch()
    want, spans = _train_step_twice(reference, batch, WORLD)
    for seg in (True, False):
        model, flat, opt = _fresh(reference)
        step = ms.make_overlapped_train_step(
            model.cfg, _tcfg(), grid, algo="pip_pipeline",
            bucket_bytes=BUCKET, segmented=seg)
        _matches(_two_steps(lambda: step(model, opt, batch), flat, opt),
                 want, spans)
        assert step.mode == ("segmented" if seg else "monolithic")


def test_segmented_reasons(reference, grid):
    model, flat, opt = _fresh(reference)
    step = ms.make_overlapped_train_step(model.cfg, _tcfg(microbatches=2),
                                         grid, segmented=True)
    with pytest.raises(ValueError, match="microbatch"):
        step(model, opt, _torch_batch())
    auto = ms.make_overlapped_train_step(model.cfg, _tcfg(microbatches=2),
                                         grid)
    assert auto._segment_support(model, {"embeds": 1}) is not None
    assert auto._segment_support(model, {}) == \
        "microbatch gradient accumulation"


def test_budget_schedule_rebuilds_once_at_its_boundary(reference, grid):
    model, flat, opt = _fresh(reference)
    sched = lambda s: 0.0 if s < 2 else BUDGET
    step = ms.make_overlapped_train_step(
        model.cfg, _tcfg(), grid, algo="pip_mcoll", error_budget=sched,
        bucket_bytes=BUCKET)
    losses = []
    for i in range(4):
        losses.append(float(step(model, opt, _torch_batch())["loss"]))
        gs = step.grad_sync
        if i < 2:
            assert all(p == "pip_mcoll" for p in gs.plans()), gs.plans()
            assert gs.rebuilds == 0
        else:
            assert all(p == "pip_mcoll@int8_block" for p in gs.plans())
            assert gs.rebuilds == 1
    assert losses[-1] < losses[0]


def test_live_ops_flat_under_an_oscillating_schedule(grid):
    gs = ms.OverlappedGradSync(
        Communicator(grid), [(0, 65536), (65536, 65536)], metric_len=4,
        algo="pip_mcoll", error_budget=lambda s: BUDGET if s % 2 else 0.0)
    rng = np.random.default_rng(0)
    pay = [torch.from_numpy(rng.standard_normal((WORLD, n)).astype(
        np.float32)) for _, n in gs.slices]
    gs.ensure_ops(0)
    live0 = tcomm.live_persistent_ops()
    for s in range(8):
        gs.ensure_ops(s)
        assert tcomm.live_persistent_ops() == live0
        synced, _ = gs.sync(pay, torch.ones(WORLD, 4))
        assert all(torch.isfinite(y).all() for y in synced)
    assert gs.rebuilds == 7
    assert gs.plans() == ["pip_mcoll@int8_block"] * 2
    gs.release()


def test_traced_segmented_step_nests_its_spans(reference, grid):
    """Part 1 of the reference's telemetry check: one traced segmented
    step, every stage a span on the main track inside ``train/step``, each
    bucket's window on its own ``bucket:<i>`` track inside it; the trace
    exports."""
    model, flat, opt = _fresh(reference)
    step = ms.make_overlapped_train_step(
        model.cfg, _tcfg(), grid, algo="pip_pipeline", bucket_bytes=BUCKET,
        overlap=True, segmented=True)
    step(model, opt, _torch_batch())
    telemetry.enable()
    try:
        telemetry.reset()
        step(model, opt, _torch_batch())
        spans = telemetry.spans()
        trace = telemetry.export_chrome_trace()
    finally:
        telemetry.disable()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (outer,) = by_name["train/step"]
    assert dict(outer.args) == {"mode": "segmented", "overlap": True}
    stages = (["train/fwd", "train/head_bwd"]
              + [f"train/chunk_bwd[{k}]" for k in range(len(step.bounds))]
              + ["train/embed_bwd", "train/apply"])
    for name in stages:
        (s,) = by_name[name]
        assert s.track == "main"
        assert outer.start <= s.start and s.end <= outer.end + 1e-9, name
    buckets = [s for s in spans if s.track.startswith("bucket:")]
    assert sorted(s.track for s in buckets) == sorted(
        f"bucket:{i}" for i in range(len(step.grad_sync.plans())))
    for s in buckets:
        assert outer.start <= s.start and s.end <= outer.end + 1e-9
    assert any(e.get("name") == "train/step"
               for e in trace["traceEvents"])


def test_group_communicator_scopes_the_step(reference, grid):
    """A ``split(axes="local")`` child as ``topo``: the batch shards over
    the group's 4 ranks (each node the same shards) and gradients average
    over them: ``train_step`` over those 4 microbatches
    (:func:`_matches`)."""
    child = Communicator(grid).split(axes="local")
    batch = _torch_batch(n=P * 2)
    want, spans = _train_step_twice(reference, batch, P)
    model, flat, opt = _fresh(reference)
    step = ms.make_manual_train_step(model.cfg, _tcfg(), grid, child)
    _matches(_two_steps(lambda: step(model, opt, (), batch)[1], flat, opt),
             want, spans)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_step_matches_reference_loss(reference, grid, arch):
    """The step is family-agnostic: one fused lossless step of reduced
    rwkv6 and jamba (plain recurrences, kernel flags off; float32 weights
    and logits) gives the mean of the reference's per-rank losses within
    ``rtol=1e-5`` and a finite update."""
    model, flat, opt = _fresh(reference, arch, "float32")
    tcfg = TrainConfig(optimizer=_ocfg(), flags=RunFlags(
        remat="none", logits_dtype="float32"))
    step = ms.make_manual_train_step(model.cfg, tcfg, grid)
    before = flat.read()
    _, mets = step(model, opt, (), _torch_batch(n=WORLD, t=FAMILY_T))
    np.testing.assert_allclose(float(mets["loss"]),
                               float(reference[f"{arch}/losses"].mean()),
                               rtol=1e-5)
    after = flat.read()
    assert torch.isfinite(after).all() and not torch.equal(after, before)
