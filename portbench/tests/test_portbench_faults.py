"""The correctness check has to fail: the controls (the reference one
precision down in the program's place) and a run with the timed path
broken underneath, once for each fault a cell can have. The harness's
look for a card is skipped; everything else of a run is driven, at the
tests' small size on the CPU, against each cell's own limits."""
import pytest
import torch

from portbench import control, harness

from conftest import small_config, small_traffic
from small import run_small

SEED = 2 ** 31 + 41
SYNC = "smollm360m.gradsync.int8ef.b128m"
TRAIN = ["qwen3moe.l1.ep.train.s512", "smollm360m.train.int8ef.b4m"]


def _caught(checks, sound):
    """Whether some compared number is over its limit and at least three
    times what a sound run at the same size reads (the cells' limits are
    set at their own sizes on the card; at the tests' size a sound run
    may read above them, so the fault has to stand out from it too)."""
    return any(c["value"] > c["limit"] and
               c["value"] > 3 * sound["checks"][k]["value"]
               for k, c in checks.items())


@pytest.mark.parametrize("name", [SYNC] + TRAIN)
def test_the_control_fails(name):
    bench = harness.benchmark()
    cell = harness.workload(bench, name)
    tr = small_traffic(harness.load_json("traffic", cell["traffic"]))
    rec = control.run(name, SEED, "cpu", bench=bench,
                      config=small_config(cell["config"]), traffic=tr)
    assert rec["control_failed"], rec
    assert _caught(rec["checks"], run_small(name, SEED)), rec


# -- faults planted in the gradient sync ----------------------------------------

def _wrap_sync(change):
    """A fault hook that puts ``change(gs, buckets, mvec, sync)`` in place
    of the program's ``OverlappedGradSync.sync``."""
    def fault(st, ctx):
        gs, sync = st.gs, st.gs.sync
        gs.sync = lambda buckets, mvec, overlap=True: change(
            gs, buckets, mvec, sync)
    return fault


def _state_unchanged(gs, buckets, mvec, sync):
    before = [None if e is None else e.clone() for e in gs.errs]
    out = sync(buckets, mvec)
    for e, b in zip(gs.errs, before):
        if e is not None:
            e.copy_(b)
    return out


def _half_the_ranks(gs, buckets, mvec, sync):
    half = buckets[0].shape[0] // 2
    return sync([torch.cat([b[:half], b[:half]]) for b in buckets], mvec)


def _no_exchange(gs, buckets, mvec, sync):
    synced, m = sync(buckets, mvec)
    world = buckets[0].shape[0]
    return [b * world for b in buckets], m


def _altered(gs, buckets, mvec, sync):
    synced, m = sync(buckets, mvec)
    y = synced[-1]
    y[0, 0] += 0.5 * float(y.abs().max())
    return synced, m


SYNC_FAULTS = {"state_unchanged": _state_unchanged,
               "half_the_batch": _half_the_ranks,
               "no_exchange": _no_exchange, "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(SYNC_FAULTS))
def test_a_broken_sync_is_not_correct(fault):
    sound = run_small(SYNC, SEED)
    broken = run_small(SYNC, SEED,
                       hooks={"fault": _wrap_sync(SYNC_FAULTS[fault])})
    assert not broken["correct"], broken["checks"]
    assert _caught(broken["checks"], sound), broken["checks"]


# -- faults planted in the train steps -------------------------------------------

def _train_fault(kind):
    def fault(st, ctx):
        from repro_torch.core import mcoll
        from repro_torch.optim import adamw
        run = st.run
        if kind == "state_unchanged":
            def frozen(params, grads, state, cfg):
                return {"grad_norm": grads.norm(),
                        "lr": torch.tensor(cfg.lr)}
            ctx.restore.append((adamw, "update", adamw.update))
            adamw.update = frozen
        elif kind == "half_the_batch":
            def half(batch):
                B = batch["tokens"].shape[0] // 2
                return run({k: torch.cat([v[:B], v[:B]])
                            for k, v in batch.items()})
            st.run = half
        elif kind == "no_exchange":
            for table in (mcoll.ALLTOALL, mcoll.ALLREDUCE):
                ctx.restore.append((table, None, dict(table)))
                for k in table:
                    table[k] = _identity
        elif kind == "answer_altered":
            def altered(batch):
                m = dict(run(batch))
                m["loss"] = m["loss"] * 1.01
                return m
            st.run = altered
    return fault


def _identity(x, topo, grid, err=None, **kw):
    return x if err is None else (x, err)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "no_exchange", "answer_altered"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_train_step_is_not_correct(name, fault):
    restore = []
    hook = _train_fault(fault)

    def planted(st, ctx):
        ctx.restore = restore
        hook(st, ctx)
    sound = run_small(name, SEED)
    try:
        broken = run_small(name, SEED, hooks={"fault": planted})
    finally:
        for obj, attr, old in restore:
            if attr is None:
                obj.clear()
                obj.update(old)
            else:
                setattr(obj, attr, old)
    assert not broken["correct"], broken["checks"]
    assert _caught(broken["checks"], sound), broken["checks"]
