"""Checkpoints (``checkpoint/manager.py``) and the training driver
(``python -m repro_torch.launch.train``): ``tests/test_checkpoint.py``'s
cases on the port; the on-disk format read both ways against the
reference's ``CheckpointManager`` (in this process), bf16 and float8
included, and a reference train-state checkpoint restored into a port
model; failure injection and an exact resume of the driver on the CPU.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import (CheckpointManager,
                                            load_train_state, train_state)
from repro_torch.configs import reduced_config
from repro_torch.models.decoder import DecoderLM
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers,
    where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)},
            "step": torch.tensor(7, dtype=torch.int32)}
    mgr.save(5, tree)
    like = {"a": {"w": torch.zeros(2, 3, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    out = mgr.restore(5, like)
    assert torch.equal(out["a"]["w"], tree["a"]["w"])
    assert out["a"]["w"].dtype == torch.bfloat16
    assert int(out["step"]) == 7 and out["step"].dtype == torch.int32
    assert mgr.latest_step() == 5


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_atomic_commit_no_partial(tmp_path):
    """A .tmp dir left behind must never be picked up as a checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / ".tmp_step_000000009").mkdir()
    assert mgr.latest_step() is None
    mgr.save(3, {"w": torch.ones(2)})
    assert mgr.latest_step() == 3


def test_async_save_copies_at_call_time_and_wait(tmp_path):
    """An async save writes the values of its call, though the tensor
    changes right after; ``wait`` joins it; a missing leaf raises."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(1 << 16, dtype=torch.float32)
    mgr.save(1, {"w": w}, blocking=False)
    w.add_(1.0)
    mgr.save(2, {"w": w}, blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    out = mgr.restore(1, {"w": torch.zeros_like(w)})
    assert torch.equal(out["w"], w - 1.0)
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(2, {"u": torch.zeros(1)})


def test_restore_onto_an_explicit_device(tmp_path):
    """The elastic path: ``shardings`` names each leaf's target device
    (the like tree's is the meta device here); the same bytes land there.
    A Python number comes back as one."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
            "n": 3}
    mgr.save(1, tree)
    like = {"w": torch.empty(4, 4, device="meta"), "n": 0}
    out = mgr.restore(1, like, shardings={"w": "cpu", "n": None})
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["w"], tree["w"]) and out["n"] == 3


def _fp8_bits():
    return np.arange(256, dtype=np.uint8).reshape(16, 16)


def test_reads_the_references_checkpoints_bitwise(tmp_path):
    """A tree the reference's manager writes (bf16, float8 e4m3, float32,
    an int32 step) comes back bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    import ml_dtypes
    from repro.checkpoint.manager import CheckpointManager as JManager
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    f8 = _fp8_bits().view(ml_dtypes.float8_e4m3fn)
    f32 = rng.standard_normal((7,)).astype(np.float32)
    JManager(str(tmp_path)).save(4, {
        "params": {"w": jnp.asarray(bf), "f8": jnp.asarray(f8)},
        "opt": {"m": jnp.asarray(f32), "step": jnp.int32(9)}})
    like = {"params": {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                       "f8": torch.zeros(16, 16,
                                         dtype=torch.float8_e4m3fn)},
            "opt": {"m": torch.zeros(7), "step": torch.tensor(0, dtype=torch
                                                              .int32)}}
    out = CheckpointManager(str(tmp_path)).restore(4, like)
    assert np.array_equal(out["params"]["w"].view(torch.uint16).numpy(),
                          bf.view(np.uint16))
    assert np.array_equal(out["params"]["f8"].view(torch.uint8).numpy(),
                          _fp8_bits())
    assert np.array_equal(out["opt"]["m"].numpy(), f32)
    assert int(out["opt"]["step"]) == 9


def test_writes_checkpoints_the_reference_reads_bitwise(tmp_path):
    jax = pytest.importorskip("jax")
    import ml_dtypes
    from repro.checkpoint.manager import CheckpointManager as JManager
    g = torch.Generator().manual_seed(0)
    bf = torch.randn(3, 5, generator=g).bfloat16()
    f8 = torch.from_numpy(_fp8_bits()).view(torch.float8_e4m3fn)
    f32 = torch.randn(7, generator=g)
    CheckpointManager(str(tmp_path)).save(4, {
        "params": {"w": bf, "f8": f8},
        "opt": {"m": f32, "step": torch.tensor(9, dtype=torch.int32)}})
    jnp = jax.numpy
    like = {"params": {"w": jnp.zeros((3, 5), jnp.bfloat16),
                       "f8": jnp.zeros((16, 16), ml_dtypes.float8_e4m3fn)},
            "opt": {"m": jnp.zeros(7, jnp.float32), "step": jnp.int32(0)}}
    out = JManager(str(tmp_path)).restore(4, like)
    assert np.array_equal(np.asarray(out["params"]["w"]).view(np.uint16),
                          bf.view(torch.uint16).numpy())
    assert np.array_equal(np.asarray(out["params"]["f8"]).view(np.uint8),
                          _fp8_bits())
    assert np.array_equal(np.asarray(out["opt"]["m"]), f32.numpy())
    assert int(out["opt"]["step"]) == 9


def test_train_state_restores_a_reference_train_checkpoint(tmp_path):
    """The reference's ``{"params", "opt"}`` train state of reduced smollm
    (drawn bf16 weights, float32 ``m``/``v`` filled with seeded values,
    its step) restored into a port model and its AdamW state: the weights
    and the state bit for bit; saved back by the port, the reference reads
    the same bytes."""
    jax = pytest.importorskip("jax")
    import torch_family as tf
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.configs import reduced_config as jreduced
    from repro.models import decoder as jdecoder
    cfg = jreduced("smollm-360m")
    params = tf.draw_params(jax.eval_shape(
        lambda k: jdecoder.init(k, cfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    fill = lambda t: {k: fill(v) for k, v in t.items()} \
        if isinstance(t, dict) else rng.standard_normal(t.shape).astype(
            np.float32)
    jstate = {"params": params,
              "opt": {"step": np.int32(3), "m": fill(params),
                      "v": fill(params)}}
    JManager(str(tmp_path / "ref")).save(3, jstate)
    model = DecoderLM(reduced_config("smollm-360m"), device="cpu")
    flat = FlatParams.of(model)
    opt = adamw.init(flat, adamw.AdamWConfig())
    mgr = CheckpointManager(str(tmp_path / "ref"))
    load_train_state(flat, opt, mgr.restore(3, train_state(flat, opt)))
    assert opt["step"] == 3
    weights, m = flat.weights(), flat.tree(opt["m"])
    for path, a in tf.flatten(params):
        assert np.array_equal(weights[path].view(torch.uint16).numpy(),
                              a.view(np.uint16)), path
    for path, a in tf.flatten(jstate["opt"]["m"]):
        assert np.array_equal(m[path].numpy(), a), path
    CheckpointManager(str(tmp_path / "port")).save(
        3, train_state(flat, opt))
    back = JManager(str(tmp_path / "port")).restore(3, jstate)
    for (p, a), (_, b) in zip(tf.flatten(back), tf.flatten(jstate)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), p


def _run_train(args):
    # one intra-op thread a run, as in this process
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = f"{REPO / 'src'}:{env.get('PYTHONPATH', '')}"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         *args], capture_output=True, text=True, env=env, timeout=600,
        check=False)


def test_failure_injection_and_exact_resume(tmp_path):
    """Kill training at step 7, resume from the step-5 checkpoint, and the
    final losses must be bitwise-identical to an uninterrupted run
    (deterministic data + state restore); the reference test's
    arguments."""
    common = ["--arch", "smollm-360m", "--reduced", "--steps", "12",
              "--batch", "2", "--seq", "32", "--ckpt-every", "5",
              "--log-every", "1", "--lr", "1e-3", "--ckpt-blocking"]
    ref = _run_train(common + ["--ckpt-dir", str(tmp_path / "ref")])
    assert ref.returncode == 0, ref.stdout + ref.stderr
    crash = _run_train(common + ["--ckpt-dir", str(tmp_path / "ft"),
                                 "--die-at-step", "7"])
    assert crash.returncode == 42, crash.stdout + crash.stderr
    assert "injected failure" in crash.stdout
    resumed = _run_train(common + ["--ckpt-dir", str(tmp_path / "ft")])
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert "resumed from step 5" in resumed.stdout

    def losses(out):
        return {int(line.split()[2]): line.split()[4]
                for line in out.splitlines()
                if line.startswith("[train] step")}
    ref_l = losses(ref.stdout)
    res_l = losses(resumed.stdout)
    assert sorted(res_l) == list(range(5, 12))
    for step in (10, 11):
        assert ref_l[step] == res_l[step], (step, ref_l, res_l)
    assert "[train] done." in resumed.stdout
