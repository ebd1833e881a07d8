"""Helpers shared by the port's model-family parity tests
(``test_torch_rwkv.py``, ``test_torch_jamba.py``, the train tests): the
reference side run in a subprocess, its serving recorder, its weights
drawn from numpy and its quick compiles, the parameter tree read back
from its ``.npz``, and the comparisons. Imports no torch at module level,
so a reference subprocess that imports it does not pay for torch."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest


def reference_npz(test_file: str, tmp_path_factory, name: str,
                  devices: int = 0) -> dict:
    """Run ``test_file``'s ``__main__`` (the reference side) in a
    subprocess on the CPU (with ``devices`` forced host devices when
    given) and load the ``.npz`` it writes."""
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp(name) / "ref.npz"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    if devices:
        env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={devices}"
    proc = subprocess.run([sys.executable, test_file, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def flatten(tree, prefix: str = ""):
    """``(path, array)`` leaves of a nested dict in sorted key order (the
    reference's flatten order), paths joined by ``/``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, np.asarray(tree))]


def draw_params(shapes) -> dict:
    """A parameter tree of ``shapes`` (the reference's ``jax.eval_shape``
    of its ``init``) drawn from numpy seed 0, leaf by leaf in sorted key
    order, in ``ml_dtypes`` bfloat16: the norms' scales near 1, the rest
    small. Cheaper than compiling the reference's ``init``."""
    import ml_dtypes
    rng = np.random.default_rng(0)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(tree[k], k) for k in sorted(tree)}
        a = rng.standard_normal(tree.shape)
        a = 1.0 + 0.1 * a if name == "scale" else 0.05 * a
        return a.astype(ml_dtypes.bfloat16)
    return draw(shapes)


def fast_compile(fn, *args):
    """``fn`` (jitted, or a function to jit) compiled for ``args`` at XLA's
    lowest backend optimisation level: a few times quicker to compile on
    one core. Not for bitwise codec oracles: at that level XLA fuses no
    multiply-adds."""
    import jax
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})


def top2(row):
    """(top-2 margin, max |logit|) of one row of logits."""
    row = np.asarray(row, np.float32)
    a, b = np.sort(row)[-2:]
    return b - a, np.abs(row).max()


def ref_serve(params, cfg, prompts, max_batch, max_len, new):
    """Tokens and per-token (top-2 margin, max|logit|) of the reference
    ``Engine`` serving ``prompts`` in order."""
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import Request as JRequest

    eng = JEngine(params, cfg, max_batch=max_batch, max_len=max_len)
    margins = {}
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
    reqs = [JRequest(prompt=p, max_new_tokens=new) for p in prompts]
    eng.run(reqs)
    return [(np.array(r.out_tokens, np.int64),
             np.array(margins[id(r)], np.float64)) for r in reqs]


def tree(reference: dict, dtype: str, f32_leaves) -> dict:
    """The reference parameter tree from the ``.npz`` (its ``param/...``
    entries): float32, or the reference's own dtypes (``ml_dtypes``
    bfloat16, except the leaves named in ``f32_leaves``)."""
    out = {}
    ml_dtypes = pytest.importorskip("ml_dtypes") if dtype == "bfloat16" \
        else None
    for key, a in reference.items():
        if not key.startswith("param/"):
            continue
        node = out
        *parents, leaf = key.split("/")[1:]
        for p in parents:
            node = node.setdefault(p, {})
        keep_f32 = dtype == "float32" or leaf in f32_leaves
        node[leaf] = a.astype(np.float32 if keep_f32 else ml_dtypes.bfloat16)
    return out


def close(got, want, tol, what):
    import torch
    got = got.float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def relative(got, want, tol, what):
    """``got`` within ``tol`` times the largest ``|want|``."""
    err = float(np.abs(got.float().numpy() - want).max())
    bound = tol * float(np.abs(want).max())
    assert err <= bound, f"{what}: max error {err} > {bound}"


def guard(got, want, margins, tol, what):
    """``got`` equals ``want`` or first differs where the reference's top-2
    margin is within ``2 * tol`` of the largest logit; returns whether
    they are equal."""
    diff = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
    if diff:
        margin, top = margins[diff[0]]
        assert margin <= 2 * tol * top, (
            f"{what} token {diff[0]}: {got} vs {want}, reference top-2 "
            f"margin {margin} (max |logit| {top})")
    return not diff
