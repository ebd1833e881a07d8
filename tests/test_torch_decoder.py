"""The port's dense decoder against the reference's, on the reduced smollm
config (2 layers, d_model 128, 4 heads, 2 KV heads, head_dim 32, vocab
512).

The reference side — this file's ``__main__``, run once per module in a
subprocess — initialises ``repro.models.decoder`` from ``PRNGKey(0)``,
runs a prefill and three decode steps on numpy tokens, and writes the
parameters and every logit to an ``.npz``; the port receives the same
parameters through ``interop.params_from_reference``. Cases: float32
(parameters and caches cast in both packages; ``F32_TOL``, the order of
fp32 sums) and bfloat16 (the reference's own dtypes; ``BF16_TOL`` times
the largest logit, a few bf16 roundings of the residual stream apart),
each at a scalar and at a ``(B,)`` ``cache_index``; ``use_flash_decode``
with a scalar index, where the reference reaches its Pallas kernel in
interpret mode; and ``attend_streaming`` forward at T=64 with 16-wide
chunks.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import (ARCH_IDS, MoEConfig, get_config,
                                 reduced_config)
from repro_torch.layers import attention
from repro_torch.models import params as tparams
from repro_torch.models.decoder import DecoderLM, RunFlags

B, T, MAX_LEN, STEPS = 2, 8, 64, 3
#: (B,) decode offsets: row 1 decodes over positions its prefill wrote
#: beyond, which its mask must hide
VEC_START = np.array([T, 5], np.int32)
#: float32 logits: sum order only
F32_TOL = 1e-4
#: bfloat16 logits: relative to the step's largest |logit| (2**-6, four
#: bf16 ulps of the largest value)
BF16_TOL = 2.0 ** -6
#: attend_streaming forward
STREAM = dict(B=2, T=64, H=4, KV=2, hd=32, chunk=16)


def _tokens(step):
    rng = np.random.default_rng(10 + step)
    return rng.integers(0, 512, size=(B, T if step < 0 else 1),
                        dtype=np.int32)


def _stream_inputs():
    rng = np.random.default_rng(5)
    s = STREAM
    return (rng.standard_normal((s["B"], s["T"], s["H"], s["hd"])),
            rng.standard_normal((s["B"], s["T"], s["KV"], s["hd"])),
            rng.standard_normal((s["B"], s["T"], s["KV"], s["hd"])))


def _cases():
    """(name, dtype, index kind, use_flash_decode)."""
    out = [(f"{dt}_{kind}", dt, kind, False)
           for dt in ("float32", "bfloat16") for kind in ("scalar", "vector")]
    out += [(f"{dt}_flash", dt, "scalar", True)
            for dt in ("float32", "bfloat16")]
    return out


def _index(kind, step):
    return T + step if kind == "scalar" else VEC_START + step


def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.layers import attention as jattn
    from repro.models import decoder

    cfg = jreduced("smollm-360m")
    params = decoder.init(jax.random.PRNGKey(0), cfg)
    res = {f"param/{'/'.join(str(k.key) for k in path)}":
           np.asarray(leaf, np.float32)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    for name, dt, kind, flash in _cases():
        dtype = getattr(jnp, dt)
        p = jax.tree.map(lambda a: a.astype(dtype), params)
        caches = jax.tree.map(lambda a: a.astype(dtype),
                              decoder.init_cache(cfg, B, MAX_LEN))
        flags = decoder.RunFlags(use_flash_decode=flash, logits_dtype=dt)
        logits, _, caches = decoder.forward(p, jnp.asarray(_tokens(-1)), cfg,
                                            flags=flags, caches=caches)
        res[f"{name}/prefill"] = np.asarray(logits.astype(jnp.float32))
        for step in range(STEPS):
            idx = _index(kind, step)
            idx = jnp.int32(idx) if kind == "scalar" else jnp.asarray(idx)
            logits, _, caches = decoder.forward(
                p, jnp.asarray(_tokens(step)), cfg, flags=flags,
                caches=caches, cache_index=idx)
            res[f"{name}/step{step}"] = np.asarray(
                logits.astype(jnp.float32))
    s = STREAM
    for dt in ("float32", "bfloat16"):
        q, k, v = (jnp.asarray(a, getattr(jnp, dt)) for a in _stream_inputs())
        res[f"stream/{dt}"] = np.asarray(jattn.attend_streaming(
            q, k, v, True, s["chunk"], s["chunk"]))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("decoder_ref") / "ref.npz"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def _tree(reference, dtype):
    """The reference parameter tree from the ``.npz``, in ``dtype`` (a
    bfloat16 tree holds ``ml_dtypes`` arrays, as ``jax.device_get`` gives
    them)."""
    if dtype == "bfloat16":
        ml_dtypes = pytest.importorskip("ml_dtypes")
        cast = ml_dtypes.bfloat16
    else:
        cast = np.float32
    tree = {}
    for key, a in reference.items():
        if not key.startswith("param/"):
            continue
        node = tree
        *parents, leaf = key.split("/")[1:]
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a.astype(cast)
    return tree


def _model(reference, dtype):
    return interop.params_from_reference(_tree(reference, dtype),
                                         reduced_config("smollm-360m"),
                                         device="cpu")


def _assert_logits(got, want, dtype, what):
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
    else:
        err = float(np.abs(got - want).max())
        bound = BF16_TOL * float(np.abs(want).max())
        assert err <= bound, f"{what}: max error {err} > {bound}"


def test_params_from_reference_unstacks_cycles(reference):
    cfg = reduced_config("smollm-360m")
    model = _model(reference, "float32")
    assert sum(p.numel() for p in model.parameters()) \
        == tparams.n_params(cfg) == cfg.n_params()
    wq = reference["param/groups/blk0/attn/wq"]
    for layer in range(cfg.n_layers):
        assert torch.equal(model.blocks[layer].attn.wq,
                           torch.from_numpy(wq[layer]))
    assert model.embed.dtype == torch.float32
    assert _model(reference, "bfloat16").lm_head.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("name,dtype,kind,flash", _cases(),
                         ids=[c[0] for c in _cases()])
def test_prefill_and_decode_match_reference(reference, name, dtype, kind,
                                            flash):
    """Prefill logits, then three decode steps on the same caches."""
    model = _model(reference, dtype)
    caches = model.init_cache(B, MAX_LEN, dtype=getattr(torch, dtype))
    flags = RunFlags(use_flash_decode=flash, logits_dtype=dtype)
    logits, aux, caches = model(torch.from_numpy(_tokens(-1)), caches,
                                flags=flags)
    assert float(aux) == 0.0
    _assert_logits(logits, reference[f"{name}/prefill"], dtype, "prefill")
    for step in range(STEPS):
        idx = _index(kind, step)
        idx = idx if kind == "scalar" else torch.from_numpy(idx)
        logits, _, caches = model(torch.from_numpy(_tokens(step)), caches,
                                  idx, flags=flags)
        assert logits.shape == (B, 1, 512)
        _assert_logits(logits, reference[f"{name}/step{step}"], dtype,
                       f"decode step {step}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_vector_index_matches_reference(reference, dtype):
    """The reference's kernel takes only a scalar index; the port's takes
    the ``(B,)`` vector too, and must give the reference's plain vector
    path."""
    model = _model(reference, dtype)
    caches = model.init_cache(B, MAX_LEN, dtype=getattr(torch, dtype))
    flags = RunFlags(use_flash_decode=True, logits_dtype=dtype)
    model(torch.from_numpy(_tokens(-1)), caches, flags=flags)
    for step in range(STEPS):
        logits, _, caches = model(torch.from_numpy(_tokens(step)), caches,
                                  torch.from_numpy(_index("vector", step)),
                                  flags=flags)
        _assert_logits(logits, reference[f"{dtype}_vector/step{step}"],
                       dtype, f"decode step {step}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_streaming_matches_reference(reference, dtype):
    s = STREAM
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in _stream_inputs())
    got = attention.attend_streaming(q, k, v, True, s["chunk"], s["chunk"])
    want = reference[f"stream/{dtype}"]
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    if dtype == "float32":
        # the full-materialization oracle agrees (in bf16 the two paths
        # round the probabilities at different points, in both packages)
        np.testing.assert_allclose(
            attention.attend_full(q, k, v, True).numpy(), want,
            rtol=F32_TOL, atol=F32_TOL)


def test_configs_register_only_ported_architectures():
    """Every architecture is ported now: the registry holds the
    reference's ten, in its order; an unknown name still raises."""
    from repro.configs import ARCH_IDS as REFERENCE_IDS
    assert ARCH_IDS == REFERENCE_IDS and len(ARCH_IDS) == 10
    cfg = reduced_config("smollm-360m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (2, 128, 4, 2, 32, 256, 512)
    assert get_config("smollm-360m").n_params() == 409_007_040
    with pytest.raises(KeyError, match="unknown arch 'gpt-2'; known:"):
        get_config("gpt-2")


@pytest.mark.parametrize("change,item", [
    # the ids the cases had while both raised "queue 1 item 7"
    pytest.param(dict(rope="mrope", input_mode="vl"), None,
                 id="change0-queue 1 item 7"),
    pytest.param(dict(family="encdec"), "models/encdec.EncDecLM",
                 id="change1-queue 1 item 7"),
])
def test_unported_blocks_raise(change, item):
    """What this test once saw refused: M-RoPE with the VL input now
    builds; the encoder-decoder family is ``EncDecLM``'s, which
    ``DecoderLM`` names when it refuses the config."""
    cfg = dataclasses.replace(reduced_config("smollm-360m"), **change)
    if item is None:
        model = DecoderLM(cfg, device="meta")
        assert model.cfg.rope == "mrope" and len(model.blocks) == 2
        return
    with pytest.raises(ValueError, match=item):
        DecoderLM(cfg, device="meta")


def test_mamba_and_moe_blocks_build_on_any_pattern():
    """The hybrid family's blocks are ported: mamba blocks, and MoE on
    every ``moe.every``-th block of the pattern (attention or mamba)."""
    cfg = dataclasses.replace(
        reduced_config("smollm-360m"), n_layers=4,
        block_pattern=("attn", "mamba"),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64))
    model = DecoderLM(cfg, device="meta")
    assert [(type(b).__name__, hasattr(b, "moe")) for b in model.blocks] == \
        [("AttnBlock", True), ("MambaBlock", True)] * 2
    with pytest.raises(ValueError, match="unknown block kind 'conv'"):
        DecoderLM(dataclasses.replace(cfg, block_pattern=("conv",)),
                  device="meta")


def test_rwkv_family_builds():
    """The rwkv family is ported: reduced rwkv6 builds with one rwkv block
    and one recurrent state per layer."""
    cfg = reduced_config("rwkv6-1.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim) == (2, 128, 32)
    model = DecoderLM(cfg, device="meta")
    assert [type(b).__name__ for b in model.blocks] == ["RwkvBlock"] * 2
    caches = model.init_cache(3, 16)
    assert [tuple(c["wkv"].shape) for c in caches] == [(3, 4, 32, 32)] * 2
    assert get_config("rwkv6-1.6b").n_params() == 1_577_109_504


if __name__ == "__main__":
    _reference(sys.argv[1])
