"""The launch layer's cells (``launch/specs.py``): every full config's
weights, AdamW state, batch and caches built on ``meta`` for every
applicable shape on the production grid, their shapes, dtypes and specs
against the reference's (``jax.eval_shape`` of its ``init``/``init_cache``
and ``spec_for`` over its logical trees, in this process: they read no
devices); then, at reduced sizes on a CPU ``RankGrid(2, 2)``, the cells'
callables against the calls they stand for, bit for bit.
"""
from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as jget  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.models import decoder as jdecoder, encdec as jencdec  # noqa
from repro.optim import adamw as jadamw  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeConfig,  # noqa
                                 get_config, reduced_config,
                                 shape_applicable)
from repro_torch.core.grid import RankGrid  # noqa: E402
from repro_torch.launch import mesh as tmesh, specs  # noqa: E402
from repro_torch.models.decoder import DecoderLM, RunFlags  # noqa: E402
from repro_torch.models.encdec import EncDecLM  # noqa: E402
from repro_torch.models.params import FlatParams  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding.rules import Rules  # noqa: E402
from repro_torch.train.step import TrainConfig, train_step  # noqa: E402

GRID_SHAPE = {"node": 32, "local": 8}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers,
    where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_leaf(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _flat(tree, prefix=""):
    if _is_leaf(tree) or hasattr(tree, "shape"):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def _jrules(rules):
    return jrules.Rules(batch=rules.batch, fsdp=rules.fsdp, tp=rules.tp,
                        seq=rules.seq)


def _jspec(logical, shape, rules):
    return tuple(jrules.spec_for(logical, tuple(shape), _jrules(rules),
                                 GRID_SHAPE))


def jnp_dtype(d):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int32": torch.int32}[str(d)]


def _check(got, want_shapes, want_specs, what):
    assert set(got) == set(want_shapes), what
    for path, leaf in got.items():
        ws = want_shapes[path]
        assert leaf.shape == tuple(ws.shape), (what, path)
        assert leaf.dtype == jnp_dtype(ws.dtype), (what, path)
        assert leaf.spec == want_specs[path], (what, path, leaf.spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_build_on_meta_and_match_reference_specs(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    grid = tmesh.make_production_grid()
    assert {p.device.type for p in
            specs.meta_model(cfg).parameters()} == {"meta"}
    japi = jencdec if cfg.family == "encdec" else jdecoder
    jshapes = _flat(jax.eval_shape(lambda k: japi.init(k, jcfg),
                                   jax.random.PRNGKey(0)))
    jlogical = _flat(japi.logical(jcfg))
    ocfg = adamw.AdamWConfig()
    for shape in SHAPES.values():
        if not shape_applicable(cfg, shape)[0]:
            continue
        rules = tmesh.default_rules(grid, shape.kind, shape.global_batch,
                                    shape.seq_len, 2.0 * 1e9)
        params = specs.param_specs(cfg, rules, grid)
        assert list(params) == list(jlogical)
        _check(params, jshapes, {p: _jspec(jlogical[p], s.shape, rules)
                                 for p, s in jshapes.items()}, "params")
        opt = specs.opt_specs(cfg, params, rules, grid, ocfg)
        jopt = jadamw.state_logical(japi.logical(jcfg),
                                    jadamw.AdamWConfig())
        assert opt["step"] == specs.LeafSpec((), torch.int32, ())
        for name in ("m", "v"):
            want = _flat(jopt[name])
            assert {p: s.spec for p, s in opt[name].items()} == \
                {p: _jspec(want[p], jshapes[p].shape, rules) for p in want}
            assert {s.dtype for s in opt[name].values()} == {torch.float32}
        batch = specs.batch_specs(cfg, shape, rules, grid)
        for leaf in batch.values():
            assert leaf.shape[0] == shape.global_batch
            lg = ("batch",) + (None,) * (len(leaf.shape) - 1)
            assert leaf.spec == _jspec(lg, leaf.shape, rules)
        assert batch["tokens"].dtype == torch.int32
        if shape.kind == "train":
            continue
        B, S = shape.global_batch, shape.seq_len
        caches = specs.cache_specs(cfg, B, S, rules, grid)
        kv = (None,) + tuple(jattn.cache_pspec(jcfg, _jrules(rules),
                                               GRID_SHAPE))
        if cfg.family == "encdec":
            jc = _flat(jax.eval_shape(partial(jencdec.init_cache, jcfg, B,
                                              S)))
            _check(caches, jc, {p: kv for p in jc}, "encdec caches")
            continue
        jc = _flat(jax.eval_shape(partial(jdecoder.init_cache, jcfg, B, S)))
        jcl = _flat(jdecoder.cache_logical(jcfg))
        pat = cfg.block_pattern
        want = {p: kv if pat[int(p.split("/")[0][3:])] == "attn"
                else _jspec(jcl[p], jc[p].shape, rules) for p in jc}
        _check(caches, jc, want, "caches")


MOE = "qwen3-moe-235b-a22b"


def _grid_rules():
    return RankGrid(2, 2, "cpu"), Rules(batch=("node",), tp="local")


def _model(arch):
    cfg = reduced_config(arch)
    cls = EncDecLM if cfg.family == "encdec" else DecoderLM
    return cls(cfg, torch.Generator().manual_seed(0), device="cpu")


def _batch(cfg, B=4, T=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T + 1)))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)).bfloat16()
    return out


@pytest.mark.parametrize("arch", [MOE, "seamless-m4t-large-v2"])
def test_train_cell_is_the_sharded_train_step(arch):
    """``build_train_cell``'s callable is ``train_step(..., rules=,
    grid=)``: loss, weights, ``m`` and ``v`` bit for bit, two steps; its
    abstract arguments have the concrete ones' shapes."""
    grid, rules = _grid_rules()
    cfg = reduced_config(arch)
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3),
                       flags=RunFlags(remat="none"))
    fn, (params, opt, batch) = specs.build_train_cell(
        cfg, ShapeConfig("t", 16, 4, "train"), grid, rules, tcfg)
    runs = []
    for cell in (True, False):
        model = _model(arch)
        flat = FlatParams.of(model)
        st = adamw.init(flat, tcfg.optimizer)
        assert {p: s.shape for p, s in params.items()} == flat.shapes
        for step in range(2):
            b = _batch(cfg, seed=step)
            if cell:
                mets = fn(model, st, b, flat)
            else:
                mets = train_step(model, st, b, tcfg, flat, rules=rules,
                                  grid=grid)
        runs.append((mets["loss"], flat.read(), st["m"], st["v"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # the encoder-decoder splits the sequence between frames and tokens
    T = 8 if cfg.family == "encdec" else 16
    assert batch["tokens"].shape == batch["labels"].shape == (4, T)


def test_prefill_and_decode_cells_run_the_forward():
    """The prefill cell gives the forward's last-position logits and the
    caches it fills; the decode cell one token at an index; reduced
    qwen3-moe, its MoE expert parallel on the grid."""
    grid, rules = _grid_rules()
    cfg = reduced_config(MOE)
    shape = ShapeConfig("p", 16, 4, "prefill")
    model = _model(MOE)
    prefill, (_, tok_spec, cache_spec) = specs.build_prefill_cell(
        cfg, shape, grid, rules, RunFlags())
    decode, _ = specs.build_decode_cell(
        cfg, ShapeConfig("d", 16, 4, "decode"), grid, rules, RunFlags())
    tokens = _batch(cfg)["tokens"]
    assert tok_spec.shape == tuple(tokens.shape)
    caches = model.init_cache(4, 16)
    assert set(cache_spec) == {f"blk0/{n}" for n in ("k", "v")}
    last, caches = prefill(model, tokens, caches)
    want_caches = model.init_cache(4, 16)
    with torch.no_grad():
        logits, _, want_caches = model(tokens, caches=want_caches,
                                       rules=rules, grid=grid)
    assert torch.equal(last, logits[:, -1:])
    for got, want in zip(caches, want_caches):
        assert all(torch.equal(got[k], want[k]) for k in want)
    tok = last.argmax(-1)
    idx = torch.tensor(15)
    caches[0] = {k: v.clone() for k, v in caches[0].items()}
    ref_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    out, _ = decode(model, tok, caches, idx)
    with torch.no_grad():
        want, _, _ = model(tok, caches=ref_caches, cache_index=idx,
                           rules=rules, grid=grid)
    assert out.shape == (4, 1, want.shape[-1])
    assert torch.equal(out, want) and torch.isfinite(out.float()).all()


def test_encdec_prefill_and_decode_cells():
    """The encoder-decoder's prefill cell encodes and builds the cross
    K/V; its decode cell runs one token against them."""
    grid, rules = _grid_rules()
    arch = "seamless-m4t-large-v2"
    cfg = reduced_config(arch)
    model = _model(arch)
    prefill, (_, frames_spec) = specs.build_prefill_cell(
        cfg, ShapeConfig("p", 8, 2, "prefill"), grid, rules, RunFlags())
    decode, args = specs.build_decode_cell(
        cfg, ShapeConfig("d", 8, 2, "decode"), grid, rules, RunFlags())
    assert set(args[3]) == {"k", "v"}
    frames = _batch(cfg, B=2, T=8)["frames"]
    assert frames_spec.shape == tuple(frames.shape)
    enc_out, xkv = prefill(model, frames)
    with torch.no_grad():
        want = model.encode(frames)
    assert torch.equal(enc_out, want)
    caches = model.init_cache(2, 8)
    tok = torch.zeros((2, 1), dtype=torch.long)
    logits, caches = decode(model, tok, caches, xkv, torch.tensor(0))
    assert logits.shape[:2] == (2, 1) and torch.isfinite(
        logits.float()).all()


@pytest.mark.parametrize("entry", [tmesh.make_production_grid,
                                   tmesh.make_mesh, tmesh.make_process_grid],
                         ids=lambda f: f.__name__)
def test_grid_entry_points_default_to_the_card(entry):
    import inspect
    assert inspect.signature(entry).parameters["device"].default == "cuda"
    assert tmesh.make_production_grid().device.type == "cuda"


def test_train_driver_runs_on_the_card_unless_asked(tmp_path):
    """``python -m repro_torch.launch.train`` without ``--device`` takes
    the card: with none it fails (no fallback to the CPU) and prints no
    step."""
    import os
    import pathlib
    import subprocess
    import sys
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "1", "--ckpt-dir", str(tmp_path)], env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "[train] step" not in proc.stdout
