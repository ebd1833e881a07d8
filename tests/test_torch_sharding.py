"""The port's sharding rules, logical-axis trees and default rules against
the reference's (``repro.sharding.rules``, the layers' and models'
``logical``/``cache_logical``/``state_logical``, ``attention.cache_pspec``,
``optim.adamw.state_logical``, ``launch.mesh.default_rules``), which are
pure functions of shapes and axis sizes: both run in this process, the
reference's on a stand-in mesh (``axis_names`` and ``shape``; it reads no
devices). Specs are compared as ``tuple(PartitionSpec)``, exactly.
"""
import dataclasses

import pytest

jax = pytest.importorskip("jax")

from _hypothesis_compat import given, settings, strategies as st  # noqa
from repro.configs import get_config as jget, reduced_config as jreduced
from repro.launch import mesh as jmesh
from repro.layers import attention as jattn
from repro.models import decoder as jdecoder, encdec as jencdec
from repro.optim import adamw as jadamw
from repro.sharding import rules as jrules

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 reduced_config, shape_applicable)
from repro_torch.core.grid import RankGrid
from repro_torch.launch import mesh as tmesh
from repro_torch.layers import attention as tattn
from repro_torch.models import decoder as tdecoder, encdec as tencdec
from repro_torch.models.params import n_params, param_shapes
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import rules as R

MESH_SHAPE = {"pod": 2, "data": 16, "model": 16}
RULES = dict(batch=("pod", "data"), fsdp=("data",), tp="model")
NAMES = (None, "batch", "fsdp", "heads", "kv_heads", "ff", "vocab",
         "experts", "inner", "seq")
#: the reference's axis names as the port's production grid names them
RENAME = {"pod": "node", "data": "node", "model": "local"}


def _jspec(logical, dims, rules, shape):
    return tuple(jrules.spec_for(logical, dims, rules, shape))


def _is_leaf(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _flat(tree, prefix=""):
    """``{path: logical tuple}`` of a reference tree, dict keys sorted."""
    if _is_leaf(tree):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dim", [4096, 960, 15, 7, 256, 3, 1, 32])
def test_spec_for_matches_reference_for_every_axis(name, dim):
    """Every logical axis name on divisible and indivisible dims, with
    composed batch axes (pod x data), a seq axis and none."""
    for seq in (None, "data"):
        j = jrules.Rules(seq=seq, **RULES)
        t = R.Rules(seq=seq, **RULES)
        logical = (name, "fsdp")
        assert R.spec_for(logical, (dim, 64), t, MESH_SHAPE) == \
            _jspec(logical, (dim, 64), j, MESH_SHAPE)


def test_spec_for_pins_the_reference_cases():
    """``tests/test_sharding.py``'s cases on the port."""
    t = R.Rules(**RULES)
    assert R.spec_for(("fsdp", "heads"), (4096, 64), t, MESH_SHAPE) == \
        ("data", "model")
    assert R.spec_for(("fsdp", "heads"), (960, 15), t, MESH_SHAPE) == \
        ("data", None)
    assert R.spec_for(("fsdp",), (7,), t, MESH_SHAPE) == (None,)
    assert R.spec_for(("batch", None), (256, 4096), t, MESH_SHAPE) == \
        (("pod", "data"), None)
    assert R.spec_for(("batch", None), (3, 16), t, MESH_SHAPE) == \
        (None, None)
    with pytest.raises(ValueError, match="unknown logical axis"):
        R.spec_for(("rows",), (4,), t, MESH_SHAPE)


@given(dim=st.integers(1, 4096), name=st.sampled_from(NAMES[1:]))
@settings(max_examples=100, deadline=None)
def test_spec_for_matches_reference_over_dims(dim, name):
    """Whatever the dim, the port's spec is the reference's, and a
    sharded entry divides the dim."""
    j, t = jrules.Rules(seq="data", **RULES), R.Rules(seq="data", **RULES)
    got = R.spec_for((name,), (dim,), t, MESH_SHAPE)
    assert got == _jspec((name,), (dim,), j, MESH_SHAPE)
    if got[0] is not None:
        axes = got[0] if isinstance(got[0], tuple) else (got[0],)
        n = 1
        for a in axes:
            n *= MESH_SHAPE[a]
        assert dim % n == 0


def test_constrain_returns_its_input_and_checks_the_spec():
    import torch
    x = torch.zeros(4, 6)
    grid = RankGrid(2, 2, "cpu")
    t = R.Rules(batch=("node",), tp="local")
    assert R.constrain(x, ("batch", "heads"), t, grid) is x
    assert R.constrain(x, ("batch",), None, None) is x
    with pytest.raises(ValueError):
        R.constrain(x, ("batch",), t, grid)


def _api(cfg, j=False):
    if j:
        return jencdec if cfg.family == "encdec" else jdecoder
    return tencdec if cfg.family == "encdec" else tdecoder


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_trees_match_reference(arch, size):
    """``logical(cfg)`` path for path the reference's, each tuple's rank
    its leaf's; ``cache_logical`` likewise for the decoders."""
    cfg = (reduced_config if size == "reduced" else get_config)(arch)
    jcfg = (jreduced if size == "reduced" else jget)(arch)
    got = _api(cfg).logical(cfg)
    want = _flat(_api(cfg, True).logical(jcfg))
    assert list(got) == [p for p, _ in param_shapes(cfg)]
    assert got == want
    for path, shape in param_shapes(cfg):
        assert len(got[path]) == len(shape), path
    if cfg.family != "encdec":
        assert tdecoder.cache_logical(cfg) == _flat(
            jdecoder.cache_logical(jcfg))


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("arch", ["smollm-360m", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_state_logical_matches_reference(arch, master):
    cfg = reduced_config(arch)
    got = tadamw.state_logical(_api(cfg).logical(cfg),
                               tadamw.AdamWConfig(master_fp32=master))
    want = jadamw.state_logical(_api(cfg, True).logical(jreduced(arch)),
                                jadamw.AdamWConfig(master_fp32=master))
    flat = {f"{k}/{p}": v for k, tree in got.items() if k != "step"
            for p, v in tree.items()}
    assert got["step"] == want["step"] == ()
    assert flat == {k: v for k, v in _flat(want).items() if k != "step"}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("rules", [
    dict(batch=("data",), tp="model"),
    dict(batch=("pod", "data"), tp="model", seq="data"),
    dict(batch=(), tp="model", seq="data"),
    dict(batch=("data",), tp=None)])
def test_cache_pspec_matches_reference(arch, rules):
    """kv heads over TP where it divides them, else the sequence takes TP;
    ``seq`` composes on the sequence dim."""
    cfg = get_config(arch)
    got = tattn.cache_pspec(cfg, R.Rules(**rules), MESH_SHAPE)
    want = tuple(jattn.cache_pspec(jget(arch), jrules.Rules(**rules),
                                   MESH_SHAPE))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_specs_shard_full_configs_on_the_production_grid(arch):
    """Every full config's weights get specs on the production grid, at
    least one leaf sharded, each entry dividing its dim."""
    cfg = get_config(arch)
    grid = tmesh.make_production_grid()
    rules = tmesh.default_rules(grid, "train", 256, 4096)
    shapes = dict(param_shapes(cfg))
    specs = R.tree_specs(_api(cfg).logical(cfg), shapes, rules, grid)
    sizes = R.grid_shape(grid)
    assert set(specs) == set(shapes)
    sharded = 0
    for path, spec in specs.items():
        for entry, d in zip(spec, shapes[path]):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                n = 1
                for a in axes:
                    n *= sizes[a]
                assert d % n == 0, (path, spec)
        sharded += any(e is not None for e in spec)
    assert sharded > 0


def test_production_grids_and_make_mesh():
    """256 and 512 GPUs in nodes of 8, allocating nothing."""
    assert (tmesh.make_production_grid().world,
            tmesh.make_production_grid(multi_pod=True).world) == (256, 512)
    g = tmesh.make_production_grid(device="cpu")
    assert g.shape == {"node": 32, "local": 8}
    assert tmesh.make_mesh((2, 4), ("node", "local"), "cpu") == \
        RankGrid(2, 4, "cpu")
    assert tmesh.make_mesh((4,), ("local",), "cpu") == RankGrid(1, 4, "cpu")
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 4), ("data", "model"), "cpu")


class _StandIn:
    """The reference's ``default_rules`` reads ``axis_names`` and
    ``shape`` only."""
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _renamed(rules):
    ren = lambda axes: tuple(dict.fromkeys(RENAME[a] for a in axes))
    return R.Rules(batch=ren(rules.batch), fsdp=ren(rules.fsdp),
                   tp=rules.tp and RENAME[rules.tp],
                   seq=rules.seq and RENAME[rules.seq])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_rules_match_reference(arch, monkeypatch):
    """Every arch x applicable shape on the (16, 16) shape, the port's
    memory patched to the reference's 16e9, gives the reference's rules
    under the renaming {pod, data} -> node, model -> local; the weights'
    bytes are the bf16 parameters'. Small decode batches take context
    parallelism (a batch below the node axis)."""
    monkeypatch.setattr(tmesh, "HBM_BYTES", jmesh.HBM_BYTES)
    cfg = get_config(arch)
    pb = 2.0 * n_params(cfg)
    stand_in = _StandIn({"data": 16, "model": 16})
    grid = RankGrid(16, 16, "cpu")
    shapes = dict(SHAPES, small=dataclasses.replace(
        SHAPES["decode_32k"], name="small", global_batch=4))
    for shape in shapes.values():
        if not shape_applicable(cfg, shape)[0]:
            continue
        for bytes_ in (pb, 0.0):
            want = jmesh.default_rules(stand_in, shape.kind,
                                       shape.global_batch, shape.seq_len,
                                       bytes_)
            got = tmesh.default_rules(grid, shape.kind, shape.global_batch,
                                      shape.seq_len, bytes_)
            assert got == _renamed(want), (shape.name, bytes_)
