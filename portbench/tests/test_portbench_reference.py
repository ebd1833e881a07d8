"""The plain reference held against the program's CPU path at small
sizes: the block codec, the compressed allreduce with error feedback,
the decoder's loss and gradients, the expert-parallel MoE, AdamW, and the
frozen copies (the synthetic stream, the kernels' costs). The tests
import both; the reference modules import nothing of the program."""
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench import costs, synthetic, trainlib, weights
from portbench.reference import adamw as ref_adamw
from portbench.reference import codec as ref_codec
from portbench.reference import model as ref_model

from conftest import small_config

PB = pathlib.Path(weights.__file__).resolve().parent

SEED = 2 ** 31 + 5


@pytest.mark.parametrize("codec,L", [("int8", 1000), ("int8", 256),
                                     ("int4", 777)])
def test_block_encode_is_the_programs_bitwise(codec, L):
    from repro_torch.core import compress
    x = torch.randn(6, L, generator=torch.Generator().manual_seed(L)) * 3
    x[0, :300] = 0.0  # an all-zero block
    q, scale, res = ref_codec.encode(x, codec)
    cd = compress.codec(f"{codec}_block")
    with compress.reference_paths():
        comp, res_p = cd.encode_residual(x)
    assert torch.equal(scale, comp["scale"])
    assert torch.equal(res, res_p)
    assert torch.equal(ref_codec.decode(q, scale, L),
                       cd.decode(comp, L))


@pytest.mark.parametrize("n", [50_000, 20_011])
def test_compressed_allreduce_follows_the_programs(n):
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.train import manual_step as ms
    g = torch.randn(8, n, generator=torch.Generator().manual_seed(n)) * 1e-2
    comm = Communicator(RankGrid(2, 4, "cpu"))
    gs = ms.OverlappedGradSync(comm, [(0, n)], metric_len=4,
                               algo="pip_mcoll", codec="int8_block",
                               error_budget=0.5 / 127)
    err = torch.zeros_like(g)
    for step in range(3):
        gs.ensure_ops(step)
        (y,), _ = gs.sync([g], torch.zeros(8, 4))
        out, err = ref_codec.allreduce(g, err, 2, 4, "int8")
        # only the order of float32 sums differs, which now and then moves
        # a re-encoded element by one quantum (a block's max over 127)
        assert float((y - out).norm() / out.norm()) < 1e-3
        assert float((y - out).abs().max()) <= \
            1.0001 * float(out.abs().max()) / 127
        assert float((gs.errs[0] - err).norm() / err.norm()) < 3e-2
        assert torch.equal(out[0], out[7])


def test_the_int4_control_is_far_from_int8():
    g = torch.randn(8, 4096, generator=torch.Generator().manual_seed(1))
    e = torch.zeros_like(g)
    o8, _ = ref_codec.allreduce(g, e, 2, 4, "int8")
    o4, _ = ref_codec.allreduce(g, e, 2, 4, "int4")
    assert float((o4 - o8).norm() / o8.norm()) > 0.05


def _port_model(cfg):
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.models.params import FlatParams
    model = DecoderLM(trainlib.port_config(cfg), device="cpu")
    flat = FlatParams.of(model)
    flat.assign_weights(weights.tree(cfg, SEED, "cpu"))
    return model.trainable(), flat


def _batch(cfg, rows=4, seq=16):
    b = synthetic.SyntheticLM(cfg["vocab"], seq, rows, seed=3).batch(0)
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _grads_close(g_port, g_ref, flat, tol):
    for (p, s, e, _), gp in zip(flat.spans, g_port):
        want = g_ref[p].reshape(-1)
        assert float((gp - want).norm() / want.norm().clamp_min(1e-30)) \
            < tol, p


def test_dense_decoder_loss_and_gradients_follow_the_programs():
    from repro_torch.train.step import TrainConfig, value_and_grad
    cfg = small_config("smollm-360m.dp2x4")
    model, flat = _port_model(cfg)
    batch = _batch(cfg)
    loss, _, grads = value_and_grad(model, flat, batch, TrainConfig())
    wt = {p: v.detach().requires_grad_()
          for p, v in weights.tree(cfg, SEED, "cpu", torch.float32).items()}
    ref_loss, info = ref_model.forward_loss(wt, batch["tokens"],
                                            batch["labels"], cfg)
    g_ref = dict(zip(wt, torch.autograd.grad(ref_loss, list(wt.values()))))
    # the program computes in bf16: its rounding, not a fault
    assert abs(float(loss) - info["loss"]) < 2e-3 * info["loss"]
    buf = flat.gather(grads)
    g_port = [buf[s:e] for _, s, e, _ in flat.spans]
    _grads_close(g_port, g_ref, flat, 5e-2)


def test_expert_parallel_moe_follows_the_programs():
    from repro_torch.core.grid import RankGrid
    from repro_torch.sharding.rules import Rules
    from repro_torch.train.step import TrainConfig, value_and_grad
    cfg = small_config("qwen3-moe-235b-a22b.l1.ep2x4")
    cfg["moe"] = dict(cfg["moe"], capacity_factor=1.0)  # drops happen
    model, flat = _port_model(cfg)
    batch = _batch(cfg, rows=8)
    grid, rules = RankGrid(2, 4, "cpu"), Rules(batch=("node",), tp="local")
    loss, metrics, grads = value_and_grad(model, flat, batch, TrainConfig(),
                                          rules, grid)
    kept = int(model.blocks[0].moe.ep_routing["kept"].sum())
    wt = {p: v.detach().requires_grad_()
          for p, v in weights.tree(cfg, SEED, "cpu", torch.float32).items()}
    ref_loss, info = ref_model.forward_loss(wt, batch["tokens"],
                                            batch["labels"], cfg, ep=(2, 4))
    # bf16 inputs move a routing on a near tie at the top-k boundary now
    # and then (a few of 256 here): drops and norms agree, not bitwise
    assert info["kept"] < info["routings"]
    assert abs(info["kept"] - kept) <= 0.02 * info["routings"]
    assert abs(float(loss) - info["loss"]) < 2e-3 * info["loss"]
    assert abs(float(metrics["aux"]) - info["aux"]) < 2e-2 * info["aux"]
    g_ref = dict(zip(wt, torch.autograd.grad(ref_loss, list(wt.values()))))
    buf = flat.gather(grads)
    for p, s, e, _ in flat.spans:
        want = float(g_ref[p].norm())
        assert abs(float(buf[s:e].norm()) - want) < 5e-2 * want, p


def test_adamw_follows_the_programs():
    from repro_torch.optim import adamw
    cfg = small_config("smollm-360m.dp2x4")
    model, flat = _port_model(cfg)
    ocfg = adamw.AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=0)
    opt = adamw.init(flat, ocfg)
    ref = ref_adamw.AdamW(ocfg.lr, ocfg.b1, ocfg.b2, ocfg.eps,
                          ocfg.weight_decay, ocfg.grad_clip)
    wt = weights.tree(cfg, SEED, "cpu", torch.float32)
    store = {p: dt for p, _, _, dt in weights.layout(cfg)}
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        g = torch.randn(flat.n, generator=gen) * 0.1
        gd = {p: g[s:e].reshape(flat.shapes[p]).clone()
              for p, s, e, _ in flat.spans}
        adamw.update(flat, g.clone(), opt, ocfg)
        ref.update(wt, gd, store)
    got = flat.read()
    for p, s, e, _ in flat.spans:
        want = wt[p].reshape(-1)
        ulp = want.abs().clamp_min(1e-3) * 2.0 ** -7  # one bf16 step
        assert bool(((got[s:e] - want).abs() <= ulp).all()), p
        assert torch.allclose(opt["m"][s:e], ref.m[p],
                              rtol=1e-5, atol=1e-9), p


def test_the_synthetic_stream_is_the_programs():
    from repro_torch.data.pipeline import SyntheticLM
    for step in (0, 5):
        a = synthetic.SyntheticLM(512, 64, 4, seed=9).batch(step)
        b = SyntheticLM(512, 64, 4, seed=9).batch(step)
        for k in ("tokens", "labels"):
            assert np.array_equal(a[k], b[k])


@pytest.mark.parametrize("S,L", [(16, 819_200), (8, 1000), (1, 256)])
def test_frozen_costs_equal_the_programs_registered_ones(S, L):
    from repro_torch.kernels import codec as kcodec
    x = torch.empty((S, L), device="meta")
    for err in (None, x):
        c = kcodec.encode_cost("int8", x, err)
        assert (c.nbytes, c.ops) == costs.block_encode_cost(
            "int8", S, L, err is not None)
    nb = -(-L // 256)
    comp = {"q": torch.empty((S, 2, nb, 256), dtype=torch.int8,
                             device="meta"),
            "scale": torch.empty((S, 2, nb), device="meta")}
    c = kcodec.decode_cost("int8", comp, L)
    assert (c.nbytes, c.ops) == costs.block_decode_reduce_cost(
        "int8", S, 2, nb, L)


@pytest.mark.parametrize("name", ["smollm-360m.dp2x4",
                                  "qwen3-moe-235b-a22b.l1.ep2x4"])
def test_the_reference_decays_the_leaves_the_program_decays(name):
    """The reference states its weight-decay rule as a list of leaves;
    the program decides by substrings of the path. At the configurations'
    layouts the two pick the same leaves (a change to either rule shows
    here, where the compared numbers cannot see it: decay at lr 1e-4 is
    under bf16's rounding in three steps)."""
    from repro_torch.optim import adamw
    cfg = json.loads((PB / "configs" / f"{name}.json").read_text())["model"]
    paths = [p for p, _, _, _ in weights.layout(cfg)]
    assert [p for p in paths if ref_adamw.decays(p)] == \
        [p for p in paths if adamw.decays(p)] == ["embed", "lm_head"]


def test_the_weight_layout_is_the_programs():
    from repro_torch.models.params import param_shapes
    for name in ("smollm-360m.dp2x4", "qwen3-moe-235b-a22b.l1.ep2x4"):
        cfg = small_config(name)
        want = [(p, tuple(s)) for p, s in param_shapes(
            trainlib.port_config(cfg))]
        assert [(p, s) for p, s, _, _ in weights.layout(cfg)] == want
    full = json.loads((PB / "configs" / "smollm-360m.dp2x4.json")
                      .read_text())
    assert weights.n_params(full["model"]) == full["n_params"]
