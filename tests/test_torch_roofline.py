"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``), on the CPU.

  * terms: ``model_flops``, ``model_flops_attn`` bitwise for the 10
    configs x 4 shapes; ``flash_hbm_traffic`` on the reference's 16x16 and
    2x16x16 meshes (stand-ins with the two attributes it reads) against
    the port's on the same axis sizes; ``compute_terms`` on the reference's
    classification inputs with its TPU constants, and classified alike on
    the H100 default;
  * the work counter's units (the analogues of ``tests/test_roofline.py``);
  * dot FLOPs of reduced forwards against ``hlo.analyze`` of a
    single-device compile of the reference's same forward (its side in one
    module-scoped subprocess), with each difference the two programs'
    products make stated from the code;
  * each of the 14 kernels counted once, the same on the CPU (its plain
    version), on ``meta`` and by its registered formula; outside a count a
    ``meta`` operand still raises.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import SHAPES as JSHAPES, get_config as jget  # noqa: E402
from repro.models.decoder import RunFlags as JRunFlags  # noqa: E402
from repro.roofline import terms as JT  # noqa: E402

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,  # noqa: E402
                                 reduced_config, shape_applicable)
from repro_torch.core.grid import RankGrid  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.kernels import codec as kcodec  # noqa: E402
from repro_torch.kernels import mamba as kmamba  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv as krwkv  # noqa: E402
from repro_torch.kernels import staging as kstaging  # noqa: E402
from repro_torch.models.decoder import DecoderLM, RunFlags  # noqa: E402
from repro_torch.models.params import block_is_moe  # noqa: E402
from repro_torch.roofline import terms as T  # noqa: E402
from repro_torch.roofline.counter import WorkCounter, count  # noqa: E402

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
#: the reference's meshes: single pod (data, model) and two pods
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
#: the same axis sizes on the port's grid axes: {pod, data} -> node
GRIDS = {"single": {"node": 16, "local": 16},
         "multi": {"node": 32, "local": 16}}
#: reduced forwards held to ``hlo.analyze``: (B, T) tokens
HLO_ARCHS = ("smollm-360m", "yi-34b", "qwen3-moe-235b-a22b", "rwkv6-1.6b")
HLO_TOKENS = (2, 16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Mesh:
    """The two attributes of a ``jax.sharding.Mesh`` that the reference's
    ``flash_hbm_traffic`` reads, without 512 devices."""

    def __init__(self, axes, shape):
        self.axis_names = axes
        self.devices = np.empty(shape)


# ---------------------------------------------------------------------------
# terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_bitwise(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    assert T.model_flops(cfg, SHAPES[shape]) == \
        JT.model_flops(jcfg, JSHAPES[shape])
    assert T.model_flops_attn(cfg, SHAPES[shape]) == \
        JT.model_flops_attn(jcfg, JSHAPES[shape])
    assert T._n_attn_layers(cfg) == JT._n_attn_layers(jcfg)


@pytest.mark.parametrize("arch,shape,mesh", [
    (a, s, m) for a, s in CELLS for m in MESHES
    if shape_applicable(get_config(a), SHAPES[s])[0]])
def test_flash_hbm_traffic(arch, shape, mesh):
    """Equal on the same axis sizes, but where a decode batch is smaller
    than the data-parallel axes: the reference shards that cache's
    sequence over ``data`` alone (16 of 2x16 on two pods), the port's
    rules over the whole node axis (32), so there the port's bytes are
    the reference's times 16/32, exactly."""
    cfg, jcfg = get_config(arch), jget(arch)
    sh = SHAPES[shape]
    got = T.flash_hbm_traffic(cfg, sh, GRIDS[mesh], RunFlags())
    want = JT.flash_hbm_traffic(jcfg, JSHAPES[shape], _Mesh(*MESHES[mesh]),
                                JRunFlags())
    if mesh == "multi" and sh.kind == "decode" and sh.global_batch < 32 \
            and want:
        assert got == want * 16 / 32
    else:
        assert got == want


def test_flash_hbm_traffic_takes_a_grid():
    cfg, sh = get_config("yi-34b"), SHAPES["train_4k"]
    grid = RankGrid(32, 8, device="meta")
    assert T.flash_hbm_traffic(cfg, sh, grid, RunFlags()) == \
        T.flash_hbm_traffic(cfg, sh, {"node": 32, "local": 8}, RunFlags())


@pytest.mark.parametrize("args", [(1e12, 1e12, 1e9, 256, 6e14),
                                  (1e14, 1e10, 1e9, 256, 6e16)])
def test_compute_terms(args):
    tpu = T.Hardware("tpu v5e", JT.PEAK_FLOPS, JT.HBM_BW, JT.ICI_BW,
                     JT.ICI_BW)
    got = T.compute_terms(*args, hw=tpu)
    want = JT.compute_terms(*args)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.total_s() == want.total_s()
    assert got.roofline_fraction() == want.roofline_fraction()
    h100 = T.compute_terms(*args)
    assert h100.bottleneck == want.bottleneck
    assert h100.compute_s == args[0] / 989.4e12
    assert h100.memory_s == args[1] / 3.35e12
    assert h100.collective_s == args[2] / 50e9


# ---------------------------------------------------------------------------
# the counter's units
# ---------------------------------------------------------------------------


def test_matmul_flops_and_backward():
    """A bf16 (64x128)@(128x256) and its backward: 3*2*M*K*N, as
    FlopCounterMode counts it."""
    a = torch.randn(64, 128, dtype=torch.bfloat16, requires_grad=True)
    b = torch.randn(128, 256, dtype=torch.bfloat16, requires_grad=True)

    def step():
        (a @ b).float().sum().backward()
    _, c = count(step)
    assert c.flops == 3 * 2 * 64 * 128 * 256 == 12_582_912
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fm:
        step()
    assert fm.get_total_flops() == c.flops


def test_loop_counts_each_iteration():
    x, w = torch.randn(8, 32), torch.randn(32, 32)

    def loop(n):
        y = x
        for _ in range(n):
            y = torch.tanh(y @ w)
        return y
    _, one = count(loop, 1)
    _, ten = count(loop, 10)
    assert ten.flops == 10 * one.flops == 10 * 2 * 8 * 32 * 32
    assert ten.memory_bytes == 10 * one.memory_bytes
    assert ten.aten_ops == 10 * one.aten_ops


def test_all_reduce_counted_once_with_its_bytes():
    grid = RankGrid(4, 2, device="cpu")
    x = torch.randn(8, 16)
    y, c = count(grid.psum, x, ("node", "local"))
    assert c.collective_counts == {"all-reduce": 1}
    assert c.collective_bytes == c.collective_bytes_by_op["all-reduce"] \
        == 16 * 4
    torch.testing.assert_close(y[3], x.sum(0))


def test_views_count_zero_and_a_cast_its_read_and_write():
    x = torch.randn(64, 128)

    def views():
        return (x.view(128, 64), x.t(), x[1:], x[:, None].expand(64, 3, 128),
                x.reshape(-1), x.detach())
    _, c = count(views)
    assert c.memory_bytes == 0 and c.flops == 0
    _, c = count(lambda: x.to(torch.bfloat16))
    assert c.memory_bytes == 64 * 128 * (4 + 2)


def test_top_traffic_lists_the_heaviest_ops():
    x = torch.randn(64, 128)
    grid = RankGrid(4, 2, device="cpu")
    with WorkCounter() as wc:
        x.to(torch.bfloat16)
        x + x
        grid.ppermute(torch.randn(8, 16), "node", [(0, 1)])
    rows = wc.top_traffic()
    assert rows[0] == (3 * 64 * 128 * 4, 1, "aten.add")
    assert rows[1] == (64 * 128 * 6, 1, "aten._to_copy")
    assert (2 * 8 * 16 * 4 + 8 * 8, 1, "kernel:pack_blocks") in rows
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)


def test_meta_cache_remakes_outputs():
    """On meta an op seen before is not rerun: its outputs' shapes,
    strides and dtypes, and in-place ops' own argument, come back."""
    x = torch.empty(4, 6, device="meta")
    with WorkCounter() as wc:
        a = (x + 1).t().contiguous()
        b = (x + 1).t().contiguous()
        y = x.add_(1)
        z = x.add_(1)
    assert (a.shape, a.stride(), b.shape, b.stride()) == \
        ((6, 4), (4, 1), (6, 4), (4, 1))
    assert y is x and z is x
    # each x + 1 and clone reads 96 bytes and writes 96; each add_ reads
    # and writes x
    assert wc.costs().memory_bytes == 2 * (192 + 192) + 2 * 192


# ---------------------------------------------------------------------------
# against hlo.analyze
# ---------------------------------------------------------------------------


def _reference_main(out: str) -> None:
    """The reference side: ``hlo.analyze`` dot FLOPs of each reduced
    forward compiled for one device."""
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.models import decoder as jdecoder
    from repro.roofline import hlo

    res = {}
    for arch in HLO_ARCHS:
        cfg = jreduced(arch)
        params = jax.eval_shape(lambda k: jdecoder.init(k, cfg),
                                jax.random.PRNGKey(0))
        toks = jax.ShapeDtypeStruct(HLO_TOKENS, jnp.int32)
        f = jax.jit(lambda p, t: jdecoder.forward(p, t, cfg)[0])
        res[arch] = hlo.analyze(f.lower(params, toks).compile().as_text()
                                ).flops
    pathlib.Path(out).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def hlo_flops(tmp_path_factory):
    out = tmp_path_factory.mktemp("hlo") / "flops.json"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{repo / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _expected_gap(cfg) -> float:
    """The reference's dot FLOPs past the port's, from the two programs:

    * MoE: the reference's ``ragged_dot`` (``repro/layers/moe.py:76-80``)
      compiles on the CPU to dense dots over all E experts; the port's
      experts each multiply their own rows (the FLOPs of the exact active
      products). Three products a layer of R = B*T*k rows: the reference
      does E times 2*R*D*F each, the port once;
    * rwkv: the reference's plain WKV scan takes each step's ``r . S`` as
      a dot, 2*hd*hd per (row, head, step); the port's plain recurrence
      (``kernels/ref.rwkv6_wkv``) multiplies and sums, no product.
    """
    B, Tn = HLO_TOKENS
    if cfg.moe is not None:
        R = B * Tn * cfg.moe.top_k
        per = 2 * R * cfg.d_model * cfg.moe.d_ff_expert
        n_moe = sum(block_is_moe(cfg, j) for j in range(cfg.n_layers))
        return (cfg.moe.n_experts - 1) * 3 * per * n_moe
    if cfg.family == "rwkv":
        hd = cfg.rwkv_head_dim
        H = cfg.d_model // hd
        return 2 * hd * hd * B * H * Tn * cfg.n_layers
    return 0


@pytest.mark.parametrize("arch", HLO_ARCHS)
def test_dot_flops_against_hlo_analyze(arch, hlo_flops):
    cfg = reduced_config(arch)
    model = DecoderLM(cfg, torch.Generator("cpu").manual_seed(0),
                      device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, HLO_TOKENS))
    with torch.no_grad():
        _, c = count(model, toks)
    assert hlo_flops[arch] - c.flops == _expected_gap(cfg)
    if arch in ("smollm-360m", "yi-34b"):
        assert c.flops == hlo_flops[arch]


# ---------------------------------------------------------------------------
# one count per kernel
# ---------------------------------------------------------------------------


def _codec_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 1000, generator=g)
    e = torch.randn(3, 1000, generator=g) * 0.01
    xw = torch.randn(2, 3, 1000, generator=g)
    S, L, nb, R, W = 3, 1000, 4, 2, 3
    wire = {"int8": S * nb * 256, "int4": S * nb * 128, "fp8": S * L}
    scales = {"int8": 4 * S * nb, "int4": 4 * S * nb, "fp8": 4 * S}
    ops = {"int8": 9, "int4": 9, "fp8": 11}
    cases = {}
    for c in ("int8", "int4", "fp8"):
        enc = 4 * S * L + wire[c] + scales[c] + 4 * S * L
        cases[f"{c}_encode_residual"] = (
            getattr(kcodec, f"{c}_encode_residual"), (x,),
            (enc, ops[c] * S * L))
        cases[f"{c}_encode_feedback"] = (
            getattr(kcodec, f"{c}_encode_feedback"), (x, e),
            (enc + 4 * S * L, ops[c] * S * L))
        comp, _ = getattr(ref, f"{c}_encode_residual")(xw)
        dec = comp["q"].numel() * comp["q"].element_size() \
            + 4 * comp["scale"].numel() + 4 * R * L
        cases[f"{c}_decode_reduce"] = (
            getattr(kcodec, f"{c}_decode_reduce"), (comp, L),
            (dec, 2 * R * W * L))
    return cases


def _kernel_cases():
    g = torch.Generator().manual_seed(1)
    cases = _codec_cases()
    v, shift = torch.randn(4, 6, 5, generator=g), torch.tensor([0, 1, 5, 2])
    cases["shift_blocks"] = (kstaging.shift_blocks, (v, shift),
                             (2 * 4 * 6 * 5 * 4 + 8 * 4, 0))
    src, idx = torch.randn(7, 5, generator=g), torch.tensor([3, -1, 6, 0])
    cases["pack_blocks"] = (kstaging.pack_blocks, (src, idx),
                            (2 * 4 * 5 * 4 + 8 * 4, 0))
    q = torch.randn(2, 1, 4, 8, generator=g)
    k, vv = torch.randn(2, 10, 2, 8, generator=g), \
        torch.randn(2, 10, 2, 8, generator=g)
    cases["flash_decode"] = (kattn.flash_decode, (q, k, vv, 7),
                             (2 * 4 * 8 * 4 + 2 * 14 * 2 * 8 * 4
                              + 2 * 4 * 8 * 4, 4 * 4 * 8 * 14))
    B, Tn, Di, N = 2, 5, 6, 4
    dt = torch.rand(B, Tn, Di, generator=g)
    A = -torch.rand(Di, N, generator=g)
    Bm, Cm = torch.randn(B, Tn, N, generator=g), \
        torch.randn(B, Tn, N, generator=g)
    xs, h0 = torch.randn(B, Tn, Di, generator=g), \
        torch.randn(B, Di, N, generator=g)
    cases["mamba_scan"] = (kmamba.mamba_scan, (dt, A, Bm, Cm, xs, h0),
                           (B * Tn * Di * 12 + 2 * B * Tn * N * 4
                            + Di * N * 4 + 2 * B * Di * N * 4,
                            6 * B * Tn * Di * N + B * Tn * Di))
    H, hd = 2, 4
    r, kk, vw = (torch.randn(B, 3, H, hd, generator=g) for _ in range(3))
    w = torch.rand(B, 3, H, hd, generator=g)
    u, s0 = torch.randn(H, hd, generator=g), \
        torch.randn(B, H, hd, hd, generator=g)
    cases["rwkv6_wkv"] = (krwkv.rwkv6_wkv, (r, kk, vw, w, u, s0),
                          (B * 3 * H * hd * 20 + 2 * B * H * hd * hd * 4
                           + H * hd * 4,
                           5 * B * 3 * H * hd * hd + 3 * B * 3 * H * hd))
    return cases


KERNELS = sorted(_kernel_cases())


def _to(obj, dev):
    if torch.is_tensor(obj):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    return obj


def test_fourteen_kernels():
    assert len(KERNELS) == 14


@pytest.mark.parametrize("name", KERNELS)
def test_one_count_per_kernel(name):
    fn, args, (nbytes, ops) = _kernel_cases()[name]
    costs = []
    for dev in ("cpu", "meta"):
        _, c = count(fn, *(_to(a, dev) for a in args))
        costs.append(c)
        assert c.kernels == {name: {"calls": 1, "bytes": nbytes,
                                    "ops": ops}}, dev
        assert c.memory_bytes == nbytes and c.kernel_ops == ops
        assert c.flops == 0 and c.aten_ops == 0
    assert costs[0] == costs[1]


@pytest.mark.parametrize("name", KERNELS)
def test_meta_outside_the_counter_raises(name):
    fn, args, _ = _kernel_cases()[name]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn(*(_to(a, "meta") for a in args))


@pytest.mark.parametrize("name", KERNELS)
def test_meta_outputs_have_the_plain_versions_shapes(name):
    fn, args, _ = _kernel_cases()[name]
    want = fn(*args)
    with WorkCounter():
        got = fn(*(_to(a, "meta") for a in args))
    flat_w, flat_g = [], []
    for tree, flat in ((want, flat_w), (got, flat_g)):
        stack = [tree]
        while stack:
            t = stack.pop()
            if torch.is_tensor(t):
                flat.append((tuple(t.shape), t.dtype))
            elif isinstance(t, dict):
                stack.extend(t[k] for k in sorted(t))
            else:
                stack.extend(t)
    assert flat_g == flat_w


def test_meta_lengths_count_the_whole_cache():
    q = torch.empty(2, 1, 4, 8, device="meta")
    k = torch.empty(2, 10, 2, 8, device="meta")
    lens = torch.empty(2, dtype=torch.long, device="meta")
    _, c = count(kattn.flash_decode, q, k, k, lens)
    assert c.kernel_ops == 4 * 4 * 8 * 20


if __name__ == "__main__":
    _reference_main(sys.argv[1])
