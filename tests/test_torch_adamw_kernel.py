"""The fused AdamW update (``kernels/adamw.py``, ``csrc/adamw.cu``).

On the CPU: ``optim.adamw.update`` takes the plain passes
(``kernels/ref.py`` ``adamw_update``) and launches nothing; under the work
counter the wrapper records its cost once, at its bytes a parameter; the
``_build.SIGNATURES`` entry names exactly the C functions the source
exports, with their argument counts.

``cuda``-marked tests (run on the card; they skip elsewhere) hold two
consecutive updates through the kernel bitwise to the plain passes run on
the card from the same state: ``m``, ``v``, the stored weights and the
masters, over bf16 and float32 leaves, decayed and not, with and without
``master_fp32``, with the clip active and inactive, leaves whose flat
offsets and lengths break 16-byte alignment, a weight whose address shares
no phase with the flat buffers', a leaf of two tensors and one larger than
2**24 elements; the launches counted are one per weight tensor, and no
call synchronizes with the host (``set_sync_debug_mode("error")``). This
file imports nothing of JAX.
"""
import re

import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import adamw as kadamw
from repro_torch.models.params import FlatParams
from repro_torch.optim import adamw
from repro_torch.roofline.counter import count

#: (path, dtype, numel of each tensor): decayed paths are "embed" and
#: "lm_head" (``adamw.decays``); odd lengths move later leaves' flat
#: offsets off 16-byte boundaries
LEAVES = (("embed", torch.bfloat16, (1003,)),
          ("final_norm/scale", torch.bfloat16, (7,)),
          ("groups/a", torch.bfloat16, (4099, 2050)),
          ("groups/router", torch.float32, (513,)),
          ("lm_head", torch.float32, (2001,)),
          ("groups/b", torch.float32, (3,)))
#: a leaf past one plain piece (``ref.ADAMW_CHUNK``)
BIG = ("groups/big", torch.bfloat16, ((1 << 24) + 5,))
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1)


def _flat(leaves, device, seed=0, odd_weight=False):
    """A ``FlatParams`` of seeded weights on ``device``; with
    ``odd_weight`` the first leaf's tensor is a view one element into a
    larger buffer, so its address is off the phase of the flat
    buffers'."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i, (path, dtype, sizes) in enumerate(leaves):
        ts = [torch.randn(n, generator=gen).to(dtype) for n in sizes]
        out.append((path, [_odd_view(t, device) if odd_weight and i == 0
                           else t.to(device) for t in ts]))
    return FlatParams(out)


def _odd_view(w, device):
    buf = torch.empty(w.numel() + 1, dtype=w.dtype, device=device)
    buf[1:] = w.to(device)
    return buf[1:]


def _grads(n, seed, scale, device):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(n, generator=gen) * scale).to(device)


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


def _same(got, want, what):
    assert got.dtype == want.dtype, what
    assert torch.equal(_bits(got), _bits(want)), (
        f"{what}: {int((_bits(got) != _bits(want)).sum())} of "
        f"{got.numel()} elements differ")


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def test_cpu_operands_take_the_plain_passes(monkeypatch):
    calls = []
    plain = ref.adamw_update
    monkeypatch.setattr(ref, "adamw_update",
                        lambda *a: calls.append(1) or plain(*a))
    kadamw.reset_launches()
    p = _flat(LEAVES[:3], "cpu")
    c = adamw.AdamWConfig(**OPT)
    st = adamw.init(p, c)
    before = p.read()
    adamw.update(p, _grads(p.n, 1, 1.0, "cpu"), st, c)
    assert calls == [1] and kadamw.launches == {"adamw_update": 0}
    assert st["step"] == 1 and not torch.equal(p.read(), before)


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cost_counted_once(master, device):
    """One ``adamw_update`` count a call, at 20 bytes an element for the
    gradient, ``m`` and ``v``, plus the weights read and written (bf16 2 +
    2, float32 4 + 4) or, with a master, 8 for it and the weights written,
    plus the clip's 4-byte scale; 15 fp32 operations an element and 2
    more a decayed one."""
    p = _flat(LEAVES, device)
    c = adamw.AdamWConfig(master_fp32=master, **OPT)
    st = adamw.init(p, c)
    g = torch.ones(p.n, device=device)
    _, costs = count(adamw.update, p, g, st, c)
    n = p.n
    bf16 = sum(t.numel() for t in p.tensors if t.dtype == torch.bfloat16)
    f32 = n - bf16
    assert bf16 and f32
    if master:
        nbytes = 20 * n + 8 * n + 2 * bf16 + 4 * f32 + 4
    else:
        nbytes = 20 * n + 4 * bf16 + 8 * f32 + 4
    decayed = 1003 + 2001
    assert costs.kernels == {"adamw_update": {
        "calls": 1, "bytes": nbytes, "ops": 15 * n + 2 * decayed}}
    if not master:
        assert nbytes - 4 == 24 * bf16 + 28 * f32


def test_signatures_name_the_exported_functions():
    text = (_build.CSRC / "adamw.cu").read_text()
    block = text[text.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"^(?:int|const char\*) (\w+)\(([^)]*)\)", block,
                         re.M):
        found[m.group(1)] = len([a for a in m.group(2).split(",")
                                 if a.strip()])
    want = {fn: len(args) for fn, (_, args) in
            _build.SIGNATURES["adamw"].items()}
    assert found == want


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _two_steps(p, c, grads):
    """Two updates of ``p`` from fresh state: the state and the two steps'
    grad norms."""
    st = adamw.init(p, c)
    return st, [adamw.update(p, g.clone(), st, c)["grad_norm"]
                for g in grads]


@pytest.mark.cuda
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("clip", [0.5, 1e9], ids=["clipped", "unclipped"])
def test_kernel_matches_plain_passes_bitwise(cuda, monkeypatch, master,
                                             clip):
    leaves = LEAVES + (BIG,)
    c = adamw.AdamWConfig(master_fp32=master, grad_clip=clip, **OPT)
    got_p, want_p = _flat(leaves, cuda, odd_weight=True), \
        _flat(leaves, cuda, odd_weight=True)
    n = got_p.n
    # lengths and offsets: heads, tails and a weight off the buffers' phase
    assert any(off % 4 for off in got_p.offsets)
    assert got_p.tensors[0].data_ptr() % 8
    grads = [_grads(n, 2, 1e-2, cuda), _grads(n, 3, 1e-2, cuda)]
    kadamw.reset_launches()
    got, got_norms = _two_steps(got_p, c, grads)
    assert kadamw.launches["adamw_update"] == 2 * len(got_p.tensors)
    with monkeypatch.context() as mp:  # the plain passes, on the card
        mp.setattr(kadamw, "adamw_update", ref.adamw_update)
        want, want_norms = _two_steps(want_p, c, grads)
    torch.cuda.synchronize()
    scale = float(adamw.clip_scale(got_norms[0], clip))
    assert (scale < 1) == (clip < 1)
    for a, b in zip(got_norms, want_norms):
        _same(a, b, "grad_norm")
    for key in ("m", "v") + (("master",) if master else ()):
        _same(got[key], want[key], key)
    for i, (a, b) in enumerate(zip(got_p.tensors, want_p.tensors)):
        _same(a, b, f"weight tensor {i}")
    assert len(got_p.tensors) == len(leaves) + 1


@pytest.mark.cuda
def test_update_does_not_synchronize(cuda):
    p = _flat(LEAVES, cuda)
    c = adamw.AdamWConfig(master_fp32=True, grad_clip=0.5, **OPT)
    st = adamw.init(p, c)
    g = _grads(p.n, 4, 1e-2, cuda)
    adamw.update(p, g.clone(), st, c)  # builds the library
    torch.cuda.synchronize()
    kadamw.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        adamw.update(p, g, st, c)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kadamw.launches["adamw_update"] == len(p.tensors)
    torch.cuda.synchronize()
