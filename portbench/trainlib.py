"""What the two train drivers share: the program's model built and filled
with the benchmark's weights, the batches, the check steps' readings, the
plain reference's three steps, and the numbers compared.

Correctness (the training rule): set-up builds one step object with its
model and AdamW state, drives it through its first ``CHECK_STEPS`` steps,
each on another batch, through the same call the window makes, and hands
that same object to the window. From those steps it keeps each step's
loss, the norm of each leaf's first gradient as the optimizer took it
(``m / (1 - b1)`` after step 1) and the norm of each leaf's change after
the last. The reference draws the same weights and batches again once the
window has closed and the program's state is freed, and follows the same
steps in float32 (TF32 off). Numbers:

- ``loss_rel``: the largest ``|loss - loss_ref| / |loss_ref|`` of the
  steps;
- ``grad_norm_rel``: over the leaves, the largest gap of the first
  gradient's norms, ``| |g| - |g_ref| |`` over the larger of the
  reference leaf's norm and the median leaf's;
- ``update_norm_rel``: the same for the change of the weights over the
  steps, over the leaves whose reference gradient norm is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by round-off alone);
- ``grad_diff_rel``: over the leaves, the largest ``|g - g_ref| /
  |g_ref|`` of the first gradient on ``SAMPLE`` elements of each leaf
  drawn from the seed: first order in the arithmetic's rounding, where
  the gaps of norms are second order (a cell's limits say which numbers
  it compares).
"""
from __future__ import annotations

import math
import statistics
import sys
from typing import Callable, Dict, List

from portbench import synthetic, weights

CHECK_STEPS = 3
#: distinct batches the window cycles through
N_BATCHES = 8
#: a leaf's reference gradient under this share of the median leaf's does
#: not count in ``update_norm_rel``
STILL_LEAF = 1e-3
#: elements of each leaf's first gradient kept for ``grad_diff_rel``
SAMPLE = 1 << 20


def port_config(cfg: Dict):
    """The program's ``ModelConfig`` for a configuration's ``model``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    moe = cfg.get("moe")
    return ModelConfig(
        name=cfg["arch"], family=cfg["family"], n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_kv_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], vocab=cfg["vocab"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["norm_eps"],
        moe=MoEConfig(**moe) if moe else None)


def build_model(ctx):
    """The program's decoder on the device, holding the benchmark's
    weights drawn from the seed. Returns (model, FlatParams)."""
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.models.params import FlatParams

    model = DecoderLM(port_config(ctx.cfg), device=ctx.device)
    flat = FlatParams.of(model)
    want = [(p, tuple(s)) for p, s, _, _ in weights.layout(ctx.cfg)]
    got = [(p, tuple(flat.shapes[p])) for p, _, _, _ in flat.spans]
    if want != got:
        raise ValueError(f"the program's weight layout {got} is not the "
                         f"benchmark's {want}")
    flat.assign_weights(weights.tree(ctx.cfg, ctx.seed, ctx.device))
    model.trainable()
    return model, flat


def batches(ctx, n: int = N_BATCHES) -> List[Dict]:
    """Batches ``0 .. n-1`` of the mix's synthetic stream, on the device
    as int64."""
    t = ctx.traffic
    data = synthetic.SyntheticLM(ctx.cfg["vocab"], t["seq_len"], t["batch"],
                                 seed=ctx.seed)
    torch = ctx.torch
    return [{k: torch.from_numpy(v).to(ctx.device).long()
             for k, v in data.batch(i).items()} for i in range(n)]


def adamw_config(ctx):
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr=ctx.traffic["lr"], schedule="constant",
                             warmup_steps=0)


#: elements of one piece of a norm taken in pieces
PIECE = 1 << 24


def norm(x, minus=None) -> float:
    """``|x - minus|`` (``|x|`` without it) of flat float32 buffers, summed
    in float64 a piece at a time, so no temporary is larger than a
    piece."""
    x = x.reshape(-1)
    m = None if minus is None else minus.reshape(-1)
    tot = 0.0
    for a in range(0, x.numel(), PIECE):
        d = x[a:a + PIECE].double()
        if m is not None:
            d -= m[a:a + PIECE].double()
        tot += float((d * d).sum())
    return tot ** 0.5


def leaf_norms(flat, buf) -> Dict[str, float]:
    """Each leaf's L2 norm in a flat float32 buffer."""
    return {p: norm(buf[s:e]) for p, s, e, _ in flat.spans}


def change_norms(flat, ctx) -> Dict[str, float]:
    """Each leaf's ``|w - w0|``, ``w0`` drawn again from the seed."""
    torch = ctx.torch
    out = {}
    for i, (p, s, e, _) in enumerate(flat.spans):
        w0 = weights.draw(ctx.cfg, ctx.seed, ctx.device, i,
                          torch.float32).reshape(-1)
        out[p] = sum(norm(flat.read_range(s + a, min(e, s + a + PIECE)),
                          w0[a:a + PIECE]) ** 2
                     for a in range(0, e - s, PIECE)) ** 0.5
        del w0
    return out


def _held(ctx, what: str) -> None:
    """The device memory in use and the peak so far, on standard error."""
    if ctx.device.type == "cuda":
        cuda = ctx.torch.cuda
        print(f"portbench: {what}: {cuda.memory_allocated(ctx.device)} B in "
              f"use, peak {cuda.max_memory_allocated(ctx.device)} B",
              file=sys.stderr)


def free(st, ctx) -> None:
    """Drop the program's state held on ``st`` and give its memory back,
    before the reference runs."""
    import gc
    for k in list(vars(st)):
        if k not in KEEP:
            setattr(st, k, None)
    gc.collect()
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()
        ctx.torch.cuda.reset_peak_memory_stats(ctx.device)
    _held(ctx, "the program's state freed")


#: what ``free`` keeps: the check steps' readings
KEEP = ("losses", "grad_norms", "grad_sample", "change_norms", "next_step",
        "check_steps")


def sample_index(ctx, leaf: int, n: int):
    """The elements of leaf ``leaf`` (``n`` of them) whose first gradient
    ``grad_diff_rel`` compares, drawn from the seed."""
    torch = ctx.torch
    if n <= SAMPLE:
        return torch.arange(n, device=ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(
        (int(ctx.seed) * 0x2545F491 + leaf + 1) % (2 ** 63 - 1))
    return torch.randint(0, n, (SAMPLE,), generator=gen, device=ctx.device)


def check_steps(st, ctx, step: Callable[[int], float]) -> None:
    """The first ``CHECK_STEPS`` steps through ``step(i) -> loss``: the
    losses, the first gradient's leaf norms and the change's, kept on
    ``st``."""
    b1 = adamw_config(ctx).b1
    st.losses = []
    for i in range(CHECK_STEPS):
        st.losses.append(step(i))
        if i == 0:
            m = st.opt["m"]
            st.grad_norms = {p: v / (1.0 - b1) for p, v in
                             leaf_norms(st.flat, m).items()}
            st.grad_sample = {
                p: m[s:e][sample_index(ctx, k, e - s)] / (1.0 - b1)
                for k, (p, s, e, _) in enumerate(st.flat.spans)}
    st.change_norms = change_norms(st.flat, ctx)
    st.next_step = st.check_steps = CHECK_STEPS


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], keep) -> float:
    scale = statistics.median(want.values())
    return max((abs(got[p] - want[p]) / max(want[p], scale, 1e-30)
                for p in want if keep(p)), default=0.0)


def readings(st) -> Dict:
    """What a run's check steps kept, as ``numbers`` takes it."""
    return {"losses": st.losses, "grad_norms": st.grad_norms,
            "grad_sample": st.grad_sample, "change_norms": st.change_norms}


def numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers of a run's readings ``got`` against the
    reference's ``ref`` (both as :func:`readings` gives them)."""
    med = statistics.median(ref["grad_norms"].values())
    moving = lambda p: ref["grad_norms"][p] >= STILL_LEAF * med
    return {
        "loss_rel": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], ref["losses"])),
        "grad_norm_rel": _leaf_gap(got["grad_norms"], ref["grad_norms"],
                                   lambda p: True),
        "update_norm_rel": _leaf_gap(got["change_norms"],
                                     ref["change_norms"], moving),
        "grad_diff_rel": max(
            norm(got["grad_sample"][p], ref["grad_sample"][p])
            / max(norm(ref["grad_sample"][p]), 1e-30)
            for p in ref["grad_sample"]),
    }


def reference_steps(ctx, grads_of, prec=None) -> Dict:
    """The reference's ``CHECK_STEPS`` steps from the seed's weights:
    ``grads_of(wt, batch, prec) -> (loss, {path: float32 gradient})``
    gives one step's loss and the gradient the optimizer takes. Returns
    the readings ``numbers`` compares against."""
    torch = ctx.torch
    from portbench.reference import adamw as ref_adamw
    from portbench.reference import model as ref_model

    ref_model.strict_float32()
    ocfg = adamw_config(ctx)
    opt = ref_adamw.AdamW(ocfg.lr, ocfg.b1, ocfg.b2, ocfg.eps,
                          ocfg.weight_decay, ocfg.grad_clip)
    lay = weights.layout(ctx.cfg)
    store = {p: dt for p, _, _, dt in lay}
    wt = weights.tree(ctx.cfg, ctx.seed, ctx.device, torch.float32)
    data = batches(ctx, CHECK_STEPS)
    losses, grad_norms, sample = [], None, None
    take = {p: sample_index(ctx, k, math.prod(sh))
            for k, (p, sh, _, _) in enumerate(lay)}
    for i in range(CHECK_STEPS):
        loss, g = grads_of(wt, data[i], prec)
        _held(ctx, f"reference step {i}: gradients")
        losses.append(loss)
        with torch.no_grad():
            norms, picked = opt.update(wt, g, store,
                                       take if i == 0 else None)
        _held(ctx, f"reference step {i}: updated")
        if i == 0:
            grad_norms, sample = norms, picked
        del g
    with torch.no_grad():
        change = {}
        for i, (p, _, _, _) in enumerate(lay):
            w0 = weights.draw(ctx.cfg, ctx.seed, ctx.device, i,
                              torch.float32)
            change[p] = norm(wt[p], w0)
            del w0
    return {"losses": losses, "grad_norms": grad_norms,
            "grad_sample": sample, "change_norms": change}


def check(st, ctx, reference_grads) -> Dict[str, float]:
    """A train driver's ``check``: the run's readings kept, the program's
    state freed, then the reference's steps through
    ``reference_grads(ctx)`` and the numbers compared."""
    got = readings(st)
    free(st, ctx)
    return numbers(got, reference_steps(ctx, reference_grads(ctx)))


def control(ctx, reference_grads) -> Dict[str, float]:
    """A train driver's control: the plain reference with every product
    in float8 e4m3 in the program's place, judged against the float32
    reference as :func:`check` judges the program."""
    from portbench.reference import model as ref_model

    low = reference_steps(ctx, reference_grads(ctx), ref_model.Fp8())
    return numbers(low, reference_steps(ctx, reference_grads(ctx)))
