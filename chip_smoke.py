#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with an NVIDIA Hopper card and the CUDA toolkit. It imports nothing of JAX
or of the JAX package. Three phases; any failure exits non-zero:

1. **Kernels.** Builds ``kernels/csrc/codec_int8.cu`` with nvcc (sm_90a)
   and holds each CUDA kernel against its plain PyTorch version on the
   card, bitwise (tolerance 0): encode at (16, 131072), (3, 1000) and
   (1, 256) with and without the carried error; decode-reduce over W in
   {1, 2, 8}. Times each kernel and its plain version at the main path's
   shapes (median of 20 runs, CUDA events around device work only, L2
   flushed between runs).
2. **Slice.** Two steps of the full-width smollm-360m gradient sync:
   409,007,040 float32 gradients per rank on ``RankGrid(2, 4, "cuda")``,
   4 MiB buckets (391), one persistent ``pip_mcoll`` + ``int8_block``
   carry op per bucket with error feedback (``OverlappedGradSync``).
   Every bucket's sum must lie within ``collective_tolerance("int8_block",
   "allreduce", 8, A)`` of the float64 sum of the collective's input rows
   (gradient plus carried error; ``A`` their max-abs). Kernel launch
   counts are zeroed just before the steps and must equal 2 encodes and 1
   decode-reduce per bucket per step. Then one lossless ``algo="auto"``
   bucket sync must match the float64 sum within the float32 summation
   bound ``8 * 2**-23 * sum|x|`` per element.
3. **Report.** A slice summary line, the card's name and power limit (as
   nvidia-smi gives them), the ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
STEPS = 2
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: modeled fp32 operations per element: encode (add, abs, max, mul, div,
#: rint, 2 clips, fma) and one fma per peer in decode-reduce
ENCODE_OPS_PER_ELEM = 9
DECODE_OPS_PER_ELEM_PEER = 2
#: clock cycles of the spin kernel queued ahead of each timed run (about
#: 2 ms at the H100's 1.98 GHz boost clock)
SPIN_CYCLES = 4_000_000


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(torch, fn, flush, n: int = 20) -> float:
    """Median device time of ``fn`` over ``n`` runs, between two CUDA
    events, with the L2 cache flushed before each run.

    A spin kernel is queued ahead of the flush and the first event, so the
    host has queued all of ``fn``'s launches before the device reaches
    them: the events then bracket device work, not the host's dispatch.
    Raises if the host took longer to queue a run than the spin lasts."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(SPIN_CYCLES)
    b.record()
    b.synchronize()
    spin_ms = a.elapsed_time(b)
    times = []
    for _ in range(n):
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        flush.zero_()
        a.record()
        fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if host_ms > spin_ms / 2:
            raise RuntimeError(f"timing: the host queued a run in {host_ms} "
                               f"ms, the spin covers {spin_ms} ms")
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_diff(torch, got, want) -> float:
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def kernel_phase(torch, kcodec, ref, dev):
    """Each kernel against its plain version; returns per-kernel records
    (without launches) and raises on any mismatch."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err_enc = err_dec = 0.0
    for S, L in ((16, 131072), (3, 1000), (1, 256)):
        x = torch.randn((S, L), generator=gen, device=dev) \
            * torch.rand((S, 1), generator=gen, device=dev) * 100
        e = torch.randn((S, L), generator=gen, device=dev) * 0.01
        for got, want in ((kcodec.int8_encode_residual(x),
                           ref.int8_encode_residual(x)),
                          (kcodec.int8_encode_feedback(x, e),
                           ref.int8_encode_feedback(x, e))):
            torch.cuda.synchronize()
            for a, b in ((got[0]["q"], want[0]["q"]),
                         (got[0]["scale"], want[0]["scale"]),
                         (got[1], want[1])):
                if not torch.equal(a, b):
                    raise AssertionError(f"encode {S}x{L} differs from its "
                                         f"plain version: max "
                                         f"{max_diff(torch, a, b)}")
                err_enc = max(err_enc, max_diff(torch, a, b))
    for R, W, L in ((8, 1, 131072), (8, 2, 131072), (8, 8, 131072),
                    (1, 2, 1000)):
        x = torch.randn((R, W, L), generator=gen, device=dev)
        comp, _ = ref.int8_encode_residual(x)
        got = kcodec.int8_decode_reduce(comp, L)
        want = ref.int8_decode_reduce(comp, L)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"decode_reduce R={R} W={W} L={L} differs "
                                 f"from its plain version: max "
                                 f"{max_diff(torch, got, want)}")
        err_dec = max(err_dec, max_diff(torch, got, want))

    # times at the main path's shapes: the first encode of each bucket is
    # (ranks * W, Ls) = (16, 131072); decode-reduce is (8, 2, 512, 256)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    S, L = 16, 131072
    x = torch.randn((S, L), generator=gen, device=dev)
    e = torch.randn((S, L), generator=gen, device=dev) * 0.01
    nb = L // 256
    enc_bytes = 4 * S * L + S * L + 4 * S * nb + 4 * S * L
    enc_b, enc_by = bound_ms(enc_bytes, ENCODE_OPS_PER_ELEM * S * L)
    # the HAS_ERR variant (not on the main path) also reads the error
    fb_b, _ = bound_ms(enc_bytes + 4 * S * L, ENCODE_OPS_PER_ELEM * S * L)
    R, W = 8, 2
    comp, _ = ref.int8_encode_residual(
        torch.randn((R, W, L), generator=gen, device=dev))
    dec_bytes = R * W * L + 4 * R * W * nb + 4 * R * L
    dec_b, dec_by = bound_ms(dec_bytes,
                             DECODE_OPS_PER_ELEM_PEER * R * W * L)
    return {
        "int8_block_encode": {
            "name": "int8_block_encode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/codec_int8.cu",
            "replaces": "src/repro/kernels/codec.py:104",
            "max_abs_err": err_enc,
            "ms": time_ms(torch, lambda: kcodec.int8_encode_residual(x),
                          flush),
            "plain_ms": time_ms(torch, lambda: ref.int8_encode_residual(x),
                                flush),
            "bound_ms": enc_b, "bound_by": enc_by, "library_ms": None,
            "bytes": enc_bytes, "shape": [S, L],
            "feedback_ms": time_ms(
                torch, lambda: kcodec.int8_encode_feedback(x, e), flush),
            "feedback_plain_ms": time_ms(
                torch, lambda: ref.int8_encode_feedback(x, e), flush),
            "feedback_bound_ms": fb_b},
        "int8_decode_reduce": {
            "name": "int8_decode_reduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/codec_int8.cu",
            "replaces": "src/repro/kernels/codec.py:151",
            "max_abs_err": err_dec,
            "ms": time_ms(torch, lambda: kcodec.int8_decode_reduce(comp, L),
                          flush),
            "plain_ms": time_ms(torch,
                                lambda: ref.int8_decode_reduce(comp, L),
                                flush),
            "bound_ms": dec_b, "bound_by": dec_by, "library_ms": None,
            "bytes": dec_bytes, "shape": [R, W, nb, 256]},
    }


def profile_step(torch, gs, buckets, mvec, step, top: int = 12):
    """One more sync step under ``torch.profiler``: device time per kernel
    (CUPTI), its sum, the wall time of the same step and the device's idle
    share of it. The sync itself runs outside any ``except``; only the
    profiler's own calls may end in "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    try:
        prof.start()
    except RuntimeError as e:
        prof, reason = None, repr(e)
    t0 = time.perf_counter()
    gs.ensure_ops(step)
    gs.sync(buckets, mvec)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if prof is None:
        return {"device_busy_ms": "not measured", "step_ms": wall_ms,
                "reason": reason}
    try:
        prof.stop()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    except (RuntimeError, AttributeError) as e:
        return {"device_busy_ms": "not measured", "step_ms": wall_ms,
                "reason": repr(e)}
    busy = sum(ms for _, ms, _ in rows)
    if not busy:
        return {"device_busy_ms": "not measured", "step_ms": wall_ms,
                "reason": "profiler recorded no device time"}
    if busy > wall_ms:
        raise AssertionError(f"profiled step: device busy {busy} ms exceeds "
                             f"its wall time {wall_ms} ms")
    per_launch = {}
    for name in ("int8_block_encode", "int8_decode_reduce"):
        ms = sum(r[1] for r in rows if name in r[0])
        n = sum(r[2] for r in rows if name in r[0])
        per_launch[name] = ms / n if n else "not measured"
    rows.sort(key=lambda r: -r[1])
    return {"device_busy_ms": busy, "step_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms,
            "per_launch_ms": per_launch,
            "kernels": [{"name": k[:90], "ms": ms, "count": n}
                        for k, ms, n in rows[:top]]}


def slice_phase(torch, dev, cfg, steps: int = STEPS):
    """The main path on the card: ``steps`` compressed gradient-sync steps
    of ``cfg`` at full width, checked bucket by bucket. Returns a summary
    dict."""
    from repro_torch.core import compress
    from repro_torch.core.autotune import encode_plan
    from repro_torch.core.comm import Communicator
    from repro_torch.core.grid import RankGrid
    from repro_torch.kernels import codec as kcodec
    from repro_torch.models.params import leaf_views, param_shapes
    from repro_torch.train import manual_step as ms

    bucket_bytes = ms.DEFAULT_BUCKET_BYTES
    shapes = param_shapes(cfg)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    if total != cfg.n_params():
        raise AssertionError(f"layout has {total} params, config "
                             f"{cfg.n_params()}")
    grid = RankGrid(2, 4, dev)
    comm = Communicator(grid)
    world = grid.world
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    grads = torch.empty((world, total), dtype=torch.float32, device=dev)
    leaves = leaf_views(grads, shapes)  # the tree: views, no copies
    slices = ms.bucket_slices(total, bucket_bytes // 4)
    buckets = [grads[:, s:s + n] for s, n in slices]
    codec = "int8_block"
    gs = ms.OverlappedGradSync(comm, slices, metric_len=4, algo="pip_mcoll",
                               codec=codec,
                               error_budget=compress.meta(codec).error_bound)
    mvec = torch.arange(world * 4, dtype=torch.float32,
                        device=dev).reshape(world, 4)

    gs.ensure_ops(0)  # init: resolve the plans, allocate buffers and state
    kcodec.reset_launches()
    step_s, worst = [], 0.0
    for step in range(steps):
        grads.normal_(0.0, 1e-2, generator=gen)
        # what each bucket's allreduce must approximate: the float64 sum of
        # its input rows (gradient + carried error, added in float32 as the
        # collective does), and that input's max-abs for the tolerance
        want, amax = [], []
        for b, e in zip(buckets, gs.errs):
            g = b if e is None else b + e
            want.append(g.double().sum(0))
            amax.append(float(g.abs().max()))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        gs.ensure_ops(step)
        synced, msum = gs.sync(buckets, mvec)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        for i, (y, w, a) in enumerate(zip(synced, want, amax)):
            tol = compress.collective_tolerance(codec, "allreduce", world, a)
            got = float((y.double() - w).abs().max())
            if not torch.isfinite(y).all() or got > tol:
                raise AssertionError(f"step {step} bucket {i}: max error "
                                     f"{got} > tolerance {tol}")
            worst = max(worst, got / tol)
        if not torch.equal(msum, mvec.sum(0, keepdim=True).expand_as(mvec)):
            raise AssertionError("metric allreduce is not exact")
    launches = dict(kcodec.launches)
    want_launches = {"int8_block_encode": 2 * steps * len(slices),
                     "int8_decode_reduce": steps * len(slices)}
    if launches != want_launches:
        raise AssertionError(f"kernel launches {launches} on the main "
                             f"path, expected {want_launches}")

    profile = profile_step(torch, gs, buckets, mvec, steps)

    # one lossless bucket through algo="auto"
    b = buckets[0]
    plan = comm.plan("allreduce", b[0].numel() * 4)
    y = comm.allreduce(b, algo="auto")
    exact = b.double().sum(0)
    bound = 8 * 2.0 ** -23 * b.double().abs().sum(0)
    if not bool(((y.double() - exact).abs() <= bound).all()):
        raise AssertionError("lossless auto allreduce outside the float32 "
                             "summation bound")
    return {
        "model": cfg.name, "grid": [grid.n_nodes, grid.n_local],
        "params_per_rank": total, "leaves": len(leaves),
        "buckets": len(slices), "bucket_bytes": bucket_bytes,
        "plan": gs.plans()[0], "steps": steps,
        "step_s": step_s, "worst_err_over_tol": worst,
        "launches": launches,
        "auto_plan": encode_plan(plan.algo, plan.chunks, plan.codec),
        "profile": profile,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke test "
                    "runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs.smollm_360m import CONFIG
        from repro_torch.kernels import _build, ref
        from repro_torch.kernels import codec as kcodec
    except ImportError as e:
        return fail(f"the port's sources are missing ({e}); run from the "
                    f"repository root")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    lib = _build.build("codec_int8")
    print(f"built {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    kernels = kernel_phase(torch, kcodec, ref, dev)
    print("kernel phase: both kernels bitwise equal to their plain "
          "versions")
    summary = slice_phase(torch, dev, CONFIG)
    per_launch = summary["profile"].get("per_launch_ms", {})
    for name, rec in kernels.items():
        rec["launches"] = summary["launches"][name]
        rec["path_ms"] = per_launch.get(name, "not measured")
    print(json.dumps({"slice": summary}))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
