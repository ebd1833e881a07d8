"""Launch-shape sweep of the fp8, int8 and int4 encode kernels on one card:

    python3 scripts/encode_sweep.py

Builds three small libraries that include ``kernels/csrc/codec_fp8.cu``,
``codec_int8.cu`` and ``codec_int4.cu`` as they are and launch their
encode kernels with a chosen shape: fp8 at cluster sizes 4, 8 and 16 (the
float4 a thread and the second walk following from the size, as the
launcher's plan does; 16 is non-portable, allowed here), int8 and int4 at
4, 8 and 16 warps a CTA at the card's full occupancy, and at 4 warps on
a half and a quarter of it (each warp then walks 2 or 4 times as many
blocks). Each launch shape's output is held bitwise to the wrapper's,
then timed alone by CUPTI with L2 flushed (``chip_smoke.cupti_ms``) at
the main path's (16, 131072) and (8, 131072), residual and feedback.
Last, the int8 and int4 wrappers at (1, 256), one warp and one block:
what a launch costs whatever its size. Prints the card's name and power
limit and one ``sweep`` line a shape. Needs one CUDA card.
"""
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

FP8 = r'''
#include "%s/codec_fp8.cu"
extern "C" int sweep_fp8(const float* x, const float* err, uint8_t* q,
                         float* scale, float* res, long long S, long long L,
                         int C, void* stream, int* n) {
  const long long per_vec = 4LL * ENC_THREADS, per_cta = (L + C - 1) / C;
  int nv = 1;
  while (nv < ENC_NV && nv * per_vec < per_cta) nv *= 2;
  const bool walk = nv * per_vec < per_cta;
  EncodeKernel k = pick_encode(err != nullptr, true, nv, walk);
  int rc = cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc) return rc;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(S * C, C, &attr);
  rc = cudaOccupancyMaxActiveClusters(n, k, &cfg);
  if (rc) return rc;
  cfg.stream = static_cast<cudaStream_t>(stream);
  rc = cudaLaunchKernelEx(&cfg, k, x, err, q, scale, res, L, C);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
#define SHAPE(T, V) \
  if (threads == T && nv == V) \
    k = err ? fp8_encode<true, true, V, false, T> \
            : fp8_encode<false, true, V, false, T>;
extern "C" int sweep_fp8_shape(const float* x, const float* err, uint8_t* q,
                               float* scale, float* res, long long S,
                               long long L, int threads, int nv, int C,
                               void* stream, int* n) {
  EncodeKernel k = nullptr;
  SHAPE(512, 8) SHAPE(512, 10) SHAPE(512, 11) SHAPE(512, 5)
  SHAPE(1024, 2) SHAPE(1024, 3) SHAPE(1024, 4) SHAPE(1024, 5) SHAPE(1024, 6)
  if (!k || 4LL * threads * nv * C < L)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc) return rc;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(S * C, C, &attr, threads);
  rc = cudaOccupancyMaxActiveClusters(n, k, &cfg);
  if (rc) return rc;
  cfg.stream = static_cast<cudaStream_t>(stream);
  rc = cudaLaunchKernelEx(&cfg, k, x, err, q, scale, res, L, C);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
'''
#: (S, threads a CTA, float4 a thread, cluster size) of the fp8 launch
#: shapes: clusters of 6 and 7 (one CTA an SM fits 16 of them, where only
#: 15 clusters of 8 fit) and of 11-16 at S = 8
FP8_SHAPES = ((16, 512, 8, 8), (16, 1024, 4, 8), (16, 1024, 5, 7),
              (16, 1024, 6, 6), (16, 512, 10, 7), (16, 512, 11, 6),
              (8, 512, 8, 8), (8, 1024, 2, 16), (8, 1024, 3, 11),
              (8, 1024, 3, 12), (8, 512, 5, 13), (8, 1024, 4, 8))

#: a block codec's encode at WARPS warps a CTA (CODEC int8 or int4, WIRE
#: its wire's element type), its grid sized as the launcher sizes it, then
#: divided by `div`
BLOCK_SWEEP = r'''
#include "CSRC/codec_CODEC.cu"
template <int W>
int sweep_w(const float* x, const float* err, WIRE* q, float* scale,
            float* res, long long S, long long L, long long nb,
            int div, cudaStream_t st, int* fits) {
  auto k = err ? CODEC_block_encode<true, true, W>
               : CODEC_block_encode<false, true, W>;
  int sms = 0, dev = 0, rc = cudaGetDevice(&dev);
  if (!rc) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
  if (!rc) rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(fits, k,
                                                              32 * W, 0);
  if (rc) return rc;
  const long long need = (S * nb + W - 1) / W;
  long long ctas = static_cast<long long>(sms) * *fits / div;
  if (ctas > need) ctas = need;
  if (ctas < 1) ctas = 1;
  k<<<static_cast<unsigned>(ctas), 32 * W, 0, st>>>(x, err, q, scale, res,
                                                   L, nb, S * nb);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int sweep_CODEC(const float* x, const float* err, WIRE* q,
                           float* scale, float* res, long long S,
                           long long L, long long nb, int warps, int div,
                           void* stream, int* fits) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (warps) {
    case 4: return sweep_w<4>(x, err, q, scale, res, S, L, nb, div, st, fits);
    case 8: return sweep_w<8>(x, err, q, scale, res, S, L, nb, div, st, fits);
    case 16:
      return sweep_w<16>(x, err, q, scale, res, S, L, nb, div, st, fits);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
'''
#: the block codecs swept: (wire element type in C, in torch, wire bytes a
#: 256-element block)
BLOCK_CODECS = {"int8": ("int8_t", "int8", 256),
                "int4": ("uint8_t", "uint8", 128)}


def build(tmp, name, source):
    from repro_torch.kernels import _build
    cu = tmp / f"{name}.cu"
    cu.write_text(source)
    so = tmp / f"lib{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-4000:])
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):  # ptxas: each encode's registers
        if "Compiling entry" in line and "encode" in line:
            regs = next((x for x in lines[i + 1:i + 4] if "registers" in x),
                        "")
            print(f"ptxas {line.split()[-3]}: {regs.strip()}")
    return ctypes.CDLL(str(so))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import codec
    if not torch.cuda.is_available():
        return cs.fail("no CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="encode_sweep_"))
    P, I64, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = build(tmp, "sweep_fp8", FP8 % CSRC)
    fp8 = lib.sweep_fp8
    fp8.argtypes = [P] * 5 + [I64, I64, INT, P, ctypes.POINTER(INT)]
    fp8_shape = lib.sweep_fp8_shape
    fp8_shape.argtypes = [P] * 5 + [I64, I64, INT, INT, INT, P,
                                    ctypes.POINTER(INT)]
    blocks = {}
    for c, (wire, _, _) in BLOCK_CODECS.items():
        src = BLOCK_SWEEP.replace("CSRC", str(CSRC)).replace(
            "CODEC", c).replace("WIRE", wire)
        blocks[c] = getattr(build(tmp, f"sweep_{c}", src), f"sweep_{c}")
        blocks[c].argtypes = [P] * 5 + [I64, I64, I64, INT, INT, P,
                                        ctypes.POINTER(INT)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(cs._smi("name,power.limit"))

    def record(kernel, launch, want, q, scale, res, **shape):
        """Runs ``launch`` once, holds its outputs to ``want`` bitwise and
        prints its CUPTI time."""
        launch()
        torch.cuda.synchronize()
        same = all(cs.same_bits(torch, a, b) for a, b in (
            (q, want[0]["q"]), (scale, want[0]["scale"]), (res, want[1])))
        print("sweep " + json.dumps({
            "kernel": kernel, **shape, "bitwise": same,
            "kernel_cupti_ms": cs.cupti_ms(torch, launch, flush, kernel)}))

    L = 131072
    nb = L // 256
    for S, threads, nv, C in FP8_SHAPES:
        x = torch.randn((S, L), generator=gen, device=dev) * 10
        for err in (None, x * 0.01):
            eptr = None if err is None else err.data_ptr()
            want = (codec.fp8_encode_residual(x) if err is None
                    else codec.fp8_encode_feedback(x, err))
            q = torch.empty((S, L), dtype=torch.uint8, device=dev)
            scale = torch.empty(S, device=dev)
            res = torch.empty_like(x)
            n = INT(0)

            def run():
                rc = fp8_shape(x.data_ptr(), eptr, q.data_ptr(),
                               scale.data_ptr(), res.data_ptr(), S, L,
                               threads, nv, C, stream, ctypes.byref(n))
                if rc:
                    raise RuntimeError(f"fp8 {threads}x{nv} C={C}: CUDA "
                                       f"error {rc}")
            record("fp8_encode", run, want, q, scale, res, shape=[S, L],
                   variant="residual" if err is None else "feedback",
                   threads=threads, vectors_per_thread=nv, cluster=C)
            print(f"  max_active_clusters {n.value}")
    for S in (16, 8):
        x = torch.randn((S, L), generator=gen, device=dev) * 10
        e = torch.randn((S, L), generator=gen, device=dev) * 0.1
        for err in (None, e):
            eptr = None if err is None else err.data_ptr()
            variant = "residual" if err is None else "feedback"
            want = (codec.fp8_encode_residual(x) if err is None
                    else codec.fp8_encode_feedback(x, err))
            for C in (4, 8, 16):
                q = torch.empty((S, L), dtype=torch.uint8, device=dev)
                scale = torch.empty(S, device=dev)
                res = torch.empty_like(x)
                n = INT(0)

                def run():
                    rc = fp8(x.data_ptr(), eptr, q.data_ptr(),
                             scale.data_ptr(), res.data_ptr(), S, L, C,
                             stream, ctypes.byref(n))
                    if rc:
                        raise RuntimeError(f"fp8 C={C}: CUDA error {rc}")
                record("fp8_encode", run, want, q, scale, res, shape=[S, L],
                       variant=variant, cluster=C)
                print(f"  max_active_clusters {n.value}")
            for c, (_, dtype, cols) in BLOCK_CODECS.items():
                want = (getattr(codec, f"{c}_encode_residual")(x)
                        if err is None
                        else getattr(codec, f"{c}_encode_feedback")(x, err))
                for warps, div in ((4, 1), (8, 1), (16, 1), (4, 2), (4, 4)):
                    q = torch.empty((S, nb, cols),
                                    dtype=getattr(torch, dtype), device=dev)
                    scale = torch.empty((S, nb), device=dev)
                    res = torch.empty_like(x)
                    fits = INT(0)

                    def run():
                        rc = blocks[c](x.data_ptr(), eptr, q.data_ptr(),
                                       scale.data_ptr(), res.data_ptr(), S,
                                       L, nb, warps, div, stream,
                                       ctypes.byref(fits))
                        if rc:
                            raise RuntimeError(f"{c}: CUDA error {rc}")
                    record(f"{c}_block_encode", run, want, q, scale, res,
                           shape=[S, L], variant=variant, warps=warps,
                           grid_divisor=div)
                    print(f"  ctas_per_sm {fits.value}")
    one = torch.randn((1, 256), generator=gen, device=dev)
    for c in BLOCK_CODECS:
        enc = getattr(codec, f"{c}_encode_residual")
        print("sweep " + json.dumps({
            "kernel": f"{c}_block_encode", "shape": [1, 256],
            "variant": "residual", "kernel_cupti_ms": cs.cupti_ms(
                torch, lambda: enc(one), flush, f"{c}_block_encode")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
