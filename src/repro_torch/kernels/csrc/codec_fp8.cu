// Hand-written Hopper (sm_90a) kernels for the fp8_sim codec of the
// compressed collectives.
//
// fp8_amax<HAS_ERR> + fp8_encode<HAS_ERR> replace the Pallas kernels behind
//   repro/kernels/codec.py fp8_encode_feedback (HAS_ERR = true) and
//   fp8_encode_residual (HAS_ERR = false), both launched through
//   _fp8_encode_call's pl.pallas_call (codec.py:275).
// fp8_decode_reduce replaces repro/kernels/codec.py fp8_decode_reduce
//   (its pl.pallas_call at codec.py:314).
//
// Bound: streaming passes with a few operations per byte, so the card's
// memory rate bounds them. The fp8 scale belongs to a whole slice (a row of
// up to 131072 elements on the main path), not to a 256-element block; the
// Pallas kernel took one slice per grid step, which on this card would be
// one CTA per row: 16 of the 132 SMs busy. The encode is therefore two
// launches over the whole card:
//   1. fp8_amax: 4096-element chunks, one CTA each; the warp-shuffle and
//      shared-memory max of |c| goes to a per-slice word by one atomicMax
//      on its uint32 bits. Bits of non-negative floats order like their
//      values, and every NaN's bits (sign cleared by fabsf) sort above
//      +inf's, so a NaN anywhere in the slice wins: NaN propagates.
//   2. fp8_encode: one thread per element reads the slice's amax, forms the
//      scale, casts and writes the byte and the residual.
// Both passes form c = x + err the same way (one __fadd_rn), so the second
// pass reads the input again (4 or 8 bytes per element) rather than keeping
// c anywhere: the amax needs the whole slice before any element can be
// scaled. Decode has no cross-block carry: one thread owns one output
// element and loops over the W peers itself, in order, from 0.0f.
//
// Rounding contract (kept bitwise with kernels/ref.py and with the
// reference's jitted XLA): scale = max(amax * float32(1/448), 1e-30), v =
// c / scale (IEEE division) clipped to +-448, the e4m3 cast rounding to
// nearest even (__nv_cvt_float_to_fp8 with __NV_SATFINITE, as torch's
// float8_e4m3fn cast; subnormal e4m3 values included), and both
// c - f8*scale and acc + f8*scale as explicit single-rounding fused
// multiply-adds; fp8 -> half -> float decoding is exact. The library is
// built with -fmad=false so the compiler contracts nothing else.
//
// NaN: a slice holding a NaN gets a NaN scale, every element of it a NaN
// byte and a NaN residual; its decoded sums are NaN.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr long long CHUNK = THREADS * PER_THREAD;  // amax pass, per CTA
constexpr float RECIP448 = 0x1.24924ap-9f;         // float32(1/448)
constexpr float FP8_TINY = 1e-30f;
constexpr float FP8_MAX = 448.f;

template <bool HAS_ERR>
__device__ __forceinline__ float corrected(const float* __restrict__ x,
                                           const float* __restrict__ err,
                                           long long at) {
  return HAS_ERR ? __fadd_rn(x[at], err[at]) : x[at];
}

__device__ __forceinline__ float fp8_to_float(__nv_fp8_storage_t b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

// One CTA per CHUNK columns of one slice; amax_bits (S,) starts at 0.
template <bool HAS_ERR>
__global__ void __launch_bounds__(THREADS)
fp8_amax(const float* __restrict__ x, const float* __restrict__ err,
         unsigned int* __restrict__ amax_bits, long long L,
         long long chunks) {
  __shared__ unsigned int warp_max[THREADS / 32];
  const long long blk = blockIdx.x;
  const long long s = blk / chunks;
  const long long c0 = (blk - s * chunks) * CHUNK;
  unsigned int m = 0u;
#pragma unroll 4
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long col = c0 + k * THREADS + threadIdx.x;
    if (col < L) m = max(m, __float_as_uint(
        fabsf(corrected<HAS_ERR>(x, err, s * L + col))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(amax_bits + s, m);
  }
}

// One thread per element of (S, L): q (S, L) uint8, scale (S,), res (S, L).
template <bool HAS_ERR>
__global__ void __launch_bounds__(THREADS)
fp8_encode(const float* __restrict__ x, const float* __restrict__ err,
           const unsigned int* __restrict__ amax_bits,
           uint8_t* __restrict__ q, float* __restrict__ scale,
           float* __restrict__ res, long long L, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= total) return;
  const long long s = i / L;
  const float amax = __uint_as_float(amax_bits[s]);
  float sc = __fmul_rn(amax, RECIP448);
  sc = (sc != sc) ? sc : fmaxf(sc, FP8_TINY);
  if (i == s * L) scale[s] = sc;
  const float c = corrected<HAS_ERR>(x, err, i);
  float v = __fdiv_rn(c, sc);
  v = (v != v) ? v : fminf(fmaxf(v, -FP8_MAX), FP8_MAX);
  const __nv_fp8_storage_t f8 =
      __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  q[i] = f8;
  res[i] = __fmaf_rn(-fp8_to_float(f8), sc, c);
}

// One thread per output element of (R, L): out[r, e] = sum over w of
// e4m3(q[r, w, e]) * scale[r, w], in order w = 0..W-1 from 0.0f. q is
// (R, W, Lq) uint8 with Lq >= L, scale (R, W).
__global__ void __launch_bounds__(THREADS)
fp8_decode_reduce(const uint8_t* __restrict__ q,
                  const float* __restrict__ scale, float* __restrict__ out,
                  long long W, long long Lq, long long L, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= total) return;
  const long long r = t / L;
  const long long e = t - r * L;
  float acc = 0.f;
  for (long long w = 0; w < W; ++w) {
    const long long rw = r * W + w;
    acc = __fmaf_rn(fp8_to_float(q[rw * Lq + e]), scale[rw], acc);
  }
  out[t] = acc;
}

int grid_of(long long total, unsigned* blocks) {
  const long long b = (total + THREADS - 1) / THREADS;
  if (b > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return 0;
}

}  // namespace

extern "C" {

// Launch the two-pass encode on `stream` over S slices of length L > 0:
// zero the (S,) amax scratch, the amax pass, the element pass. err ==
// nullptr selects the residual-only variant. Returns the first CUDA error
// (0 = success).
int codec_fp8_encode(const float* x, const float* err, unsigned int* amax,
                     uint8_t* q, float* scale, float* res, long long S,
                     long long L, void* stream) {
  if (S <= 0 || L <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = (L + CHUNK - 1) / CHUNK;
  if (S * chunks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  int rc = grid_of(S * L, &blocks);
  if (rc) return rc;
  rc = static_cast<int>(cudaMemsetAsync(amax, 0, S * sizeof(unsigned), st));
  if (rc) return rc;
  const unsigned amax_blocks = static_cast<unsigned>(S * chunks);
  if (err != nullptr) {
    fp8_amax<true><<<amax_blocks, THREADS, 0, st>>>(x, err, amax, L, chunks);
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    fp8_encode<true><<<blocks, THREADS, 0, st>>>(x, err, amax, q, scale, res,
                                                 L, S * L);
  } else {
    fp8_amax<false><<<amax_blocks, THREADS, 0, st>>>(x, nullptr, amax, L,
                                                     chunks);
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    fp8_encode<false><<<blocks, THREADS, 0, st>>>(x, nullptr, amax, q, scale,
                                                  res, L, S * L);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the decode-reduce on `stream`: R rank batches of W peers, wire
// rows of Lq bytes, L output columns (L <= Lq).
int codec_fp8_decode_reduce(const uint8_t* q, const float* scale, float* out,
                            long long R, long long W, long long Lq,
                            long long L, void* stream) {
  const long long total = R * L;
  if (total <= 0) return 0;
  unsigned blocks = 0;
  const int rc = grid_of(total, &blocks);
  if (rc) return rc;
  fp8_decode_reduce<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      q, scale, out, W, Lq, L, total);
  return static_cast<int>(cudaGetLastError());
}

const char* codec_fp8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
