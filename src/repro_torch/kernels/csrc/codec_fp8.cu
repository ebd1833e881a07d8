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
// scaled.
//
// Decode has no cross-block carry. At 1 byte read per peer and 4 written
// per element, one element a thread (a byte load and a scale load per
// peer, each peer's load waiting on the previous multiply-add) is held by
// instructions and latency, not bytes. So one thread makes DEC_V = 8
// consecutive outputs of one row: per peer one 8-byte vector of the wire
// and one scale (the scale is the whole row's), the loads of all W peers
// issued before the first multiply-add (W 1, 2, 4, 8 unrolled; other W in
// unrolled groups of DEC_GROUP peers), the bytes decoded two at a time,
// and two float4 stores. The wire's rows need not be 8-byte aligned (the
// last gradient bucket's rows are 7,800 bytes): where q's address or Lq
// does not allow the vector, the same kernel reads each thread's 8 bytes
// one by one (the element path), still all peers in flight. Each element
// sums its peers in order from 0.0f: no atomics, no second pass.
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

constexpr int DEC_V = 8;         // outputs per thread: 8 wire bytes a peer
constexpr int DEC_THREADS = 128;
constexpr int DEC_GROUP = 8;     // peers in flight at once for other W

// acc[k] += e4m3(byte k of b) * s, k < 8: the bytes decoded in pairs by
// one cvt.rn.f16x2.e4m3x2 each (the low byte to the low half), then to
// float, both exact.
__device__ __forceinline__ void add_fp8x8(uint2 b, float s,
                                          float (&acc)[DEC_V]) {
  const unsigned words[2] = {b.x, b.y};
#pragma unroll
  for (int p = 0; p < DEC_V / 2; ++p) {
    const __nv_fp8x2_storage_t two = static_cast<__nv_fp8x2_storage_t>(
        words[p >> 1] >> (16 * (p & 1)));
    const float2 f = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3)));
    acc[2 * p] = __fmaf_rn(f.x, s, acc[2 * p]);
    acc[2 * p + 1] = __fmaf_rn(f.y, s, acc[2 * p + 1]);
  }
}

// A peer's 8 wire bytes at q: one 8-byte load where VEC_IN (q 8-byte
// aligned, 8 bytes inside the row), else its first n <= 8 bytes one by one
// (the others 0).
template <bool VEC_IN>
__device__ __forceinline__ uint2 load8(const uint8_t* __restrict__ q,
                                       int n) {
  if (VEC_IN) return __ldg(reinterpret_cast<const uint2*>(q));
  unsigned words[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < DEC_V; ++k)
    if (k < n)
      words[k >> 2] |= static_cast<unsigned>(__ldg(q + k)) << (8 * (k & 3));
  return make_uint2(words[0], words[1]);
}

// Adds `count` (<= G) peers to acc, in order: their wire bytes (q + j *
// qstep) and scales (scale[j]) are all loaded first.
template <int G, bool VEC_IN>
__device__ __forceinline__ void add_peers(const uint8_t* __restrict__ q,
                                          const float* __restrict__ scale,
                                          long long qstep, int count, int n,
                                          float (&acc)[DEC_V]) {
  uint2 b[G];
  float s[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < count) {
      b[j] = load8<VEC_IN>(q + j * qstep, n);
      s[j] = __ldg(scale + j);
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < count) add_fp8x8(b[j], s[j], acc);
}

// out[r, e] = sum over w of e4m3(q[r, w, e]) * scale[r, w], in order w =
// 0..W-1 from 0.0f. q is (R, W, Lq) uint8 with Lq >= L, scale (R, W), out
// (R, L). grid (ceil(L / (DEC_V * DEC_THREADS)), min(R, 65535)); thread j
// of a row makes elements DEC_V * j onwards. W_T is W where it is 1, 2, 4
// or 8, else 0 (groups of DEC_GROUP). VEC_IN: q 8-byte aligned and Lq % 8
// == 0, so every thread's 8 bytes of a peer are one aligned vector inside
// its row (else the element path: byte loads, all peers still in flight).
// VEC_OUT: L % 4 == 0 and out 16-byte aligned, so every row of out starts
// 16-byte aligned (float4 stores; scalar ones for the last vector of a row,
// which writes only e < L).
template <int W_T, bool VEC_IN, bool VEC_OUT>
__global__ void __launch_bounds__(DEC_THREADS)
fp8_decode_reduce(const uint8_t* __restrict__ q,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int W, long long Lq, long long L, long long R) {
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * DEC_THREADS + threadIdx.x) *
      DEC_V;
  if (e0 >= L) return;
  const int n = static_cast<int>(min(static_cast<long long>(DEC_V), L - e0));
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const long long rw = r * W;
    const uint8_t* qp = q + rw * Lq + e0;
    const float* sp = scale + rw;
    float acc[DEC_V];
#pragma unroll
    for (int k = 0; k < DEC_V; ++k) acc[k] = 0.f;
    if constexpr (W_T > 0) {
      add_peers<W_T, VEC_IN>(qp, sp, Lq, W_T, n, acc);
    } else {
      for (int w0 = 0; w0 < W; w0 += DEC_GROUP)
        add_peers<DEC_GROUP, VEC_IN>(qp + w0 * Lq, sp + w0, Lq,
                                     min(DEC_GROUP, W - w0), n, acc);
    }
    float* o = out + r * L + e0;
    if (VEC_OUT && n == DEC_V) {
#pragma unroll
      for (int k = 0; k < DEC_V; k += 4)
        *reinterpret_cast<float4*>(o + k) =
            make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < DEC_V; ++k)
        if (k < n) o[k] = acc[k];
    }
  }
}

template <int W_T, bool VEC_IN>
void launch_decode_out(dim3 grid, cudaStream_t st, const uint8_t* q,
                       const float* scale, float* out, int W, long long Lq,
                       long long L, long long R) {
  if (L % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    fp8_decode_reduce<W_T, VEC_IN, true><<<grid, DEC_THREADS, 0, st>>>(
        q, scale, out, W, Lq, L, R);
  else
    fp8_decode_reduce<W_T, VEC_IN, false><<<grid, DEC_THREADS, 0, st>>>(
        q, scale, out, W, Lq, L, R);
}

template <int W_T>
void launch_decode(dim3 grid, cudaStream_t st, const uint8_t* q,
                   const float* scale, float* out, int W, long long Lq,
                   long long L, long long R) {
  if (reinterpret_cast<uintptr_t>(q) % 8 == 0 && Lq % 8 == 0)
    launch_decode_out<W_T, true>(grid, st, q, scale, out, W, Lq, L, R);
  else
    launch_decode_out<W_T, false>(grid, st, q, scale, out, W, Lq, L, R);
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
// rows of Lq bytes, L output columns (L <= Lq); q at any address.
int codec_fp8_decode_reduce(const uint8_t* q, const float* scale, float* out,
                            long long R, long long W, long long Lq,
                            long long L, void* stream) {
  if (R <= 0 || L <= 0) return 0;
  const long long per_cta = static_cast<long long>(DEC_V) * DEC_THREADS;
  const long long blocks = (L + per_cta - 1) / per_cta;
  if (W < 0 || W > 2147483647LL || Lq < L || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(R < 65535 ? R : 65535));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(W);
  switch (w) {
    case 1: launch_decode<1>(grid, st, q, scale, out, w, Lq, L, R); break;
    case 2: launch_decode<2>(grid, st, q, scale, out, w, Lq, L, R); break;
    case 4: launch_decode<4>(grid, st, q, scale, out, w, Lq, L, R); break;
    case 8: launch_decode<8>(grid, st, q, scale, out, w, Lq, L, R); break;
    default: launch_decode<0>(grid, st, q, scale, out, w, Lq, L, R);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* codec_fp8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
