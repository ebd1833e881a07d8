// Hand-written Hopper (sm_90a) kernels for the int4_block codec of the
// compressed collectives.
//
// int4_block_encode<HAS_ERR> replaces the Pallas kernels behind
//   repro/kernels/codec.py int4_encode_feedback (HAS_ERR = true) and
//   int4_encode_residual (HAS_ERR = false), both launched through
//   _block_encode_call's pl.pallas_call (codec.py:104).
// int4_decode_reduce replaces repro/kernels/codec.py int4_decode_reduce
//   (its pl.pallas_call at codec.py:226).
//
// Bound: streaming passes with a few operations per byte, so the card's
// memory rate bounds them (encode reads 4 or 8 bytes and writes 4.5 bytes
// per element plus a scale per 256; decode reads half a byte per peer and
// element and writes 4). The Pallas grid walked one 256-element block per
// step, in order; here every block is independent: one CUDA block of 128
// threads owns one quantization block, each thread two neighbouring
// elements (one float2 load when the row allows it), which is exactly one
// packed wire byte. The amax is a warp-shuffle reduction plus one pass over
// four shared-memory words. Decode has no cross-block carry: one thread
// owns one wire byte (two outputs) and loops over the W peers itself, in
// order, starting from 0.0f: no atomics, no second pass.
//
// Rounding contract (kept bitwise with kernels/ref.py and with the
// reference's jitted XLA): scale = amax * float32(1/7), q =
// rint(c / max(scale, 1e-12)) clipped to +-7 (round half to even), packed
// as q + 8 with the even element in the low nibble, and both c - q*scale
// and acc + q*scale as explicit single-rounding fused multiply-adds. The
// library is built with -fmad=false so the compiler contracts nothing else.
//
// NaN: the amax propagates NaN, so a block holding a NaN gets a NaN scale
// and NaN residuals, and its nibbles are written as q = -7 (fmaxf drops the
// NaN in the clip); its decoded sums are NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int HALF = BLOCK / 2;           // threads per quantization block
constexpr float RECIP7 = 0x1.24924ap-3f;  // float32(1/7)
constexpr float TINY = 1e-12f;

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float quantize(float c, float d) {
  return fminf(fmaxf(rintf(__fdiv_rn(c, d)), -7.f), 7.f);
}

// One block of 128 threads per (slice, 256-element block); thread t owns
// columns 2t and 2t+1 of the block. x, err, res are (S, L) row-major; q is
// (S, nb, 128); scale is (S, nb). Columns past L are zero padding: they
// enter the amax as 0 and store nibble 8 (q = 0), no residual. `vec`: the
// rows allow 8-byte float2 loads (L even, bases 8-byte aligned).
template <bool HAS_ERR>
__global__ void __launch_bounds__(HALF)
int4_block_encode(const float* __restrict__ x, const float* __restrict__ err,
                  uint8_t* __restrict__ q, float* __restrict__ scale,
                  float* __restrict__ res, long long L, long long nb,
                  bool vec) {
  __shared__ float warp_max[HALF / 32];
  const long long blk = blockIdx.x;
  const long long s = blk / nb;
  const long long col = (blk - s * nb) * BLOCK + 2 * threadIdx.x;
  const long long at = s * L + col;
  const bool in0 = col < L;
  const bool in1 = col + 1 < L;

  float c0 = 0.f, c1 = 0.f;
  if (vec && in1) {
    const float2 v = *reinterpret_cast<const float2*>(x + at);
    c0 = v.x;
    c1 = v.y;
    if (HAS_ERR) {
      const float2 e = *reinterpret_cast<const float2*>(err + at);
      c0 = __fadd_rn(c0, e.x);
      c1 = __fadd_rn(c1, e.y);
    }
  } else {
    if (in0) c0 = HAS_ERR ? __fadd_rn(x[at], err[at]) : x[at];
    if (in1) c1 = HAS_ERR ? __fadd_rn(x[at + 1], err[at + 1]) : x[at + 1];
  }
  float m = nanmax(fabsf(c0), fabsf(c1));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < HALF / 32; ++w) amax = nanmax(amax, warp_max[w]);

  const float sc = __fmul_rn(amax, RECIP7);
  const float d = (sc != sc) ? sc : fmaxf(sc, TINY);
  const float q0 = quantize(c0, d);
  const float q1 = quantize(c1, d);
  q[blk * HALF + threadIdx.x] = static_cast<uint8_t>(
      (static_cast<int>(q0) + 8) | ((static_cast<int>(q1) + 8) << 4));
  if (threadIdx.x == 0) scale[blk] = sc;
  if (in0) res[at] = __fmaf_rn(-q0, sc, c0);
  if (in1) res[at + 1] = __fmaf_rn(-q1, sc, c1);
}

// One thread per wire byte i of each rank batch r: out[r, 2i] and
// out[r, 2i+1] = sum over w of the low and high nibble (minus 8) times
// scale[r, w, i / 128], in order w = 0..W-1 from 0.0f. q is
// (R, W, nb, 128) uint8, scale (R, W, nb), out (R, L).
__global__ void __launch_bounds__(256)
int4_decode_reduce(const uint8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   long long W, long long nb, long long L, long long pairs,
                   long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= total) return;
  const long long r = t / pairs;
  const long long i = t - r * pairs;
  const long long b = i / HALF;
  const long long per = nb * HALF;
  float acc0 = 0.f, acc1 = 0.f;
  for (long long w = 0; w < W; ++w) {
    const long long rw = r * W + w;
    const int byte = q[rw * per + i];
    const float sc = scale[rw * nb + b];
    acc0 = __fmaf_rn(static_cast<float>((byte & 0xF) - 8), sc, acc0);
    acc1 = __fmaf_rn(static_cast<float>((byte >> 4) - 8), sc, acc1);
  }
  const long long e = 2 * i;
  out[r * L + e] = acc0;
  if (e + 1 < L) out[r * L + e + 1] = acc1;
}

}  // namespace

extern "C" {

// Launch the encode on `stream` over S slices of length L (nb blocks each);
// err == nullptr selects the residual-only variant. Returns the CUDA error
// code of the launch (0 = success).
int codec_int4_encode(const float* x, const float* err, uint8_t* q,
                      float* scale, float* res, long long S, long long L,
                      long long nb, void* stream) {
  const long long blocks = S * nb;
  if (blocks <= 0) return 0;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (L % 2 == 0)
      && (reinterpret_cast<uintptr_t>(x) % 8 == 0)
      && (err == nullptr || reinterpret_cast<uintptr_t>(err) % 8 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (err != nullptr) {
    int4_block_encode<true><<<static_cast<unsigned>(blocks), HALF, 0, st>>>(
        x, err, q, scale, res, L, nb, vec);
  } else {
    int4_block_encode<false><<<static_cast<unsigned>(blocks), HALF, 0, st>>>(
        x, nullptr, q, scale, res, L, nb, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the decode-reduce on `stream`: R rank batches of W peers, nb blocks
// per peer slice, L output columns (L <= nb * 256).
int codec_int4_decode_reduce(const uint8_t* q, const float* scale,
                             float* out, long long R, long long W,
                             long long nb, long long L, void* stream) {
  const long long pairs = (L + 1) / 2;
  const long long total = R * pairs;
  if (total <= 0) return 0;
  const long long blocks = (total + 255) / 256;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int4_decode_reduce<<<static_cast<unsigned>(blocks), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      q, scale, out, W, nb, L, pairs, total);
  return static_cast<int>(cudaGetLastError());
}

const char* codec_int4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
