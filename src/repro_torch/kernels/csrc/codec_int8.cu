// Hand-written Hopper (sm_90a) kernels for the int8_block codec of the
// compressed allreduce.
//
// int8_block_encode<HAS_ERR> replaces the Pallas kernels behind
//   repro/kernels/codec.py int8_encode_feedback (HAS_ERR = true) and
//   int8_encode_residual (HAS_ERR = false), both launched through
//   _block_encode_call's pl.pallas_call (codec.py:104).
// int8_decode_reduce replaces repro/kernels/codec.py int8_decode_reduce
//   (its pl.pallas_call at codec.py:151).
//
// Bound: both are streaming passes with a few operations per byte, so the
// card's memory rate bounds them (encode reads 4 or 8 bytes and writes 9
// bytes per element; decode reads ~1 byte per peer and writes 4). The TPU
// grid walked one 256-element block per step, in order; here every block
// is independent, so one CUDA block of 256 threads owns one quantization
// block and the amax is a warp-shuffle reduction plus one shared-memory
// pass, with the element kept in a register from load to store. Decode has
// no cross-block carry: one thread owns one output element and loops over
// the W peers itself, in order, starting from 0.0f, so no atomics and no
// second pass.
//
// Rounding contract (kept bitwise with kernels/ref.py and with the
// reference's jitted XLA): scale = amax * float32(1/127), q =
// rint(c / max(scale, 1e-12)) clipped to +-127 (round half to even), and
// both c - q*scale and acc + q*scale as explicit single-rounding fused
// multiply-adds. The library is built with -fmad=false so the compiler
// contracts nothing else.
//
// NaN: the amax propagates NaN, so a block holding a NaN gets a NaN scale,
// a NaN residual and q = -127 (fmaxf drops the NaN in the clip); its
// decoded sum is NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr float RECIP127 = 0x1.020408p-7f;  // float32(1/127)
constexpr float TINY = 1e-12f;

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

// One block of 256 threads per (slice, 256-element block). x, err, res are
// (S, L) row-major; q is (S, nb, 256); scale is (S, nb). Columns past L are
// zero padding: they enter the amax as 0 and store q = 0, no residual.
template <bool HAS_ERR>
__global__ void __launch_bounds__(BLOCK)
int8_block_encode(const float* __restrict__ x, const float* __restrict__ err,
                  int8_t* __restrict__ q, float* __restrict__ scale,
                  float* __restrict__ res, long long L, long long nb) {
  __shared__ float warp_max[BLOCK / 32];
  const long long blk = blockIdx.x;
  const long long s = blk / nb;
  const long long col = (blk - s * nb) * BLOCK + threadIdx.x;
  const bool in = col < L;
  const long long at = s * L + col;

  float c = 0.f;
  if (in) {
    c = x[at];
    if (HAS_ERR) c = __fadd_rn(c, err[at]);
  }
  float m = fabsf(c);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < BLOCK / 32; ++w) amax = nanmax(amax, warp_max[w]);

  const float sc = __fmul_rn(amax, RECIP127);
  const float d = (sc != sc) ? sc : fmaxf(sc, TINY);
  const float qf = fminf(fmaxf(rintf(__fdiv_rn(c, d)), -127.f), 127.f);
  q[blk * BLOCK + threadIdx.x] = static_cast<int8_t>(qf);
  if (threadIdx.x == 0) scale[blk] = sc;
  if (in) res[at] = __fmaf_rn(-qf, sc, c);
}

// One thread per output element of (R, L): out[r, e] = sum over w of
// q[r, w, e] * scale[r, w, e / 256], in order w = 0..W-1 from 0.0f.
// q is (R, W, nb, 256) int8, scale (R, W, nb).
__global__ void __launch_bounds__(256)
int8_decode_reduce(const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   long long W, long long nb, long long L, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= total) return;
  const long long r = i / L;
  const long long e = i - r * L;
  const long long b = e / BLOCK;
  const long long per = nb * BLOCK;
  float acc = 0.f;
  for (long long w = 0; w < W; ++w) {
    const long long rw = r * W + w;
    acc = __fmaf_rn(static_cast<float>(q[rw * per + e]), scale[rw * nb + b],
                    acc);
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

// Launch the encode on `stream` over S slices of length L (nb blocks each);
// err == nullptr selects the residual-only variant. Returns the CUDA error
// code of the launch (0 = success).
int codec_int8_encode(const float* x, const float* err, int8_t* q,
                      float* scale, float* res, long long S, long long L,
                      long long nb, void* stream) {
  const long long blocks = S * nb;
  if (blocks <= 0) return 0;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (err != nullptr) {
    int8_block_encode<true><<<static_cast<unsigned>(blocks), BLOCK, 0, st>>>(
        x, err, q, scale, res, L, nb);
  } else {
    int8_block_encode<false><<<static_cast<unsigned>(blocks), BLOCK, 0, st>>>(
        x, nullptr, q, scale, res, L, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the decode-reduce on `stream`: R rank batches of W peers, nb blocks
// per peer slice, L output columns (L <= nb * 256).
int codec_int8_decode_reduce(const int8_t* q, const float* scale, float* out,
                             long long R, long long W, long long nb,
                             long long L, void* stream) {
  const long long total = R * L;
  if (total <= 0) return 0;
  const long long blocks = (total + 255) / 256;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int8_decode_reduce<<<static_cast<unsigned>(blocks), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      q, scale, out, W, nb, L, total);
  return static_cast<int>(cudaGetLastError());
}

const char* codec_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
