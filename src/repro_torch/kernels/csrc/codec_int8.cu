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
// pass, with the element kept in a register from load to store.
//
// Decode has no cross-block carry. At 1 byte read per peer and 4 written
// per element it is held by instructions and loads, not bytes, if a thread
// makes one element (a 64-bit division, then a 1-byte load and a scale
// load per peer). So one thread makes DEC_V = 8 consecutive outputs of
// one quantization block: per peer one 8-byte vector of q and one scale,
// the loads of all W peers issued before the first multiply-add (W 1, 2,
// 4, 8 unrolled; other W in unrolled groups of DEC_GROUP peers), and two
// float4 stores (scalar stores where a row of the output, L floats, does
// not start 16-byte aligned, and for the last vector of a row, which
// writes only e < L). A thread's first element is its index times 8, so
// its block and peer offsets take no division. 8 outputs a thread ran
// faster than 16 on the H100: at (8, 2, 524288), 16 outputs, with four
// float4 stores 64 bytes apart, were slower than one output a thread.
// Each element still sums its peers in order from 0.0f, so no atomics and
// no second pass.
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

constexpr int DEC_V = 8;         // outputs per thread: one int2 of q a peer
constexpr int DEC_THREADS = 128;
constexpr int DEC_GROUP = 8;     // peers in flight at once for other W

// Adds `count` (<= G) peers to acc, in order: their q vectors (q + j *
// qstep) and scales (scale + j * sstep) are all loaded first.
template <int G>
__device__ __forceinline__ void add_peers(const int8_t* __restrict__ q,
                                          const float* __restrict__ scale,
                                          long long qstep, long long sstep,
                                          int count, float (&acc)[DEC_V]) {
  int2 v[G];
  float s[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < count) {
      v[j] = __ldg(reinterpret_cast<const int2*>(q + j * qstep));
      s[j] = __ldg(scale + j * sstep);
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < count) {
      const int words[2] = {v[j].x, v[j].y};
#pragma unroll
      for (int k = 0; k < DEC_V; ++k) {
        const float qf = static_cast<float>(
            static_cast<int8_t>(words[k >> 2] >> (8 * (k & 3))));
        acc[k] = __fmaf_rn(qf, s[j], acc[k]);
      }
    }
  }
}

// out[r, e] = sum over w of q[r, w, e] * scale[r, w, e / 256], in order
// w = 0..W-1 from 0.0f. q is (R, W, nb, 256) int8 (8-byte aligned),
// scale (R, W, nb), out (R, L). grid (ceil(L / (DEC_V * DEC_THREADS)),
// min(R, 65535)); thread j of a row makes elements DEC_V * j onwards.
// W_T is W where it is 1, 2, 4 or 8, else 0 (groups of DEC_GROUP).
// VEC_OUT: L % 4 == 0, so every row of out starts 16-byte aligned.
template <int W_T, bool VEC_OUT>
__global__ void __launch_bounds__(DEC_THREADS)
int8_decode_reduce(const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int W, long long nb, long long L, long long R) {
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * DEC_THREADS + threadIdx.x) *
      DEC_V;
  if (e0 >= L) return;
  const long long qstep = nb * BLOCK;  // one peer's wire slice
  const int n = static_cast<int>(min(static_cast<long long>(DEC_V), L - e0));
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const long long rw = r * W;
    const int8_t* qp = q + rw * qstep + e0;
    const float* sp = scale + rw * nb + e0 / BLOCK;
    float acc[DEC_V];
#pragma unroll
    for (int k = 0; k < DEC_V; ++k) acc[k] = 0.f;
    if constexpr (W_T > 0) {
      add_peers<W_T>(qp, sp, qstep, nb, W_T, acc);
    } else {
      for (int w0 = 0; w0 < W; w0 += DEC_GROUP)
        add_peers<DEC_GROUP>(qp + w0 * qstep, sp + w0 * nb, qstep, nb,
                             min(DEC_GROUP, W - w0), acc);
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

template <int W_T>
void launch_decode(dim3 grid, cudaStream_t st, const int8_t* q,
                   const float* scale, float* out, long long W, long long nb,
                   long long L, long long R) {
  if (L % 4 == 0)
    int8_decode_reduce<W_T, true><<<grid, DEC_THREADS, 0, st>>>(
        q, scale, out, static_cast<int>(W), nb, L, R);
  else
    int8_decode_reduce<W_T, false><<<grid, DEC_THREADS, 0, st>>>(
        q, scale, out, static_cast<int>(W), nb, L, R);
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
// per peer slice, L output columns (L <= nb * 256); q 8-byte aligned.
int codec_int8_decode_reduce(const int8_t* q, const float* scale, float* out,
                             long long R, long long W, long long nb,
                             long long L, void* stream) {
  if (R <= 0 || L <= 0) return 0;
  const long long per_cta = static_cast<long long>(DEC_V) * DEC_THREADS;
  const long long blocks = (L + per_cta - 1) / per_cta;
  if (W <= 0 || W > 2147483647LL || blocks > 2147483647LL ||
      (reinterpret_cast<uintptr_t>(q) % sizeof(int2)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(R < 65535 ? R : 65535));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch_decode<1>(grid, st, q, scale, out, W, nb, L, R); break;
    case 2: launch_decode<2>(grid, st, q, scale, out, W, nb, L, R); break;
    case 4: launch_decode<4>(grid, st, q, scale, out, W, nb, L, R); break;
    case 8: launch_decode<8>(grid, st, q, scale, out, W, nb, L, R); break;
    default: launch_decode<0>(grid, st, q, scale, out, W, nb, L, R);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* codec_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
