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
// four shared-memory words.
//
// Decode has no cross-block carry. As int8's and fp8's decode-reduce, one
// thread makes DEC_V = 8 consecutive outputs of one quantization block:
// per peer one 4-byte wire word (8 nibbles) and one scale, the loads of
// all W peers issued before the first multiply-add (W 1, 2, 4, 8
// unrolled; other W in unrolled groups of DEC_GROUP peers), and two
// float4 stores. A thread's first element is its index times 8, so its
// block and wire offset are shifts. The wire may start at any address:
// where q is not 4-byte aligned the same kernel reads each thread's 4
// bytes one by one, all peers still in flight. Each element sums its
// peers in order from 0.0f: no atomics, no second pass.
//
// Each nibble n becomes n - 8 as 2^23 + n (its bits OR-ed into 2^23's)
// minus 2^23 + 8. Both are exact floats (n < 2^4 fits the 23-bit
// mantissa, and the difference n - 8 is representable), so the result has
// the same bits as I2F, with a LOP3 and an FADD in place of the
// quarter-rate I2F. Its timing against I2F and against 16 outputs a
// thread, and the old one-byte-a-thread design: PERF.md section 6, row 6.
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

constexpr int DEC_V = 8;          // outputs per thread: one wire word a peer
constexpr int DEC_THREADS = 128;
constexpr int DEC_GROUP = 8;      // peers in flight at once for other W

// Nibble j of w (the even element in the low nibble), minus 8, as float.
__device__ __forceinline__ float nibble(unsigned w, int j) {
  const unsigned n = (w >> (4 * j)) & 0xFu;
  // 2^23 + n, exactly, then minus 2^23 + 8: exact, so the same bits as I2F
  return __fsub_rn(__uint_as_float(0x4B000000u | n), 8388616.0f);
}

// A peer's wire word at q: one 4-byte load where VEC_IN (q 4-byte
// aligned), else byte by byte. Always inside the peer's slice: a thread's
// first element e0 < L <= nb * 256 is a multiple of 8, so its 4 bytes end
// at or before nb * 128.
template <bool VEC_IN>
__device__ __forceinline__ unsigned load_word(const uint8_t* __restrict__ q) {
  if constexpr (VEC_IN) {
    return __ldg(reinterpret_cast<const unsigned*>(q));
  } else {
    unsigned w = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w |= static_cast<unsigned>(__ldg(q + k)) << (8 * k);
    return w;
  }
}

// Adds `count` (<= G) peers to acc, in order: their wire words (q + j *
// qstep) and scales (scale + j * sstep) are all loaded first.
template <int G, bool VEC_IN>
__device__ __forceinline__ void add_peers(const uint8_t* __restrict__ q,
                                          const float* __restrict__ scale,
                                          long long qstep, long long sstep,
                                          int count, float (&acc)[DEC_V]) {
  unsigned w[G];
  float s[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < count) {
      w[j] = load_word<VEC_IN>(q + j * qstep);
      s[j] = __ldg(scale + j * sstep);
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < count) {
#pragma unroll
      for (int k = 0; k < DEC_V; ++k)
        acc[k] = __fmaf_rn(nibble(w[j], k), s[j], acc[k]);
    }
  }
}

// out[r, e] = sum over w of (nibble e of q[r, w]) - 8 times scale[r, w,
// e / 256], in order w = 0..W-1 from 0.0f. q is (R, W, nb, 128) uint8,
// scale (R, W, nb), out (R, L). grid (ceil(L / (DEC_V * DEC_THREADS)),
// min(R, 65535)); thread j of a row makes elements DEC_V * j onwards, all
// in one 256-element block (DEC_V divides 256): its wire bytes start at
// e0 / 2 and its scale is block e0 / 256, shifts, no division. W_T is W
// where it is 1, 2, 4 or 8, else 0 (groups of DEC_GROUP). VEC_IN: q
// 4-byte aligned, so every thread's word of every peer is aligned (peer
// slices are nb * 128 bytes). VEC_OUT: L % 4 == 0 and out 16-byte aligned
// (float4 stores; scalar ones for the last vector of a row, which writes
// only e < L; an odd L drops the last byte's high nibble).
template <int W_T, bool VEC_IN, bool VEC_OUT>
__global__ void __launch_bounds__(DEC_THREADS)
int4_decode_reduce(const uint8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int W, long long nb, long long L, long long R) {
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * DEC_THREADS + threadIdx.x) *
      DEC_V;
  if (e0 >= L) return;
  const long long qstep = nb * HALF;  // one peer's wire slice
  const int n = static_cast<int>(min(static_cast<long long>(DEC_V), L - e0));
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const long long rw = r * W;
    const uint8_t* qp = q + rw * qstep + (e0 >> 1);
    const float* sp = scale + rw * nb + (e0 >> 8);
    float acc[DEC_V];
#pragma unroll
    for (int k = 0; k < DEC_V; ++k) acc[k] = 0.f;
    if constexpr (W_T > 0) {
      add_peers<W_T, VEC_IN>(qp, sp, qstep, nb, W_T, acc);
    } else {
      for (int w0 = 0; w0 < W; w0 += DEC_GROUP)
        add_peers<DEC_GROUP, VEC_IN>(qp + w0 * qstep, sp + w0 * nb, qstep,
                                     nb, min(DEC_GROUP, W - w0), acc);
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
                       const float* scale, float* out, int W, long long nb,
                       long long L, long long R) {
  if (L % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    int4_decode_reduce<W_T, VEC_IN, true><<<grid, DEC_THREADS, 0, st>>>(
        q, scale, out, W, nb, L, R);
  else
    int4_decode_reduce<W_T, VEC_IN, false><<<grid, DEC_THREADS, 0, st>>>(
        q, scale, out, W, nb, L, R);
}

template <int W_T>
void launch_decode(dim3 grid, cudaStream_t st, const uint8_t* q,
                   const float* scale, float* out, int W, long long nb,
                   long long L, long long R) {
  if (reinterpret_cast<uintptr_t>(q) % 4 == 0)
    launch_decode_out<W_T, true>(grid, st, q, scale, out, W, nb, L, R);
  else
    launch_decode_out<W_T, false>(grid, st, q, scale, out, W, nb, L, R);
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
// per peer slice, L output columns (L <= nb * 256); q at any address.
int codec_int4_decode_reduce(const uint8_t* q, const float* scale,
                             float* out, long long R, long long W,
                             long long nb, long long L, void* stream) {
  if (R <= 0 || L <= 0) return 0;
  const long long per_cta = static_cast<long long>(DEC_V) * DEC_THREADS;
  const long long blocks = (L + per_cta - 1) / per_cta;
  if (W < 0 || W > 2147483647LL || L > nb * BLOCK || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(R < 65535 ? R : 65535));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(W);
  switch (w) {
    case 1: launch_decode<1>(grid, st, q, scale, out, w, nb, L, R); break;
    case 2: launch_decode<2>(grid, st, q, scale, out, w, nb, L, R); break;
    case 4: launch_decode<4>(grid, st, q, scale, out, w, nb, L, R); break;
    case 8: launch_decode<8>(grid, st, q, scale, out, w, nb, L, R); break;
    default: launch_decode<0>(grid, st, q, scale, out, w, nb, L, R);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* codec_int4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
