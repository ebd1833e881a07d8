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
// is independent, so one warp owns one quantization block: lane l holds
// the block's elements 8l .. 8l + 7 in registers from load (two float4;
// two more of err under HAS_ERR) to store, the amax is five
// __shfl_xor_sync with nanmax (no shared memory, no barrier), and each lane
// writes its 8 bytes of q as one 8-byte word and its residual as two
// float4; lane 0 writes the scale. CTAs of ENC_WARPS = 4 warps walk the
// blocks in a grid-stride loop over a grid sized to the SMs (so no launch
// is refused for the number of blocks), each warp issuing its next
// block's loads before the current block's stores, and stepping its
// (slice, block) pair with no division. At ~60 registers a thread, CTAs
// of 4 warps keep more warps resident than CTAs of 8 or 16 and ran faster
// on the H100; capping the registers to fit more spills and runs slower. VEC: L % 4 == 0 and x, err, res 16-byte
// aligned, q 8-byte aligned; else the same lanes with scalar loads and
// stores.
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
// NaN: the amax propagates NaN, so a block holding a NaN gets a NaN scale
// and a NaN residual; its decoded sum is NaN. Where c / scale is NaN (a
// NaN block, or an infinite element against an infinite scale) q is NaN
// unclipped, as in the plain version and the reference: its wire byte is
// 0 (their int8 cast of NaN) and its residual NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr float RECIP127 = 0x1.020408p-7f;  // float32(1/127)
constexpr float TINY = 1e-12f;

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

constexpr int ENC_WARPS = 4;  // quantization blocks in flight per CTA
constexpr int ENC_THREADS = 32 * ENC_WARPS;
constexpr int PER_LANE = BLOCK / 32;  // 8

// One lane's 8 elements of a block: p points at the first, n of them lie
// inside the row (columns past L read as 0). Where VEC, n is a multiple of
// 4 and p 16-byte aligned: one float4 for each 4 inside.
template <bool VEC>
__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      long long n, float (&v)[PER_LANE]) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 f = 4 * h < n ? *reinterpret_cast<const float4*>(p + 4 * h)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * h] = f.x;
      v[4 * h + 1] = f.y;
      v[4 * h + 2] = f.z;
      v[4 * h + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) v[k] = k < n ? p[k] : 0.f;
  }
}

// x, err, res (S, L) row-major; q (S, nb, 256); scale (S, nb). CTAs of
// WARPS warps; warp w of the grid takes blocks w, w + stride, ... of the
// S * nb, walking (s, b) by (ds, db) = divmod(stride, nb). Columns past L
// are zero padding: they enter the amax as 0 and store q = 0, no residual.
// WARPS is ENC_WARPS in every launch here; scripts/encode_sweep.py times
// other CTA sizes.
template <bool HAS_ERR, bool VEC, int WARPS = ENC_WARPS>
__global__ void __launch_bounds__(32 * WARPS)
int8_block_encode(const float* __restrict__ x, const float* __restrict__ err,
                  int8_t* __restrict__ q, float* __restrict__ scale,
                  float* __restrict__ res, long long L, long long nb,
                  long long total) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  long long blk = static_cast<long long>(blockIdx.x) * WARPS +
                  (threadIdx.x >> 5);
  if (blk >= total) return;
  const long long ds = stride / nb, db = stride - ds * nb;
  long long s = blk / nb, b = blk - s * nb;
  float xv[PER_LANE], ev[PER_LANE];
  long long col = b * BLOCK + PER_LANE * lane;
  load8<VEC>(x + s * L + col, L - col, xv);
  if (HAS_ERR) load8<VEC>(err + s * L + col, L - col, ev);
  for (;;) {
    float c[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k)
      c[k] = HAS_ERR ? __fadd_rn(xv[k], ev[k]) : xv[k];
    const long long at = s * L + col, n = L - col, here = blk;
    // the next block's loads go out before this block's stores
    blk += stride;
    const bool more = blk < total;
    if (more) {
      s += ds;
      b += db;
      if (b >= nb) {
        b -= nb;
        ++s;
      }
      col = b * BLOCK + PER_LANE * lane;
      load8<VEC>(x + s * L + col, L - col, xv);
      if (HAS_ERR) load8<VEC>(err + s * L + col, L - col, ev);
    }

    float m = fabsf(c[0]);
#pragma unroll
    for (int k = 1; k < PER_LANE; ++k) m = nanmax(m, fabsf(c[k]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float sc = __fmul_rn(m, RECIP127);
    const float d = (sc != sc) ? sc : fmaxf(sc, TINY);
    unsigned bytes[2] = {0u, 0u};
    float r[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      float qf = rintf(__fdiv_rn(c[k], d));
      qf = (qf != qf) ? qf : fminf(fmaxf(qf, -127.f), 127.f);
      const unsigned byte =
          (qf != qf) ? 0u : static_cast<unsigned>(__float2int_rn(qf)) & 0xffu;
      bytes[k >> 2] |= byte << (8 * (k & 3));
      r[k] = __fmaf_rn(-qf, sc, c[k]);
    }
    int8_t* qp = q + here * BLOCK + PER_LANE * lane;
    float* rp = res + at;
    if (VEC) {
      *reinterpret_cast<uint2*>(qp) = make_uint2(bytes[0], bytes[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (4 * h < n)
          *reinterpret_cast<float4*>(rp + 4 * h) =
              make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        qp[k] = static_cast<int8_t>(bytes[k >> 2] >> (8 * (k & 3)));
        if (k < n) rp[k] = r[k];
      }
    }
    if (lane == 0) scale[here] = sc;
    if (!more) return;
  }
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

using Encode = void (*)(const float*, const float*, int8_t*, float*, float*,
                       long long, long long, long long);

Encode pick_encode(bool has_err, bool vec) {
  if (has_err)
    return vec ? int8_block_encode<true, true> : int8_block_encode<true, false>;
  return vec ? int8_block_encode<false, true> : int8_block_encode<false, false>;
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// The encode's grid: as many CTAs as the card holds at once (SMs x
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once per host
// thread, device and instance), no more than the blocks need.
int encode_grid(Encode k, long long total, unsigned* ctas) {
  constexpr int DEVICES = 16;
  thread_local int resident[DEVICES][4] = {};  // CTAs a card holds
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc) return rc;
  if (dev < 0 || dev >= DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int i = (k == int8_block_encode<true, true>) * 3 +
                (k == int8_block_encode<true, false>) * 2 +
                (k == int8_block_encode<false, true>) * 1;
  if (!resident[dev][i]) {
    int sms = 0, per_sm = 0;
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
    if (!rc)
      rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, k, ENC_THREADS, 0));
    if (rc) return rc;
    resident[dev][i] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (total + ENC_WARPS - 1) / ENC_WARPS;
  *ctas = static_cast<unsigned>(need < resident[dev][i] ? need
                                                        : resident[dev][i]);
  return 0;
}

}  // namespace

extern "C" {

// Launch the encode on `stream` over S slices of length L (nb blocks each);
// err == nullptr selects the residual-only variant. One launch of a grid
// sized to the SMs, whatever the number of blocks. Returns the CUDA error
// code of the launch (0 = success).
int codec_int8_encode(const float* x, const float* err, int8_t* q,
                      float* scale, float* res, long long S, long long L,
                      long long nb, void* stream) {
  const long long total = S * nb;
  if (total <= 0) return 0;
  const bool vec = L % 4 == 0 && aligned(x, 16) && aligned(res, 16) &&
                   aligned(q, 8) && (err == nullptr || aligned(err, 16));
  const Encode k = pick_encode(err != nullptr, vec);
  unsigned ctas = 0;
  int rc = encode_grid(k, total, &ctas);
  if (rc) return rc;
  k<<<ctas, ENC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, err, q, scale, res, L, nb, total);
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
