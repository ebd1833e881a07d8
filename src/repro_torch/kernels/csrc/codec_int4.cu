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
// step, in order; here every block is independent, so one warp owns one
// quantization block, as in int8's encode: lane l holds the block's
// elements 8l .. 8l + 7 in registers from load (two float4; two more of
// err under HAS_ERR) to store, the amax is five __shfl_xor_sync with
// nanmax (no shared memory, no barrier), and each lane packs its 8
// nibbles into one 32-bit word (byte j: element 2j in the low nibble,
// 2j + 1 in the high one), so a warp writes its block's 128 wire bytes
// with one 4-byte store a lane; its residual goes out as two float4 and
// lane 0 writes the scale. CTAs of ENC_WARPS warps walk the blocks in a
// grid-stride loop over a grid sized to the SMs (no launch is refused for
// the number of blocks), each warp issuing its next block's loads before
// the current block's stores and stepping its (slice, block) pair with no
// division. No register cap: capped int8 variants spilled and ran slower.
// VEC: L % 4 == 0, x, err and res 16-byte aligned and q 4-byte aligned;
// else the same lanes with scalar loads and stores, the same bits.
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
// and NaN residuals; its decoded sums are NaN. Where c / scale is NaN (a
// NaN block, or an infinite element against an infinite scale) q is NaN
// unclipped, as in the plain version and the reference: its nibble is 8
// (their int32 cast of NaN leaves a low nibble of 0) and its residual NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int HALF = BLOCK / 2;           // wire bytes per quantization block
constexpr float RECIP7 = 0x1.24924ap-3f;  // float32(1/7)
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

// x, err, res (S, L) row-major; q (S, nb, 128); scale (S, nb). CTAs of
// WARPS warps; warp w of the grid takes blocks w, w + stride, ... of the
// S * nb, walking (s, b) by (ds, db) = divmod(stride, nb). Columns past L
// are zero padding: they enter the amax as 0 and store nibble 8 (q = 0),
// no residual; at an odd L the last byte's high nibble is padding. WARPS
// is ENC_WARPS in every launch here; scripts/encode_sweep.py times other
// CTA sizes.
template <bool HAS_ERR, bool VEC, int WARPS = ENC_WARPS>
__global__ void __launch_bounds__(32 * WARPS)
int4_block_encode(const float* __restrict__ x, const float* __restrict__ err,
                  uint8_t* __restrict__ q, float* __restrict__ scale,
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
    const float sc = __fmul_rn(m, RECIP7);
    const float d = (sc != sc) ? sc : fmaxf(sc, TINY);
    unsigned word = 0u;  // nibble k at bits 4k .. 4k + 3
    float r[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      float qf = rintf(__fdiv_rn(c[k], d));
      qf = (qf != qf) ? qf : fminf(fmaxf(qf, -7.f), 7.f);
      const unsigned nib =
          (qf != qf) ? 8u : static_cast<unsigned>(__float2int_rn(qf) + 8);
      word |= nib << (4 * k);
      r[k] = __fmaf_rn(-qf, sc, c[k]);
    }
    uint8_t* qp = q + here * HALF + (PER_LANE / 2) * lane;
    float* rp = res + at;
    if (VEC) {
      *reinterpret_cast<unsigned*>(qp) = word;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (4 * h < n)
          *reinterpret_cast<float4*>(rp + 4 * h) =
              make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < PER_LANE / 2; ++j)
        qp[j] = static_cast<uint8_t>(word >> (8 * j));
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k)
        if (k < n) rp[k] = r[k];
    }
    if (lane == 0) scale[here] = sc;
    if (!more) return;
  }
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

using Encode = void (*)(const float*, const float*, uint8_t*, float*, float*,
                       long long, long long, long long);

Encode pick_encode(bool has_err, bool vec) {
  if (has_err)
    return vec ? int4_block_encode<true, true> : int4_block_encode<true, false>;
  return vec ? int4_block_encode<false, true> : int4_block_encode<false, false>;
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
  const int i = (k == int4_block_encode<true, true>) * 3 +
                (k == int4_block_encode<true, false>) * 2 +
                (k == int4_block_encode<false, true>) * 1;
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
int codec_int4_encode(const float* x, const float* err, uint8_t* q,
                      float* scale, float* res, long long S, long long L,
                      long long nb, void* stream) {
  const long long total = S * nb;
  if (total <= 0) return 0;
  const bool vec = L % 4 == 0 && aligned(x, 16) && aligned(res, 16) &&
                   aligned(q, 4) && (err == nullptr || aligned(err, 16));
  const Encode k = pick_encode(err != nullptr, vec);
  unsigned ctas = 0;
  int rc = encode_grid(k, total, &ctas);
  if (rc) return rc;
  k<<<ctas, ENC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, err, q, scale, res, L, nb, total);
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
