// Hand-written Hopper (sm_90a) kernel for one-token grouped-query attention
// against a KV cache: the decode tick of the serving engine.
//
// flash_decode replaces the Pallas kernel repro/kernels/flash_decode.py
//   flash_decode (its pl.pallas_call at flash_decode.py:73).
//
// What it computes (the Pallas body, row by row): for batch row b and query
// head h = kv*G + g, scores s = (q . k) * scale in fp32 over the positions
// below lengths[b], an online softmax in fp32 with NEG_INF = -1e30 as the
// running-max floor, fp32 p @ v, and acc / max(l, 1e-30) at the end.
// q is (B, 1, H, hd), k and v (B, S, KV, hd), all bf16 or all fp32; the
// output is (B, 1, H*hd) fp32. A row of length 0 or less masks every
// position, so, as in the Pallas body, it averages v over all S positions.
//
// Bound: decode reads every valid K/V row once and does 4*G flops per
// element read, far below the card's ops-per-byte ridge, so the memory rate
// bounds it. The TPU grid walked (B, KV, S/chunk) with a sequential chunk
// axis carrying the accumulators in VMEM. Here one CTA owns one (b, kv) pair,
// so each K/V row it loads serves all G query heads, and a loop over tiles
// of rows takes the place of the chunk axis. Tiles are staged into shared
// memory with cp.async, double-buffered, so the next tile's loads are in
// flight while this one is scored. The loop visits only positions below
// lengths[b] (read on the device, never synced to the host) and takes any
// S: skipping the fully masked tail is exact, since there the Pallas body
// multiplies by exp(0) = 1 and adds 0.
//
// Per tile: (A) one thread per row scores it against the G heads from
// shared memory (rows are padded by 16 bytes so the 16-byte reads of eight
// neighbouring rows fall on different banks); (B) one warp per head takes
// the tile's max, rescales the running max, sum and correction; (C) one
// thread per (head, dim) output folds the tile's p @ v into its register
// accumulator. Math is fp32 with expf (never __expf or fast math); the
// library is built with -fmad=false, so every fused multiply-add is an
// explicit fmaf.
//
// A split-S grid (flash-decoding with a combine pass) would fill more of
// the card: B*KV CTAs is 40 at the serving shape, on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;
constexpr int MAX_HD = 128;
constexpr int MAX_ROWS = 128;
constexpr int MAX_OUT = MAX_G * MAX_HD / THREADS;  // outputs per thread
constexpr int TILE_BYTES = 9216;  // one stage of K (or V) rows, pads included
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Element type traits: VEC elements per 16-byte chunk, a 16-byte load from
// shared memory as fp32, and one element as fp32.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ static void load16(const unsigned char* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
  __device__ static float at(const unsigned char* row, int d) {
    return reinterpret_cast<const float*>(row)[d];
  }
  __device__ static float get(const float* p, long long i) { return p[i]; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void load16(const unsigned char* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float at(const unsigned char* row, int d) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  }
  __device__ static float get(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
  }
};

// Queue the cp.async copies of rows [pos0, pos0 + nrows) of this CTA's K and
// V slices into one stage: chunk c of the tile is row c / cpr, 16-byte chunk
// c % cpr of that row.
template <typename T>
__device__ __forceinline__ void stage_tile(
    const T* kb, const T* vb, unsigned char* ks, unsigned char* vs, int pos0,
    int nrows, int cpr, int pitch, long long row_stride) {
  const int total = nrows * cpr;
  for (int c = threadIdx.x; c < total; c += THREADS) {
    const int r = c / cpr;
    const int j = c - r * cpr;
    const long long at = static_cast<long long>(pos0 + r) * row_stride;
    cp_async16(ks + r * pitch + j * 16,
               reinterpret_cast<const unsigned char*>(kb + at) + j * 16);
    cp_async16(vs + r * pitch + j * 16,
               reinterpret_cast<const unsigned char*>(vb + at) + j * 16);
  }
}

// grid (KV, B), THREADS threads: one CTA per (kv head, batch row).
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ out, int S, int KV, int G, int hd,
                    int rows, float scale) {
  __shared__ __align__(16) unsigned char kv_s[2][2][TILE_BYTES];
  __shared__ float q_s[MAX_G * MAX_HD];
  __shared__ float p_s[MAX_G][MAX_ROWS];
  __shared__ float m_s[MAX_G], l_s[MAX_G], corr_s[MAX_G];

  const int kvh = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = KV * G;
  const int GH = G * hd;
  const int len = lengths[b];
  // positions visited, and the first one that scores NEG_INF
  const int visit = len > 0 ? min(len, S) : S;
  const int limit = len > 0 ? visit : 0;
  const int pitch = hd * static_cast<int>(sizeof(T)) + 16;
  const int cpr = hd * static_cast<int>(sizeof(T)) / 16;
  const long long row_stride = static_cast<long long>(KV) * hd;
  const T* kb = k + (b * S * KV + kvh) * hd;
  const T* vb = v + (b * S * KV + kvh) * hd;
  const long long head0 = b * H + static_cast<long long>(kvh) * G;

  for (int i = tid; i < GH; i += THREADS)
    q_s[i] = Elem<T>::get(q, head0 * hd + i);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;

  const int n_tiles = (visit + rows - 1) / rows;
  stage_tile(kb, vb, kv_s[0][0], kv_s[0][1], 0, min(rows, visit), cpr, pitch,
             row_stride);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) * rows;
      stage_tile(kb, vb, kv_s[(t + 1) & 1][0], kv_s[(t + 1) & 1][1], nxt,
                 min(rows, visit - nxt), cpr, pitch, row_stride);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile t has landed (this thread's copies)
    __syncthreads();      // ... and every other thread's

    const unsigned char* ks = kv_s[t & 1][0];
    const unsigned char* vs = kv_s[t & 1][1];
    const int pos0 = t * rows;
    const int nrows = min(rows, visit - pos0);

    // (A) scores: one thread per row, all G heads at once
    for (int r = tid; r < nrows; r += THREADS) {
      float sc[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) sc[g] = 0.f;
      const unsigned char* row = ks + r * pitch;
      for (int j = 0; j < cpr; ++j) {
        float x[Elem<T>::VEC];
        Elem<T>::load16(row + j * 16, x);
#pragma unroll
        for (int e = 0; e < Elem<T>::VEC; ++e) {
          const float* qd = q_s + j * Elem<T>::VEC + e;
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) sc[g] = fmaf(qd[g * hd], x[e], sc[g]);
        }
      }
      const bool masked = pos0 + r >= limit;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) p_s[g][r] = masked ? NEG_INF : sc[g] * scale;
    }
    __syncthreads();

    // (B) online-softmax statistics: warp w owns heads w, w + WARPS, ...
    for (int g = warp; g < G; g += WARPS) {
      float mx = __int_as_float(0xff800000);  // -inf
      for (int r = lane; r < nrows; r += 32) mx = fmaxf(mx, p_s[g][r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < nrows; r += 32) {
        const float e = expf(p_s[g][r] - m_new);
        p_s[g][r] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = fmaf(l_s[g], corr, sum);
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // (C) acc = acc * corr + p @ v: one thread per (head, dim) output
#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int o = tid + i * THREADS;
      if (o < GH) {
        const int g = o / hd;
        const int d = o - g * hd;
        float a = acc[i] * corr_s[g];
        for (int r = 0; r < nrows; ++r)
          a = fmaf(p_s[g][r], Elem<T>::at(vs + r * pitch, d), a);
        acc[i] = a;
      }
    }
    __syncthreads();  // the next iteration refills the other stage
  }

#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int o = tid + i * THREADS;
    if (o < GH) {
      const int g = o / hd;
      out[head0 * hd + o] = acc[i] / fmaxf(l_s[g], 1e-30f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* out, int B, int S, int KV, int G, int hd, float scale,
           cudaStream_t st) {
  const int pitch = hd * static_cast<int>(sizeof(T)) + 16;
  const int rows = TILE_BYTES / pitch < MAX_ROWS ? TILE_BYTES / pitch
                                                 : MAX_ROWS;
  flash_decode_kernel<T><<<dim3(KV, B), THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, out, S, KV, G, hd, rows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch flash_decode on `stream`. q (B, 1, KV*G, hd), k and v (B, S, KV,
// hd), contiguous, bf16 (bf16 != 0) or fp32; lengths (B,) int32 on the
// device; out (B, 1, KV*G*hd) fp32. Takes 1 <= G <= 8, hd <= 128 with
// 16-byte rows (hd a multiple of 8 in bf16, of 4 in fp32) and 16-byte
// aligned k and v. Returns the CUDA error code of the launch (0 = success).
int flash_decode(const void* q, const void* k, const void* v,
                 const int* lengths, float* out, int B, int S, int KV, int G,
                 int hd, int bf16, float scale, void* stream) {
  const int esize = bf16 ? 2 : 4;
  if (B <= 0 || S <= 0 || KV <= 0 || B > 65535 || G < 1 || G > MAX_G ||
      hd < 1 || hd > MAX_HD || (hd * esize) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, KV, G, hd,
                                      scale, st)
              : launch<float>(q, k, v, lengths, out, B, S, KV, G, hd, scale,
                              st);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
