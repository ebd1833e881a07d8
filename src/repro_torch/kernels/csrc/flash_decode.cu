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
// bounds it: at the serving shapes (B 8, S 2048) 0.0063 ms for smollm (KV 5,
// hd 64) and 0.020 ms for jamba (KV 8, hd 128) at 3.35 TB/s.
//
// Design: a split-S (flash-decoding) grid, (KV * NG, B, n_split). A CTA
// holds the query heads of one head group: the G heads of a kv head are
// cut into NG equal groups of G / NG <= MAX_G = 8 heads (NG the least
// count from ceil(G / 8) that divides G: qwen3-moe's G 16 is 2 groups of
// 8, G 12 2 of 6, G 9 3 of 3), so the per-lane registers (q's slice and
// the accumulators of at most 8 heads) stay those of G <= 8 whatever G
// is, and a head group is a kv head of its own to everything below but
// the K/V rows it reads: the NG CTAs of one (b, kv) read the same rows,
// the later reads mostly from L2 (qwen3-moe's cache, B 8, S 2048, KV 4,
// hd 64 in bf16, is 16.8 MB). For G <= 8, NG = 1: the grid of one head
// group per kv head. One (b, head group) pair owns B*KV*NG = 40
// (smollm), 64 (jamba) or 64 (qwen3-moe) CTAs' worth of work, too few
// for 132 SMs, so its row is cut into n_split spans of ceil(S / n_split)
// positions and each span is one CTA. The wrapper picks n_split by one rule
// (kernels/attention.py split_count): about two CTAs per SM, and no span
// shorter than one staged tile. Split s scores positions [s*span,
// (s+1)*span) cut at the row's visited length (min(len, S) for len > 0, S
// for len <= 0), read on the device and never synced to the host: a split
// wholly past it keeps m = NEG_INF, l = 0, acc = 0. Each split writes its
// partial (m[G], l[G], acc[G*hd], G the head group's heads) to an fp32
// workspace the wrapper allocates; the last split of a (b, head group)
// pair to finish (an atomic ticket per pair, in a buffer the wrapper keeps
// zeroed per device and stream;
// the last split sets its ticket back to 0) merges the partials in split
// order: M = max m_s, l = sum l_s e^(m_s - M), acc = sum acc_s e^(m_s - M),
// out = acc / max(l, 1e-30). One launch per call.
//
// Inside a CTA, tiles of rows are staged into shared memory with cp.async,
// double-buffered, so the next tile's loads are in flight while this one
// is scored (rows padded by 16 bytes so neighbouring rows' 16-byte reads
// fall on different banks). A row's 16-byte chunks are spread over LPR
// lanes (LPR = cpr rounded up to a power of two), 32 / LPR rows per warp:
// (A) each lane dots its chunk with q's matching slice for all G heads,
// held in registers for the whole walk, and the LPR lanes finish each
// score with a shuffle reduction; (B) one warp per head takes the tile's
// max and rescales the running max, sum and correction; (C) each lane
// folds p @ v for its rows and its chunk into register accumulators, and
// the rows' partial sums are reduced across lanes and warps once, at the
// end of the split. Math is fp32 with expf (never __expf or fast math);
// the library is built with -fmad=false, so every fused multiply-add is an
// explicit fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;
constexpr int MAX_HD = 128;
constexpr int MAX_ROWS = 128;
constexpr int TILE_BYTES = 9216;  // one stage of K (or V) rows, pads included
constexpr int STAGES = 2;         // tiles in the cp.async ring
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most STAGES - 1 committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
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
  __device__ static float get(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
  }
};

// Sum each of a lane's GM values over the LPR lanes of its row (lanes that
// differ in the low log2(LPR) bits), as a reduce-scatter: each level sends
// half of the values still carried and keeps the other half, so a level
// costs half as many shuffles as the one before. On return the lane holds
// max(1, GM / LPR) sums, for heads head0, head0 + 1, ... in v[0], v[1], ...
template <int GM, int LPR>
__device__ __forceinline__ int row_sums(float (&v)[GM], int c) {
  int head0 = 0;
  int count = GM;
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {
    if (count > 1) {
      const int half = count / 2;
      const bool up = (c & o) != 0;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = up ? v[j] : v[j + half];
        const float keep = up ? v[j + half] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      if (up) head0 += half;
      count = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return head0;
}

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

// grid (KV * NG, B, n_split), THREADS threads: one CTA per (head group,
// batch row, span of positions); head group x holds the G heads x*G ..
// x*G + G - 1 of kv head x / NG (G here is a group's head count). GM >= G
// heads are held per lane; LPR lanes per row. part holds n_split partials
// of (2*G + G*hd) floats per (b, head group) pair; tickets one counter
// per pair, zero on entry and on exit.
template <typename T, int GM, int LPR>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ out, float* part, int* tickets, int S,
                    int KV, int NG, int G, int hd, int rows, int span,
                    float scale) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int RPW = 32 / LPR;          // rows per warp and pass
  constexpr int RPP = RPW * WARPS;       // rows per CTA and pass
  // sums a lane keeps after row_sums, and lanes that hold the same ones
  constexpr int KEPT = GM > LPR ? GM / LPR : 1;
  constexpr int SHARE = LPR > GM ? LPR / GM : 1;
  constexpr int HPW = (GM + WARPS - 1) / WARPS;  // heads per warp in (B)
  __shared__ __align__(16) unsigned char kv_s[STAGES * 2 * TILE_BYTES];
  __shared__ float p_s[MAX_G][MAX_ROWS];
  __shared__ float m_s[MAX_G], l_s[MAX_G], corr_s[MAX_G];
  __shared__ int last_s;

  const int kvh = blockIdx.x / NG;      // the kv head of this head group
  const long long b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = lane / LPR;           // row slot within the warp
  const int c = lane % LPR;              // 16-byte chunk of the row
  const int H = KV * NG * G;
  const int GH = G * hd;
  const int cpr = hd * static_cast<int>(sizeof(T)) / 16;
  const bool has_chunk = c < cpr;
  const int len = lengths[b];
  // positions visited, and the first one that scores NEG_INF
  const int visit = len > 0 ? min(len, S) : S;
  const int limit = len > 0 ? visit : 0;
  const int lo = split * span;
  const int hi = min(lo + span, visit);
  const int pitch = hd * static_cast<int>(sizeof(T)) + 16;
  const long long row_stride = static_cast<long long>(KV) * hd;
  const T* kb = k + (b * S * KV + kvh) * hd;
  const T* vb = v + (b * S * KV + kvh) * hd;
  const long long head0 = b * H + static_cast<long long>(blockIdx.x) * G;

  // this lane's slice of q for every head
  float qr[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[g][e] = (g < G && has_chunk)
                     ? Elem<T>::get(q, (head0 + g) * hd + c * VEC + e)
                     : 0.f;
  float acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  if (tid < MAX_G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    corr_s[tid] = 0.f;
  }

  const int n_tiles = hi > lo ? (hi - lo + rows - 1) / rows : 0;
  // the ring: tile t in stage t % STAGES, K then V
  auto stage = [&](int t) {
    if (t < n_tiles) {
      unsigned char* st = kv_s + (t % STAGES) * 2 * TILE_BYTES;
      const int pos = lo + t * rows;
      stage_tile(kb, vb, st, st + TILE_BYTES, pos, min(rows, hi - pos), cpr,
                 pitch, row_stride);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) stage(t);
  for (int t = 0; t < n_tiles; ++t) {
    stage(t + STAGES - 1);
    cp_async_wait_ring();  // tile t has landed (this thread's copies)
    __syncthreads();       // ... and every other thread's

    const unsigned char* ks = kv_s + (t % STAGES) * 2 * TILE_BYTES;
    const unsigned char* vs = ks + TILE_BYTES;
    const int pos0 = lo + t * rows;
    const int nrows = min(rows, hi - pos0);

    // (A) scores: LPR lanes per row, all G heads, a shuffle reduction
    for (int base = warp * RPW; base < nrows; base += RPP) {
      const int r = base + slot;
      const bool live = r < nrows && has_chunk;
      float x[VEC];
      if (live) {
        Elem<T>::load16(ks + r * pitch + c * 16, x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
      float sc[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) a = fmaf(qr[g][e], x[e], a);
        sc[g] = a;
      }
      const int head0 = row_sums<GM, LPR>(sc, c);
      if (r < nrows && c % SHARE == 0) {
        const bool masked = pos0 + r >= limit;
#pragma unroll
        for (int j = 0; j < KEPT; ++j)
          if (head0 + j < G)
            p_s[head0 + j][r] = masked ? NEG_INF : sc[j] * scale;
      }
    }
    __syncthreads();

    // (B) online-softmax statistics: warp w owns heads w, w + WARPS, ...,
    // all of them in one pass over the rows
    {
      float mx[HPW], m_new[HPW], sum[HPW];
#pragma unroll
      for (int j = 0; j < HPW; ++j) mx[j] = __int_as_float(0xff800000);
      for (int r = lane; r < nrows; r += 32) {
#pragma unroll
        for (int j = 0; j < HPW; ++j)
          mx[j] = fmaxf(mx[j], p_s[warp + j * WARPS][r]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < HPW; ++j)
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        m_new[j] = fmaxf(m_s[warp + j * WARPS], mx[j]);
        sum[j] = 0.f;
      }
      for (int r = lane; r < nrows; r += 32) {
#pragma unroll
        for (int j = 0; j < HPW; ++j) {
          const float e = expf(p_s[warp + j * WARPS][r] - m_new[j]);
          p_s[warp + j * WARPS][r] = e;
          sum[j] += e;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < HPW; ++j)
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], o);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < HPW; ++j) {
          const int g = warp + j * WARPS;
          const float corr = expf(m_s[g] - m_new[j]);
          corr_s[g] = corr;
          l_s[g] = fmaf(l_s[g], corr, sum[j]);
          m_s[g] = m_new[j];
        }
      }
    }
    __syncthreads();

    // (C) acc = acc * corr + p @ v over this lane's rows and chunk
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float corr = g < G ? corr_s[g] : 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
    }
    if (has_chunk) {
      for (int r = warp * RPW + slot; r < nrows; r += RPP) {
        float x[VEC];
        Elem<T>::load16(vs + r * pitch + c * 16, x);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float p = g < G ? p_s[g][r] : 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, x[e], acc[g][e]);
        }
      }
    }
    __syncthreads();  // the next iteration refills the other stage
  }

  // the rows' partial sums: across the warp's row slots, then the warps
  // (warps 1.. through the staging buffers, free after the walk)
  float* red = reinterpret_cast<float*>(kv_s);
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  if (warp > 0 && slot == 0 && has_chunk) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (g < G) red[(warp - 1) * GH + g * hd + c * VEC + e] = acc[g][e];
  }
  __syncthreads();

  // this split's partial: m[G], l[G], acc[G*hd]
  const int stride = 2 * G + GH;
  const long long pair = b * gridDim.x + blockIdx.x;
  float* mine = part + (pair * n_split + split) * stride;
  if (warp == 0 && slot == 0 && has_chunk) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (g < G) {
          const int o = g * hd + c * VEC + e;
          float a = acc[g][e];
#pragma unroll
          for (int w = 0; w < WARPS - 1; ++w) a += red[w * GH + o];
          mine[2 * G + o] = a;
        }
  }
  if (tid < G) {
    mine[tid] = m_s[tid];
    mine[G + tid] = l_s[tid];
  }

  // the last split of the pair to arrive merges every partial
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(tickets + pair, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* all = part + pair * n_split * stride;
  for (int o = tid; o < GH; o += THREADS) {
    const int g = o / hd;
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, __ldcg(all + s * stride + g));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* p = all + s * stride;
      const float e = expf(__ldcg(p + g) - M);
      l = fmaf(__ldcg(p + G + g), e, l);
      a = fmaf(__ldcg(p + 2 * G + o), e, a);
    }
    out[head0 * hd + o] = a / fmaxf(l, 1e-30f);
  }
  if (tid == 0) tickets[pair] = 0;
}

template <typename T, int GM, int LPR>
void launch_one(const void* q, const void* k, const void* v,
                const int* lengths, float* out, float* part, int* tickets,
                int B, int S, int KV, int NG, int G, int hd, int n_split,
                int rows, float scale, cudaStream_t st) {
  const int span = (S + n_split - 1) / n_split;
  flash_decode_kernel<T, GM, LPR>
      <<<dim3(KV * NG, B, n_split), THREADS, 0, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lengths, out, part, tickets, S, KV, NG,
          G, hd, rows, span, scale);
}

template <typename T, int GM>
void launch_g(const void* q, const void* k, const void* v, const int* lengths,
              float* out, float* part, int* tickets, int B, int S, int KV,
              int NG, int G, int hd, int n_split, int rows, int lpr,
              float scale, cudaStream_t st) {
  switch (lpr) {
    case 1: return launch_one<T, GM, 1>(q, k, v, lengths, out, part, tickets,
                                        B, S, KV, NG, G, hd, n_split, rows,
                                        scale, st);
    case 2: return launch_one<T, GM, 2>(q, k, v, lengths, out, part, tickets,
                                        B, S, KV, NG, G, hd, n_split, rows,
                                        scale, st);
    case 4: return launch_one<T, GM, 4>(q, k, v, lengths, out, part, tickets,
                                        B, S, KV, NG, G, hd, n_split, rows,
                                        scale, st);
    case 8: return launch_one<T, GM, 8>(q, k, v, lengths, out, part, tickets,
                                        B, S, KV, NG, G, hd, n_split, rows,
                                        scale, st);
    case 16: return launch_one<T, GM, 16>(q, k, v, lengths, out, part,
                                          tickets, B, S, KV, NG, G, hd,
                                          n_split, rows, scale, st);
    default: return launch_one<T, GM, 32>(q, k, v, lengths, out, part,
                                          tickets, B, S, KV, NG, G, hd,
                                          n_split, rows, scale, st);
  }
}

// Rows of K (or V) per staged tile: TILE_BYTES of padded rows, at most
// MAX_ROWS, a multiple of the rows one pass of the CTA scores (the
// wrapper's split rule, kernels/attention.py tile_rows, computes the same).
template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* out, float* part, int* tickets, int B, int S, int KV, int G,
           int hd, int n_split, cudaStream_t st, float scale) {
  const int cpr = hd * static_cast<int>(sizeof(T)) / 16;
  int lpr = 1;
  while (lpr < cpr) lpr *= 2;
  const int rpp = 32 / lpr * WARPS;
  const int pitch = hd * static_cast<int>(sizeof(T)) + 16;
  int rows = TILE_BYTES / pitch < MAX_ROWS ? TILE_BYTES / pitch : MAX_ROWS;
  rows = rows / rpp * rpp;
  if (rows < rpp) rows = rpp;
  // NG equal head groups of GC <= MAX_G heads (head_groups in
  // kernels/attention.py computes the same)
  int NG = (G + MAX_G - 1) / MAX_G;
  while (G % NG != 0) ++NG;
  const int GC = G / NG;
  if (GC <= 2)
    launch_g<T, 2>(q, k, v, lengths, out, part, tickets, B, S, KV, NG, GC,
                   hd, n_split, rows, lpr, scale, st);
  else if (GC <= 4)
    launch_g<T, 4>(q, k, v, lengths, out, part, tickets, B, S, KV, NG, GC,
                   hd, n_split, rows, lpr, scale, st);
  else
    launch_g<T, 8>(q, k, v, lengths, out, part, tickets, B, S, KV, NG, GC,
                   hd, n_split, rows, lpr, scale, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch flash_decode on `stream`. q (B, 1, KV*G, hd), k and v (B, S, KV,
// hd), contiguous, bf16 (bf16 != 0) or fp32; lengths (B,) int32 on the
// device; out (B, 1, KV*G*hd) fp32; part (B*KV*n_split*(2*G + G*hd)) fp32
// scratch; tickets (B*KV*NG) int32 (NG head groups a kv head, as launch
// counts them), all zero (left zero). Takes any G >= 1 with G*KV < 2^31,
// hd <= 128 with 16-byte rows (hd a multiple of 8 in bf16, of 4 in fp32),
// 16-byte aligned k and v, and 1 <= n_split <= 65535. Returns the CUDA
// error code of the launch (0 = success).
int flash_decode(const void* q, const void* k, const void* v,
                 const int* lengths, float* out, float* part, int* tickets,
                 int B, int S, int KV, int G, int hd, int n_split, int bf16,
                 float scale, void* stream) {
  const int esize = bf16 ? 2 : 4;
  if (B <= 0 || S <= 0 || KV <= 0 || B > 65535 || G < 1 ||
      static_cast<long long>(KV) * G > 2147483647LL || hd < 1 || hd > MAX_HD || (hd * esize) % 16 != 0 ||
      n_split < 1 || n_split > 65535 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, lengths, out, part, tickets,
                                      B, S, KV, G, hd, n_split, st, scale)
              : launch<float>(q, k, v, lengths, out, part, tickets, B, S, KV,
                              G, hd, n_split, st, scale);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
