// Hand-written Hopper (sm_90a) kernels for the fp8_sim codec of the
// compressed collectives.
//
// fp8_encode<HAS_ERR, VEC, NV, WALK> replaces the Pallas kernels behind
//   repro/kernels/codec.py fp8_encode_feedback (HAS_ERR = true) and
//   fp8_encode_residual (HAS_ERR = false), both launched through
//   _fp8_encode_call's pl.pallas_call (codec.py:275).
// fp8_decode_reduce replaces repro/kernels/codec.py fp8_decode_reduce
//   (its pl.pallas_call at codec.py:314).
//
// Bound: streaming passes with a few operations per byte, so the card's
// memory rate bounds them. The fp8 scale belongs to a whole slice (a row of
// 131072 elements on the main path), not to a 256-element block: no
// element can be scaled before the whole slice's amax is known. The
// Pallas kernel kept one slice in one grid step, which a TPU core's VMEM
// holds; one CTA per row here would leave 116 of the 132 SMs idle.
//
// So one thread-block cluster owns a slice: C CTAs of ENC_THREADS threads
// (C = 8 at the main path's S = 16 and S = 8; the launcher takes C from S
// so that S x C stays within the SMs, halves it while half as many CTAs
// would still give every thread a vector, and halves it until
// cudaOccupancyMaxActiveClusters holds all S clusters at once). Clusters
// of 16 (non-portable) ran slower than 8 on the H100, at S = 8 too. One
// launch, no scratch, no memset:
//   1. each thread loads its NV float4 of the row (16-byte loads, all in
//      flight) and forms c = x + err once (one __fadd_rn), keeping c in
//      registers;
//   2. the max of |c| as uint32 bits: redux.sync in the warp, one
//      shared-memory word per CTA (atomicMax), then, behind the cluster
//      barrier, each warp reads the cluster's C words through distributed
//      shared memory. Bits of non-negative floats order like their values,
//      and every NaN's bits (sign cleared by fabsf) sort above +inf's, so a
//      NaN anywhere in the slice wins: NaN propagates. A max is
//      order-free, so the scale is the plain version's bit for bit;
//   3. each thread scales its registers and stores q as one 4-byte word
//      and the residual as a float4 per vector. A CTA arrives at a second
//      cluster barrier once it has read the others' words and waits on it
//      only before it exits, so no CTA's shared memory goes while another
//      still reads it.
// The input is read from device memory once where a CTA's share of the
// row fits its registers (NV <= ENC_NV float4 a thread: 131072 elements a
// slice at C = 8), as at the main path's (16, 131072) and (8, 131072). A longer row (WALK) takes the same steps in chunks of
// ENC_THREADS x ENC_NV float4, walking the CTA's chunks twice: the amax,
// then the encode, whose reads hit L2 where the rows fit it. Where S is
// small (one to eight slices) fewer SMs work: one cluster of at most 8
// CTAs a slice. The load and store phases of a CTA cannot overlap (no
// element is scaled before the slice's amax), which with the barriers
// costs a fixed ~3.5 us a launch on the H100 beyond its bytes. VEC: L % 4 == 0, x, err and res 16-byte aligned and q
// 4-byte aligned; else the same layout with scalar loads and stores.
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

constexpr int ENC_THREADS = 512;
constexpr int ENC_NV = 8;         // float4 a thread kept in registers
constexpr int MAX_CLUSTER = 8;    // portable; 16 measured slower
constexpr float RECIP448 = 0x1.24924ap-9f;  // float32(1/448)
constexpr float FP8_TINY = 1e-30f;
constexpr float FP8_MAX = 448.f;

__device__ __forceinline__ float fp8_to_float(__nv_fp8_storage_t b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The word at `word` (this CTA's shared memory) in the shared memory of
// the cluster's CTA `rank` (distributed shared memory).
__device__ __forceinline__ unsigned load_remote(const unsigned* word,
                                                unsigned rank) {
  const unsigned local =
      static_cast<unsigned>(__cvta_generic_to_shared(word));
  unsigned remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// Four elements of one row from column col on (p is the row's start):
// one 16-byte load where VEC (then col < L means all four are inside),
// else each element alone; columns past L read as 0.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long col, long long L) {
  if (VEC) {
    return col < L ? *reinterpret_cast<const float4*>(p + col)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = col + i < L ? p[col + i] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// Loads this thread's NV vectors of the chunk at column col0 into c (c = x
// + err, one __fadd_rn) and returns the max of their |c| bits. Vector k
// of thread t covers columns col0 + 4 (k ENC_THREADS + t) .. + 3, so each
// warp load is 512 contiguous bytes.
template <bool HAS_ERR, bool VEC, int NV, int THREADS>
__device__ __forceinline__ unsigned load_chunk(
    const float* __restrict__ x, const float* __restrict__ err,
    long long col0, long long L, float4 (&c)[NV]) {
  float4 e[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const long long col = col0 + 4LL * (k * THREADS + threadIdx.x);
    c[k] = load4<VEC>(x, col, L);
    if (HAS_ERR) e[k] = load4<VEC>(err, col, L);
  }
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (HAS_ERR) {
      c[k].x = __fadd_rn(c[k].x, e[k].x);
      c[k].y = __fadd_rn(c[k].y, e[k].y);
      c[k].z = __fadd_rn(c[k].z, e[k].z);
      c[k].w = __fadd_rn(c[k].w, e[k].w);
    }
    m = max(max(m, max(abs_bits(c[k].x), abs_bits(c[k].y))),
            max(abs_bits(c[k].z), abs_bits(c[k].w)));
  }
  return m;
}

// One element: its e4m3 byte against sc, and its residual in *r.
__device__ __forceinline__ unsigned encode1(float c, float sc, float* r) {
  float v = __fdiv_rn(c, sc);
  v = (v != v) ? v : fminf(fmaxf(v, -FP8_MAX), FP8_MAX);
  const __nv_fp8_storage_t f8 =
      __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  *r = __fmaf_rn(-fp8_to_float(f8), sc, c);
  return static_cast<unsigned>(f8);
}

// Scales this thread's NV vectors of the chunk at col0 and stores their
// bytes (one 4-byte word a vector where VEC) and residuals (a float4).
template <bool VEC, int NV, int THREADS>
__device__ __forceinline__ void store_chunk(
    const float4 (&c)[NV], float sc, uint8_t* __restrict__ q,
    float* __restrict__ res, long long col0, long long L) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const long long col = col0 + 4LL * (k * THREADS + threadIdx.x);
    if (col >= L) continue;
    float4 r;
    const unsigned b0 = encode1(c[k].x, sc, &r.x);
    const unsigned b1 = encode1(c[k].y, sc, &r.y);
    const unsigned b2 = encode1(c[k].z, sc, &r.z);
    const unsigned b3 = encode1(c[k].w, sc, &r.w);
    if (VEC) {
      *reinterpret_cast<unsigned*>(q + col) =
          b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
      *reinterpret_cast<float4*>(res + col) = r;
    } else {
      const unsigned b[4] = {b0, b1, b2, b3};
      const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (col + i < L) {
          q[col + i] = static_cast<uint8_t>(b[i]);
          res[col + i] = rv[i];
        }
      }
    }
  }
}

// x, err, res (S, L) row-major f32; q (S, L) uint8; scale (S,). grid (S *
// C): the C consecutive CTAs of a cluster own slice blockIdx.x / C, CTA
// rank r its chunks r, r + C, r + 2C, ... of ENC_THREADS * NV * 4
// columns. !WALK: the launcher made C * chunk >= L, so a CTA has at most
// one chunk and keeps it in registers from load to store. WALK (NV ==
// ENC_NV): the chunks are loaded twice, for the amax and for the encode.
// THREADS is ENC_THREADS in every launch here; scripts/encode_sweep.py
// times other CTA sizes.
template <bool HAS_ERR, bool VEC, int NV, bool WALK,
          int THREADS = ENC_THREADS>
__global__ void __launch_bounds__(THREADS, 1)
fp8_encode(const float* __restrict__ x, const float* __restrict__ err,
           uint8_t* __restrict__ q, float* __restrict__ scale,
           float* __restrict__ res, long long L, int C) {
  __shared__ unsigned cta_max;
  const int rank = static_cast<int>(cluster_rank());
  const long long s = blockIdx.x / C;
  const long long row = s * L;
  const float* xs = x + row;
  const float* es = HAS_ERR ? err + row : nullptr;
  constexpr long long CHUNK = 4LL * THREADS * NV;
  const long long step = CHUNK * C;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) cta_max = 0u;
  float4 c[NV];
  unsigned m = 0u;
  if (!WALK) {
    m = load_chunk<HAS_ERR, VEC, NV, THREADS>(xs, es, rank * CHUNK, L, c);
  }
  __syncthreads();  // cta_max = 0 before any warp's atomicMax
  if (WALK) {
    for (long long col0 = rank * CHUNK; col0 < L; col0 += step)
      m = max(m, load_chunk<HAS_ERR, VEC, NV, THREADS>(xs, es, col0, L, c));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) atomicMax(&cta_max, m);
  cluster_arrive();
  cluster_wait();  // every CTA's word final and visible
  unsigned a = lane < C ? load_remote(&cta_max, lane) : 0u;
  a = __reduce_max_sync(0xffffffffu, a);
  cluster_arrive();  // done with the other CTAs' shared memory

  float sc = __fmul_rn(__uint_as_float(a), RECIP448);
  sc = (sc != sc) ? sc : fmaxf(sc, FP8_TINY);
  if (rank == 0 && threadIdx.x == 0) scale[s] = sc;
  if (!WALK) {
    store_chunk<VEC, NV, THREADS>(c, sc, q + row, res + row, rank * CHUNK,
                                  L);
  } else {
    for (long long col0 = rank * CHUNK; col0 < L; col0 += step) {
      load_chunk<HAS_ERR, VEC, NV, THREADS>(xs, es, col0, L, c);
      store_chunk<VEC, NV, THREADS>(c, sc, q + row, res + row, col0, L);
    }
  }
  cluster_wait();  // no CTA leaves while another may read its word
}

using EncodeKernel = void (*)(const float*, const float*, uint8_t*, float*,
                              float*, long long, int);

template <bool HAS_ERR, bool VEC>
EncodeKernel pick_encode(int nv, bool walk) {
  if (walk) return fp8_encode<HAS_ERR, VEC, ENC_NV, true>;
  switch (nv) {
    case 1: return fp8_encode<HAS_ERR, VEC, 1, false>;
    case 2: return fp8_encode<HAS_ERR, VEC, 2, false>;
    case 4: return fp8_encode<HAS_ERR, VEC, 4, false>;
    default: return fp8_encode<HAS_ERR, VEC, ENC_NV, false>;
  }
}

EncodeKernel pick_encode(bool has_err, bool vec, int nv, bool walk) {
  if (has_err)
    return vec ? pick_encode<true, true>(nv, walk)
               : pick_encode<true, false>(nv, walk);
  return vec ? pick_encode<false, true>(nv, walk)
             : pick_encode<false, false>(nv, walk);
}

// Per (host thread, device, kernel instance, cluster size): the SM count
// and cudaOccupancyMaxActiveClusters, asked once (the main path encodes
// 782 times a step); a cache a thread needs no lock.
constexpr int CACHE_DEVICES = 16;
constexpr int INSTANCES = 20;  // HAS_ERR x VEC x (NV 1, 2, 4, 8; WALK)
constexpr int SIZES = 4;       // C = 1, 2, 4, 8
struct PlanCache {
  int sms[CACHE_DEVICES];
  int clusters[CACHE_DEVICES][INSTANCES][SIZES];  // n + 1; 0 unknown
};
thread_local PlanCache cache = {};

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

int instance_of(bool has_err, bool vec, int nv, bool walk) {
  return (has_err * 2 + vec) * 5 + (walk ? 4 : log2_of(nv));
}

int sm_count(int dev, int* sms) {
  if (cache.sms[dev]) {
    *sms = cache.sms[dev];
    return 0;
  }
  const int rc = static_cast<int>(cudaDeviceGetAttribute(
      sms, cudaDevAttrMultiProcessorCount, dev));
  if (!rc) cache.sms[dev] = *sms;
  return rc;
}

cudaLaunchConfig_t cluster_config(long long ctas, int C,
                                  cudaLaunchAttribute* attr,
                                  int threads = ENC_THREADS) {
  cudaLaunchConfig_t cfg = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(threads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cudaOccupancyMaxActiveClusters of instance i (kernel k) in clusters of
// C CTAs on device dev.
int max_clusters(EncodeKernel k, int i, int C, int dev, int* n) {
  int& known = cache.clusters[dev][i][log2_of(C)];
  if (known) {
    *n = known - 1;
    return 0;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(C, C, &attr);
  const int rc = static_cast<int>(cudaOccupancyMaxActiveClusters(n, k,
                                                                 &cfg));
  if (!rc) known = *n + 1;
  return rc;
}

// The cluster size C, float4 a thread NV and WALK of one encode over (S,
// L): C from S (S x C at most the SM count, C <= 8), no larger than a
// row needs (half as many CTAs must not give every thread a vector
// already), then halved until all S clusters fit on the card at once.
int encode_plan(bool has_err, bool vec, long long S, long long L,
                EncodeKernel* k, int* C_out, int* nv_out, bool* walk_out,
                int* n_out) {
  int dev = 0, sms = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc) return rc;
  if (dev < 0 || dev >= CACHE_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  rc = sm_count(dev, &sms);
  if (rc) return rc;
  const long long per_vec = 4LL * ENC_THREADS;  // columns a CTA's vector
  int C = 1;
  while (C < MAX_CLUSTER && S * 2 * C <= sms) C *= 2;
  while (C > 1 && (L + C / 2 - 1) / (C / 2) <= per_vec) C /= 2;
  for (;;) {
    const long long per_cta = (L + C - 1) / C;
    int nv = 1;
    while (nv < ENC_NV && nv * per_vec < per_cta) nv *= 2;
    const bool walk = nv * per_vec < per_cta;
    *k = pick_encode(has_err, vec, nv, walk);
    int n = 0;
    rc = max_clusters(*k, instance_of(has_err, vec, nv, walk), C, dev, &n);
    if (rc) return rc;
    if (C == 1 || (n > 0 && n >= S)) {
      *C_out = C;
      *nv_out = nv;
      *walk_out = walk;
      *n_out = n;
      return 0;
    }
    C /= 2;
  }
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
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

}  // namespace

extern "C" {

// Launch the encode on `stream` over S slices of length L > 0: one
// fp8_encode launch in clusters (encode_plan). err == nullptr selects the
// residual-only variant. Returns the first CUDA error (0 = success).
int codec_fp8_encode(const float* x, const float* err, uint8_t* q,
                     float* scale, float* res, long long S, long long L,
                     void* stream) {
  if (S <= 0 || L <= 0) return 0;
  const bool has_err = err != nullptr;
  const bool vec = L % 4 == 0 && aligned(x, 16) && aligned(res, 16) &&
                   aligned(q, 4) && (!has_err || aligned(err, 16));
  EncodeKernel k = nullptr;
  int C = 1, nv = 1, n = 0;
  bool walk = false;
  int rc = encode_plan(has_err, vec, S, L, &k, &C, &nv, &walk, &n);
  if (rc) return rc;
  if (S > 2147483647LL / C) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(S * C, C, &attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, k, x, err, q, scale, res,
                                           L, C));
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

// What codec_fp8_encode would launch over (S, L): plan[0] the cluster
// size C, plan[1] the float4 a thread NV, plan[2] 1 where it walks the row
// twice, plan[3] cudaOccupancyMaxActiveClusters at C. Returns the CUDA
// error (0 = success).
int codec_fp8_encode_plan(long long S, long long L, int has_err, int vec,
                          int* plan) {
  if (S <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  EncodeKernel k = nullptr;
  bool walk = false;
  const int rc = encode_plan(has_err != 0, vec != 0, S, L, &k, &plan[0],
                             &plan[1], &walk, &plan[3]);
  plan[2] = walk;
  return rc;
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
