// Hand-written Hopper (sm_90a) kernels for the RWKV-6 (Finch) WKV recurrence:
// the time-mixing core of every rwkv layer, on prefill and on every decode
// tick of the serving engine.
//
// rwkv6_wkv_tick, rwkv6_wkv and rwkv6_wkv_chunked replace the Pallas
// kernel repro/kernels/rwkv6_wkv.py rwkv6_wkv (its pl.pallas_call at
// rwkv6_wkv.py:59, body _kernel at :21).
//
// What they compute (the Pallas body, step by step in fp32): per batch row b
// and head h, with the (hd x hd) state S starting at s0[b, h],
//   kv_ij = k_i * v_j
//   y_j   = sum_i r_i * (S_ij + u_i * kv_ij)
//   S_ij  = w_i * S_ij + kv_ij
// for t = 0 .. T-1, writing y[b, t, h, :] each step and S to sT[b, h] once
// at the end. r, k, v are (B, T, H, hd), all bf16 or all fp32; w (B, T, H,
// hd), u (H, hd), s0 and sT (B, H, hd, hd) are fp32; y is fp32. sT may be
// s0 itself (a layer updates its cache's state in place).
//
// Bound: a decode tick (T = 1) reads and writes the state once and does 5
// flops per state element, below the card's ops-per-byte ridge: the memory
// rate bounds it (0.0026 ms at B 8, H 32, hd 64). A long prefill (B 1, T
// 1024) does 5*T*hd^2 flops per head on little data: the fp32 rate bounds
// it (0.0101 ms). The wrapper (kernels/rwkv.py) takes the tick kernel for
// calls of fewer than 16 steps and the chunked one from 16 steps on; the
// recurrent kernel runs only when asked for by name.
//
// rwkv6_wkv_tick, the tick kernel (rwkv6_wkv_tick_kernel). The tick's 4
// MiB of state must be in flight at once to come near the memory rate, so
// a (b, h) state is spread over 4 * HD threads (256 at hd 64: 65,536 at
// B 8, H 32), each holding 4 columns of hd / 16 rows as float4s, all
// loaded before any use, each warp load reading whole rows; the state is
// written with a streaming cache hint. No staging: a is worked
// out by every warp for itself by shuffles, and y's row partials are
// joined by shuffles within a warp and then across warps in one pass
// through shared memory, behind the step's one barrier (after the state
// update and, at the last step, its stores). On the H100 whole-row warp
// loads ran faster than warps of 8 columns each reading a 32-byte sector
// of 16 rows (which needed no barrier at all). It walks T steps with the
// state in registers.
//
// rwkv6_wkv, the recurrent kernel (the first tick kernel, kept for
// comparison at any T). One CTA per (b, h) and a
// loop over time take the place of the TPU grid's sequential chunk axis:
// thread j holds column j of S in registers for the whole walk, so s0 is
// read and sT written once. The bonus term needs no work per state
// element: sum_i r_i u_i k_i v_j = v_j * a with a = sum_i r_i u_i k_i, one
// dot product per step, so each step is 5 flops per state element. Per run
// of CH steps the CTA stages r, k, w and v (as fp32) in shared memory and
// works out each step's a, one step per thread; every thread then walks
// the run reading r_i, k_i and w_i as broadcast float4s, with four partial
// sums (i mod 4). B 8, H 32 gives 256 CTAs at the tick; a B 1 prefill would
// give 32, each walking T steps in turn, hence the chunked form.
//
// rwkv6_wkv_chunked, the chunked form (the prefill), in chunks of L = 16
// steps. Within a chunk, with D_t = prod_{tau<=t} w_tau and E_s =
// prod_{tau>s} w_tau counted from the chunk's start and to its end:
//   y_t = (r_t * D_{t-1}) @ S0 + sum_{s<=t} A_ts v_s
//   S_L = D_{L-1} * S0 + sum_s (k_s * E_s)^T v_s
// with A_ts = sum_i r_ti k_si prod_{s<tau<t} w_tau,i below the diagonal and
// A_tt = sum_i r_ti u_i k_ti. Column j of S and y_j depend only on column
// j, so a (b, h) pair splits over column blocks. Two launches, shape (b) of
// the choice: wkv_chunk_intra runs every chunk of every (b, h) at once
// (2048 CTAs at B 1, T 1024, H 32) and writes A @ v and the chunk's decayed
// operands; wkv_chunk_state then walks the chunks in order, one CTA per
// (b, h, 16 columns) (128 CTAs there) with its slice of S in registers,
// doing the two products per chunk on the tensor cores. The intra pass's
// work is parallel in time, so only the state pass's short per-chunk step
// is sequential; a single launch (shape (a)) would recompute A in each
// column block's CTA on that sequential path.
//
// Decays: on the model path w = exp(-exp(dd)) may be subnormal or exactly
// 0. Every decay here is a product of decays (D, E, and A's running
// product x_i = k_si prod w, one multiply per step), never a quotient or a
// difference of logarithms: a decay of 0 gives exact zeros, never inf or
// NaN, and products keep their relative accuracy.
//
// Precision: fp32 throughout. The state pass's products run on the tensor
// cores as 3xTF32 (each fp32 operand split into two tf32 parts, three
// products; about 2^-22 of each product's size, where plain TF32 keeps
// 2^-11 and would not hold 1e-4 on y). The library is built with
// -fmad=false, so every fused multiply-add is an explicit __fmaf_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_HD = 128;
// elements of one staged array (CH steps of HD lanes): 4 arrays of 8 KB
constexpr int STAGE = 2048;

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// grid (H, B), HD threads: one CTA per (head, batch row), thread j owns
// column j of the state; lanes j >= hd hold zeros and write nothing.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
rwkv6_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* s0,
                 float* __restrict__ y, float* sT, int steps, int H, int hd) {
  constexpr int CH = STAGE / HD;  // steps staged per run
  __shared__ __align__(16) float r_s[CH][HD];
  __shared__ __align__(16) float k_s[CH][HD];
  __shared__ __align__(16) float w_s[CH][HD];
  __shared__ __align__(16) float v_s[CH][HD];
  __shared__ __align__(16) float u_s[HD];
  __shared__ float a_s[CH];  // a = sum_i r_i * u_i * k_i, per staged step

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const bool live = j < hd;
  const long long state0 = (b * H + h) * static_cast<long long>(hd) * hd;

  // column j of the state: S[i] = s0[b, h, i, j]
  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    S[i] = (live && i < hd) ? s0[state0 + static_cast<long long>(i) * hd + j]
                            : 0.f;
  u_s[j] = live ? u[static_cast<long long>(h) * hd + j] : 0.f;

  const long long row_stride = static_cast<long long>(H) * hd;  // one step
  const long long lane0 = b * steps * row_stride
                          + static_cast<long long>(h) * hd + j;
  for (int t0 = 0; t0 < steps; t0 += CH) {
    const int n = min(CH, steps - t0);
    __syncthreads();  // the previous run has been read by every thread
    for (int c = 0; c < n; ++c) {
      const long long at = lane0 + (t0 + c) * row_stride;
      r_s[c][j] = live ? to_f32(r[at]) : 0.f;
      k_s[c][j] = live ? to_f32(k[at]) : 0.f;
      v_s[c][j] = live ? to_f32(v[at]) : 0.f;
      w_s[c][j] = live ? w[at] : 0.f;
    }
    __syncthreads();
    for (int c = j; c < n; c += HD) {
      // lane m = i + c (mod HD): the threads of a warp read 32 banks
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const int m = (i + c) & (HD - 1);
        a[i & 3] = __fmaf_rn(__fmul_rn(r_s[c][m], u_s[m]), k_s[c][m],
                             a[i & 3]);
      }
      a_s[c] = __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3]));
    }
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      const float vj = v_s[c][j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s[c]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[c]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[c]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < HD / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv4[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          acc[e] = __fmaf_rn(rv[e], S[i], acc[e]);
          S[i] = __fmaf_rn(wv[e], S[i], __fmul_rn(kv4[e], vj));
        }
      }
      if (live)
        y[lane0 + (t0 + c) * row_stride] = __fmaf_rn(
            vj, a_s[c],
            __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])));
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < HD; ++i)
      if (i < hd) sT[state0 + static_cast<long long>(i) * hd + j] = S[i];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B,
           int steps, int H, int hd, cudaStream_t st) {
  const dim3 grid(H, B);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (hd <= 32)
    rwkv6_wkv_kernel<T, 32><<<grid, 32, 0, st>>>(rt, kt, vt, w, u, s0, y, sT,
                                                 steps, H, hd);
  else if (hd <= 64)
    rwkv6_wkv_kernel<T, 64><<<grid, 64, 0, st>>>(rt, kt, vt, w, u, s0, y, sT,
                                                 steps, H, hd);
  else
    rwkv6_wkv_kernel<T, 128><<<grid, 128, 0, st>>>(rt, kt, vt, w, u, s0, y,
                                                   sT, steps, H, hd);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tick kernel (rwkv6_wkv_tick): calls of a few steps, the decode tick.
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;

// grid (H, B), 4 * HD threads: one CTA per (b, h) state, NW = HD / 8
// warps. Warp w owns state rows [8w, 8w + 8); LPR = HD / 4 of its lanes
// cover a row, 4 columns each (j0 = 4 (lane % LPR)), so one warp load
// reads 32 / LPR whole rows, contiguous. Lane l holds the 4 columns of rows
// i = 8w + q + R m (q = lane / LPR, R = 32 / LPR, m < RPT = HD / 16) in
// registers across the steps, read and written as float4s (VEC: hd a
// multiple of 4 and s0, sT 16-byte aligned; scalars otherwise), written
// with a streaming cache hint (the state is not read again before the next
// tick); lanes and rows past hd hold zeros and write nothing. EXACT: VEC
// and hd == HD, so no lane or row is past hd and no access needs a
// predicate; ONE (EXACT only): a single step, known when compiling, so the
// step is straight-line code (the predicates and the runtime step loop
// each slowed the rwkv6 tick on the H100).
// Every state load is issued before the first use. Per step, in fp32:
//   a   = sum_i (r_i u_i) k_i: lane l sums i = l + 32 m in order of m,
//         then a butterfly over the warp's 32 lanes (xor 16, 8, 4, 2, 1)
//   p   = sum_m r_i S_ij over the lane's rows in order of m, then a
//         butterfly over the warp's row groups q (lane xor 16 .. LPR),
//         written to shared memory by the lanes of q = 0
//   S_ij = fma(w_i, S_ij, k_i v_j), stored at the last step
//   one barrier; thread j < HD: y_j = fma(v_j, a, sum over warps w in
//   order, from 0, of p_w,j)
// A butterfly leaves the same sum, bit for bit, in every lane it joins.
// The partials alternate between two buffers, so one barrier per step
// orders them. Each thread reads its own state elements before it writes
// them, so sT may be s0.
template <typename T, int HD, bool VEC, bool EXACT, bool ONE>
__global__ void __launch_bounds__(4 * HD)
rwkv6_wkv_tick_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* s0,
                      float* __restrict__ y, float* sT, int steps, int H,
                      int hd) {
  constexpr int NW = HD / 8;      // warps: 8 state rows each
  constexpr int LPR = HD / 4;     // lanes per state row
  constexpr int R = 32 / LPR;     // rows per warp load
  constexpr int RPT = 8 / R;      // state rows per thread
  constexpr int IPL = HD / 32;    // a's terms per lane
  __shared__ __align__(16) float part[2][NW][HD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane / LPR;
  const int j0 = 4 * (lane % LPR);
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const long long state0 = (b * H + h) * static_cast<long long>(hd) * hd;

  float S[RPT][4];
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int i = 8 * warp + q + R * m;
    const float* row = s0 + state0 + static_cast<long long>(i) * hd + j0;
    if (VEC) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (EXACT || (i < hd && j0 < hd))
        s = *reinterpret_cast<const float4*>(row);
      S[m][0] = s.x;
      S[m][1] = s.y;
      S[m][2] = s.z;
      S[m][3] = s.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        S[m][c] = (i < hd && j0 + c < hd) ? row[c] : 0.f;
    }
  }
  float ul[IPL];
#pragma unroll
  for (int m = 0; m < IPL; ++m) {
    const int i = lane + 32 * m;
    ul[m] = EXACT || i < hd ? u[static_cast<long long>(h) * hd + i] : 0.f;
  }

  const long long row_stride = static_cast<long long>(H) * hd;  // one step
  const long long head = b * steps * row_stride
                         + static_cast<long long>(h) * hd;
  const int n = ONE ? 1 : steps;
  for (int t = 0; t < n; ++t) {
    const long long at = head + t * row_stride;
    float ri[RPT], ki[RPT], wi[RPT], vj[4], ra[IPL], ka[IPL];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int i = 8 * warp + q + R * m;
      const bool live = EXACT || i < hd;
      ri[m] = live ? to_f32(r[at + i]) : 0.f;
      ki[m] = live ? to_f32(k[at + i]) : 0.f;
      wi[m] = live ? w[at + i] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      vj[c] = EXACT || j0 + c < hd ? to_f32(v[at + j0 + c]) : 0.f;
#pragma unroll
    for (int m = 0; m < IPL; ++m) {
      const int i = lane + 32 * m;
      const bool live = EXACT || i < hd;
      ra[m] = live ? to_f32(r[at + i]) : 0.f;
      ka[m] = live ? to_f32(k[at + i]) : 0.f;
    }

    float a = 0.f;
#pragma unroll
    for (int m = 0; m < IPL; ++m)
      a = __fmaf_rn(__fmul_rn(ra[m], ul[m]), ka[m], a);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a = __fadd_rn(a, __shfl_xor_sync(FULL, a, o));

    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < RPT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[c] = __fmaf_rn(ri[m], S[m][c], p[c]);
#pragma unroll
    for (int m = 0; m < RPT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        S[m][c] = __fmaf_rn(wi[m], S[m][c], __fmul_rn(ki[m], vj[c]));
    if (t == n - 1) {
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int i = 8 * warp + q + R * m;
        if (!EXACT && i >= hd) continue;
        float* row = sT + state0 + static_cast<long long>(i) * hd + j0;
        if (VEC) {
          if (EXACT || j0 < hd)
            __stcs(reinterpret_cast<float4*>(row),
                   make_float4(S[m][0], S[m][1], S[m][2], S[m][3]));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (j0 + c < hd) __stcs(row + c, S[m][c]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o >= LPR; o >>= 1)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[c] = __fadd_rn(p[c], __shfl_xor_sync(FULL, p[c], o));
    float* pw = part[t & 1][warp];
    if (q == 0)
      *reinterpret_cast<float4*>(pw + j0) = make_float4(p[0], p[1], p[2],
                                                        p[3]);
    __syncthreads();
    if (threadIdx.x < (EXACT ? HD : hd)) {
      const int j = threadIdx.x;
      float sum = 0.f;
#pragma unroll
      for (int x = 0; x < NW; ++x) sum = __fadd_rn(sum, part[t & 1][x][j]);
      y[at + j] = __fmaf_rn(to_f32(v[at + j]), a, sum);
    }
  }
}

template <typename T, int HD>
void launch_tick_hd(const T* r, const T* k, const T* v, const float* w,
                    const float* u, const float* s0, float* y, float* sT,
                    int B, int steps, int H, int hd, bool vec,
                    cudaStream_t st) {
  const dim3 grid(H, B);
  if (vec && hd == HD && steps == 1)
    rwkv6_wkv_tick_kernel<T, HD, true, true, true><<<grid, 4 * HD, 0, st>>>(
        r, k, v, w, u, s0, y, sT, steps, H, hd);
  else if (vec && hd == HD)
    rwkv6_wkv_tick_kernel<T, HD, true, true, false><<<grid, 4 * HD, 0, st>>>(
        r, k, v, w, u, s0, y, sT, steps, H, hd);
  else if (vec)
    rwkv6_wkv_tick_kernel<T, HD, true, false, false><<<grid, 4 * HD, 0, st>>>(
        r, k, v, w, u, s0, y, sT, steps, H, hd);
  else
    rwkv6_wkv_tick_kernel<T, HD, false, false, false>
        <<<grid, 4 * HD, 0, st>>>(r, k, v, w, u, s0, y, sT, steps, H, hd);
}

template <typename T>
int launch_tick(const void* r, const void* k, const void* v, const float* w,
                const float* u, const float* s0, float* y, float* sT, int B,
                int steps, int H, int hd, cudaStream_t st) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(s0) % 16 == 0
                   && reinterpret_cast<uintptr_t>(sT) % 16 == 0;
  if (hd <= 32)
    launch_tick_hd<T, 32>(rt, kt, vt, w, u, s0, y, sT, B, steps, H, hd, vec,
                          st);
  else if (hd <= 64)
    launch_tick_hd<T, 64>(rt, kt, vt, w, u, s0, y, sT, B, steps, H, hd, vec,
                          st);
  else
    launch_tick_hd<T, 128>(rt, kt, vt, w, u, s0, y, sT, B, steps, H, hd,
                           vec, st);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The chunked form (rwkv6_wkv_chunked): wkv_chunk_intra over every chunk at
// once, then wkv_chunk_state along the chunks. Steps past T are padded with
// r = k = v = 0 and w = 1, which leaves every formula below exact for a
// last, shorter chunk.
// ---------------------------------------------------------------------------

constexpr int L = 16;          // steps per chunk
constexpr int NG = 8;          // groups of state rows in the pair matrix
constexpr int INTRA_THREADS = 128;
constexpr int JB = 16;         // state columns per CTA of the state pass

// grid (chunks, H, B), INTRA_THREADS threads: one CTA per (chunk, head,
// batch row). Writes yi_t = sum_{s<=t} A_ts v_s for the chunk's steps, with
// A_ts = sum_i r_ti k_si prod_{s<tau<t} w_tau,i below the diagonal and
// A_tt = sum_i r_ti u_i k_ti, and the chunk's decayed operands for the
// state pass, all in chunk blocks of rows of HD (zeros past hd): v as
// fp32, rd_t = r_t * D_{t-1}, ke_s = k_s * E_s and dl = D_{L-1}, with
// D_t = prod_{tau<=t} w_tau and E_s = prod_{tau>s} w_tau inside the chunk.
// Thread (s, group) walks t forward from s, carrying x_i = k_si
// prod_{s<tau<t} w_tau,i (one multiply per step) over its group of HD / NG
// rows i; the groups' partial sums are then added in group order. Every
// decay is a product of decays, never a quotient: a decay of 0 or a
// subnormal one gives 0 or a tiny term, never inf or NaN.
template <typename T, int HD>
__global__ void __launch_bounds__(INTRA_THREADS)
wkv_chunk_intra(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ yi,
                float* __restrict__ vf, float* __restrict__ rd,
                float* __restrict__ ke, float* __restrict__ dl, int steps,
                int H, int hd) {
  constexpr int GI = HD / NG;  // rows i per group
  constexpr int NLD = L * HD / INTRA_THREADS;
  __shared__ __align__(16) float r_s[L][HD];
  __shared__ __align__(16) float k_s[L][HD];
  __shared__ __align__(16) float w_s[L][HD];
  __shared__ __align__(16) float v_s[L][HD];
  __shared__ __align__(16) float u_s[HD];
  __shared__ float part_s[NG][L][L + 1];
  __shared__ float a_s[L][L + 1];

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int t0 = c * L;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int n = min(L, steps - t0);
  const long long row_stride = static_cast<long long>(H) * hd;
  const long long base = (b * steps + t0) * row_stride
                         + static_cast<long long>(h) * hd;
  // this chunk's block of every [L][HD] operand, and of dl ([HD])
  const long long blk = (b * H + h) * static_cast<long long>(gridDim.x) + c;

  {
    float rr[NLD], kk[NLD], vv[NLD], ww[NLD];
#pragma unroll
    for (int m = 0; m < NLD; ++m) {
      const int o = tid + m * INTRA_THREADS, t = o / HD, i = o % HD;
      const bool live = t < n && i < hd;
      const long long at = base + t * row_stride + i;
      rr[m] = live ? to_f32(r[at]) : 0.f;
      kk[m] = live ? to_f32(k[at]) : 0.f;
      vv[m] = live ? to_f32(v[at]) : 0.f;
      ww[m] = live ? w[at] : 1.f;
    }
#pragma unroll
    for (int m = 0; m < NLD; ++m) {
      const int o = tid + m * INTRA_THREADS, t = o / HD, i = o % HD;
      r_s[t][i] = rr[m];
      k_s[t][i] = kk[m];
      v_s[t][i] = vv[m];
      w_s[t][i] = ww[m];
      vf[blk * L * HD + o] = vv[m];
    }
  }
  for (int i = tid; i < HD; i += INTRA_THREADS)
    u_s[i] = i < hd ? u[static_cast<long long>(h) * hd + i] : 0.f;
  __syncthreads();

  // the decays: D forward for row i < HD, E backward for row i - HD (rows
  // past hd are written as zeros: the state pass copies whole rows)
  for (int q = tid; q < 2 * HD; q += INTRA_THREADS) {
    const int i = q % HD;
    float d = 1.f;
    if (q < HD) {
#pragma unroll
      for (int t = 0; t < L; ++t) {
        rd[(blk * L + t) * HD + i] = __fmul_rn(r_s[t][i], d);
        d = __fmul_rn(d, w_s[t][i]);
      }
      dl[blk * HD + i] = i < hd ? d : 0.f;
    } else {
#pragma unroll
      for (int t = L - 1; t >= 0; --t) {
        ke[(blk * L + t) * HD + i] = __fmul_rn(k_s[t][i], d);
        d = __fmul_rn(d, w_s[t][i]);
      }
    }
  }

  for (int p = tid; p < L * NG; p += INTRA_THREADS) {
    const int s = p % L, i0 = (p / L) * GI;
    float x[GI];
#pragma unroll
    for (int e = 0; e < GI; ++e) x[e] = k_s[s][i0 + e];
    float part[L];
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const float4* r4 = reinterpret_cast<const float4*>(&r_s[t][i0]);
      float a = 0.f;
      if (t == s) {
        const float4* u4 = reinterpret_cast<const float4*>(&u_s[i0]);
#pragma unroll
        for (int q = 0; q < GI / 4; ++q) {
          const float4 rr = r4[q], uu = u4[q];
          a = __fmaf_rn(__fmul_rn(rr.x, uu.x), x[4 * q], a);
          a = __fmaf_rn(__fmul_rn(rr.y, uu.y), x[4 * q + 1], a);
          a = __fmaf_rn(__fmul_rn(rr.z, uu.z), x[4 * q + 2], a);
          a = __fmaf_rn(__fmul_rn(rr.w, uu.w), x[4 * q + 3], a);
        }
      } else if (t > s) {
        const float4* w4 = reinterpret_cast<const float4*>(&w_s[t][i0]);
#pragma unroll
        for (int q = 0; q < GI / 4; ++q) {
          const float4 rr = r4[q], ww = w4[q];
          a = __fmaf_rn(rr.x, x[4 * q], a);
          a = __fmaf_rn(rr.y, x[4 * q + 1], a);
          a = __fmaf_rn(rr.z, x[4 * q + 2], a);
          a = __fmaf_rn(rr.w, x[4 * q + 3], a);
          x[4 * q] = __fmul_rn(x[4 * q], ww.x);
          x[4 * q + 1] = __fmul_rn(x[4 * q + 1], ww.y);
          x[4 * q + 2] = __fmul_rn(x[4 * q + 2], ww.z);
          x[4 * q + 3] = __fmul_rn(x[4 * q + 3], ww.w);
        }
      }
      part[t] = a;
    }
#pragma unroll
    for (int t = 0; t < L; ++t) part_s[p / L][t][s] = part[t];
  }
  __syncthreads();
  for (int o = tid; o < L * L; o += INTRA_THREADS) {
    const int t = o / L, s = o % L;
    float a = 0.f;
    if (s <= t)
      for (int g = 0; g < NG; ++g) a = __fadd_rn(a, part_s[g][t][s]);
    a_s[t][s] = a;
  }
  __syncthreads();
  // y: thread (column j, block of TB steps), its TB sums in registers
  constexpr int TB = L * HD / INTRA_THREADS;
  const int j = tid % HD, tb = (tid / HD) * TB;
  float acc[TB];
#pragma unroll
  for (int q = 0; q < TB; ++q) acc[q] = 0.f;
#pragma unroll
  for (int s = 0; s < L; ++s) {
    const float vs = v_s[s][j];
#pragma unroll
    for (int q = 0; q < TB; ++q)
      if (tb + q >= s) acc[q] = __fmaf_rn(a_s[tb + q][s], vs, acc[q]);
  }
#pragma unroll
  for (int q = 0; q < TB; ++q) yi[(blk * L + tb + q) * HD + j] = acc[q];
}

// 3xTF32 on the tensor cores: x = hi + lo, both tf32 (rounded to nearest),
// and a * b taken as al * bh + ah * bl + ah * bh in fp32 accumulation: the
// product of two fp32 values to about 2^-22 of its size, where one tf32
// product would keep 2^-11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                          uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b for an m16n8k8 tile in 3xTF32 (a: 4 fp32 fragment values, b: 2)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                           const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
#pragma unroll
  for (int q = 0; q < 2; ++q) split_tf32(b[q], bh[q], bl[q]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// grid (ceil(hd / JB), H, B), 2 * HD threads: one CTA per (block of JB
// state columns, head, batch row), walking the chunks in order with its
// (HD x JB) slice of the state in registers. Warp w holds rows [16w, 16w +
// 16) of the slice as two m16n8 accumulator tiles. Per chunk, from the
// intra pass's rd, ke and dl, on the tensor cores (3xTF32):
//   y_t += rd_t @ S          (y holds the intra-chunk part; warp w adds its
//                             rows' share, the warps' shares summed in order)
//   S    = dl * S + ke^T @ v
// The operands of the chunk after next are loaded into registers while
// this one is worked. s0 is read and sT written once per slice, so sT may
// be s0.
// The state pass's shared memory: a ring of RING chunks of its operands,
// filled by cp.async, so that one barrier per chunk orders everything: rd
// and ke (rows padded to P), dl, and its JB columns of v and of y's intra
// part; each warp's share of y (2 chunks) and its S tile (for its B
// operand). Above 48 KB: dynamic.
template <int HD>
struct StateSmem {
  static constexpr int NW = 2 * HD / 32;  // warps, one 16-row tile of S each
  static constexpr int P = HD + 4;
  static constexpr int PJ = JB + 8;
  static constexpr int RING = 4;
  float rd[RING][L][P];
  float ke[RING][L][P];
  float dl[RING][HD];
  float v[RING][L][PJ];
  float yi[RING][L][PJ];
  float yw[2][NW][L][PJ];
  float sb[NW][16][PJ];
};

// grid (ceil(hd / JB), H, B), 2 * HD threads: one CTA per (block of JB
// state columns, head, batch row), walking the chunks in order with its
// (HD x JB) slice of the state in registers. Warp w holds rows [16w, 16w +
// 16) of the slice as two m16n8 accumulator tiles. Per chunk c, from the
// intra pass's blocks, on the tensor cores (3xTF32):
//   y_t = yi_t + rd_t @ S   (warp w's rows' share, into a ring; the shares
//                            are added in warp order a chunk later)
//   S   = dl * S + ke^T @ v
// Chunk c + 2's operands are copied in while chunk c is worked, one
// barrier per chunk. s0 is read and sT written once per slice, so sT may
// be s0.
template <typename T, int HD>
__global__ void __launch_bounds__(2 * HD)
wkv_chunk_state(const float* __restrict__ yi, const float* __restrict__ vf,
                const float* __restrict__ rd, const float* __restrict__ ke,
                const float* __restrict__ dl, const float* s0,
                float* __restrict__ y, float* sT, int steps, int H, int hd) {
  using Smem = StateSmem<HD>;
  constexpr int NT = 2 * HD;           // threads
  constexpr int NW = Smem::NW;
  constexpr int RING = Smem::RING;
  constexpr int CPR = HD / 4;          // 16-byte pieces per row
  constexpr int NO = (L * JB + NT - 1) / NT;  // y outputs per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp;            // this warp's first state row
  const int j0 = blockIdx.x * JB;      // the slice's first column
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int n_chunks = (steps + L - 1) / L;
  const int rs = H * hd;               // one step of y
  const long long head = b * steps * static_cast<long long>(rs)
                         + static_cast<long long>(h) * hd;
  const long long blk0 = (b * H + h) * static_cast<long long>(n_chunks);
  const long long state0 = (b * H + h) * static_cast<long long>(hd) * hd;

  // the accumulator tiles: Sc[nt] holds rows r0 + g (0, 1) and r0 + g + 8
  // (2, 3), columns j0 + nt * 8 + 2 * t4 + 0 (0, 2) and + 1 (1, 3)
  float Sc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = r0 + g + (q >> 1) * 8, j = j0 + nt * 8 + 2 * t4 + (q & 1);
      Sc[nt][q] = (i < hd && j < hd)
                      ? s0[state0 + static_cast<long long>(i) * hd + j]
                      : 0.f;
    }

  // chunk c's operands into ring slot c % RING, by cp.async
  auto stage = [&](int c) {
    if (c < n_chunks) {
      const int slot = c % RING;
      const long long at = (blk0 + c) * L * HD;
      for (int q = tid; q < L * CPR; q += NT) {
        const int t = q / CPR, x = (q % CPR) * 4;
        cp_async16(&sm.rd[slot][t][x], rd + at + t * HD + x);
        cp_async16(&sm.ke[slot][t][x], ke + at + t * HD + x);
      }
      for (int q = tid; q < L * JB / 4; q += NT) {
        const int t = q / (JB / 4), x = (q % (JB / 4)) * 4;
        cp_async16(&sm.v[slot][t][x], vf + at + t * HD + j0 + x);
        cp_async16(&sm.yi[slot][t][x], yi + at + t * HD + j0 + x);
      }
      if (tid < CPR)
        cp_async16(&sm.dl[slot][tid * 4], dl + (blk0 + c) * HD + tid * 4);
    }
    cp_async_commit();
  };
  // y of chunk c: its intra part plus the warps' shares, in warp order
  auto finish = [&](int c) {
    const int t0 = c * L, n = min(L, steps - t0);
    float* yo = y + head + static_cast<long long>(t0) * rs + j0;
#pragma unroll
    for (int m = 0; m < NO; ++m) {
      const int o = tid + m * NT, t = o / JB, jl = o % JB;
      if (o < L * JB && t < n && j0 + jl < hd) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) a = __fadd_rn(a, sm.yw[c % 2][w][t][jl]);
        yo[t * rs + jl] = __fadd_rn(sm.yi[c % RING][t][jl], a);
      }
    }
  };

  stage(0);
  stage(1);
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % RING;
    cp_async_wait<1>();  // chunk c's ring slot has landed (this thread's)
    __syncthreads();     // ... everyone's; chunk c - 1's shares are in
    stage(c + 2);
    // this warp's tile of S as it stands, for y's B operand
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sm.sb[warp][g + (q >> 1) * 8][nt * 8 + 2 * t4 + (q & 1)] = Sc[nt][q];
    __syncwarp();
    const float d0 = sm.dl[slot][r0 + g], d1 = sm.dl[slot][r0 + g + 8];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      Sc[nt][0] = __fmul_rn(d0, Sc[nt][0]);
      Sc[nt][1] = __fmul_rn(d0, Sc[nt][1]);
      Sc[nt][2] = __fmul_rn(d1, Sc[nt][2]);
      Sc[nt][3] = __fmul_rn(d1, Sc[nt][3]);
    }
    // two independent chains on the tensor cores, interleaved: y's share of
    // this warp's rows, rd[:, r0:r0+16] @ S[r0:r0+16, :], and the update
    // S = dl * S + ke^T @ v
    float yc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int k0 = 0; k0 < 16; k0 += 8) {
      const float a[4] = {sm.rd[slot][g][r0 + k0 + t4],
                          sm.rd[slot][g + 8][r0 + k0 + t4],
                          sm.rd[slot][g][r0 + k0 + t4 + 4],
                          sm.rd[slot][g + 8][r0 + k0 + t4 + 4]};
      const float e[4] = {sm.ke[slot][k0 + t4][r0 + g],
                          sm.ke[slot][k0 + t4][r0 + g + 8],
                          sm.ke[slot][k0 + t4 + 4][r0 + g],
                          sm.ke[slot][k0 + t4 + 4][r0 + g + 8]};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float bs[2] = {sm.sb[warp][k0 + t4][nt * 8 + g],
                             sm.sb[warp][k0 + t4 + 4][nt * 8 + g]};
        const float bv[2] = {sm.v[slot][k0 + t4][nt * 8 + g],
                             sm.v[slot][k0 + t4 + 4][nt * 8 + g]};
        mma_3xtf32(yc[nt], a, bs);
        mma_3xtf32(Sc[nt], e, bv);
      }
    }
    if (c > 0) finish(c - 1);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sm.yw[c % 2][warp][g + (q >> 1) * 8][nt * 8 + 2 * t4 + (q & 1)] =
            yc[nt][q];
    __syncwarp();  // the tile's reads are done before the next chunk's writes
  }
  __syncthreads();
  finish(n_chunks - 1);

#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = r0 + g + (q >> 1) * 8, j = j0 + nt * 8 + 2 * t4 + (q & 1);
      if (i < hd && j < hd)
        sT[state0 + static_cast<long long>(i) * hd + j] = Sc[nt][q];
    }
}

template <typename T, int HD>
int launch_chunked_hd(const T* r, const T* k, const T* v, const float* w,
                      const float* u, const float* s0, float* y, float* sT,
                      float* ws, int B, int steps, int H, int hd,
                      cudaStream_t st) {
  const int n_chunks = (steps + L - 1) / L;
  const long long block = static_cast<long long>(B) * H * n_chunks * L * HD;
  float* yi = ws;
  float* vf = yi + block;
  float* rd = vf + block;
  float* ke = rd + block;
  float* dl = ke + block;
  wkv_chunk_intra<T, HD><<<dim3(n_chunks, H, B), INTRA_THREADS, 0, st>>>(
      r, k, v, w, u, yi, vf, rd, ke, dl, steps, H, hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = sizeof(StateSmem<HD>);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(wkv_chunk_state<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wkv_chunk_state<T, HD><<<dim3((hd + JB - 1) / JB, H, B), 2 * HD, smem,
                           st>>>(yi, vf, rd, ke, dl, s0, y, sT, steps, H, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunked(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* sT, float* ws, int B, int steps, int H, int hd,
                   cudaStream_t st) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (hd <= 32)
    return launch_chunked_hd<T, 32>(rt, kt, vt, w, u, s0, y, sT, ws, B, steps,
                                    H, hd, st);
  if (hd <= 64)
    return launch_chunked_hd<T, 64>(rt, kt, vt, w, u, s0, y, sT, ws, B, steps,
                                    H, hd, st);
  return launch_chunked_hd<T, 128>(rt, kt, vt, w, u, s0, y, sT, ws, B, steps,
                                   H, hd, st);
}

}  // namespace

extern "C" {

// Launch rwkv6_wkv on `stream`. r, k, v (B, T, H, hd) contiguous, bf16
// (bf16 != 0) or fp32; w (B, T, H, hd), u (H, hd), s0 (B, H, hd, hd) fp32
// contiguous; y (B, T, H, hd) and sT (B, H, hd, hd) fp32 outputs, sT either
// s0 itself or disjoint from it. Takes B, T, H >= 1, B <= 65535 and
// 1 <= hd <= 128. Returns the CUDA error code of the launch (0 = success).
int rwkv6_wkv(const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, float* y, float* sT, int B,
              int T, int H, int hd, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || hd < 1 || hd > MAX_HD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, T, H, hd,
                                      st)
              : launch<float>(r, k, v, w, u, s0, y, sT, B, T, H, hd, st);
}

// Launch rwkv6_wkv_tick on `stream`: the same operands, limits and result
// as rwkv6_wkv, by the tick kernel (meant for calls of a few steps: it
// walks the steps with 4 * HD threads per (b, h) state).
int rwkv6_wkv_tick(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* sT, int B, int T, int H, int hd, int bf16,
                   void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || hd < 1 || hd > MAX_HD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_tick<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, T, H,
                                           hd, st)
              : launch_tick<float>(r, k, v, w, u, s0, y, sT, B, T, H, hd,
                                   st);
}

// Launch rwkv6_wkv_chunked on `stream`: the same operands and result as
// rwkv6_wkv, in two kernel launches (wkv_chunk_intra, then
// wkv_chunk_state); ws is fp32 scratch of B * H * ceil(T / 16) * HD * 65
// floats, HD = hd rounded up to 32, 64 or 128. Takes B, T, H >= 1, B,
// H <= 65535 and 1 <= hd <= 128. Returns the CUDA error code of the
// launches (0 = success).
int rwkv6_wkv_chunked(const void* r, const void* k, const void* v,
                      const float* w, const float* u, const float* s0,
                      float* y, float* sT, float* ws, int B, int T, int H,
                      int hd, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535 || hd < 1 ||
      hd > MAX_HD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_chunked<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, ws,
                                              B, T, H, hd, st)
              : launch_chunked<float>(r, k, v, w, u, s0, y, sT, ws, B, T, H,
                                      hd, st);
}

const char* rwkv6_wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
