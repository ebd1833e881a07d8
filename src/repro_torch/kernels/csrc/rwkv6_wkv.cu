// Hand-written Hopper (sm_90a) kernel for the RWKV-6 (Finch) WKV recurrence:
// the time-mixing core of every rwkv layer, on prefill and on every decode
// tick of the serving engine.
//
// rwkv6_wkv replaces the Pallas kernel repro/kernels/rwkv6_wkv.py
//   rwkv6_wkv (its pl.pallas_call at rwkv6_wkv.py:59, body _kernel at :21).
//
// What it computes (the Pallas body, step by step in fp32): per batch row b
// and head h, with the (hd x hd) state S starting at s0[b, h],
//   kv_ij = k_i * v_j
//   y_j   = sum_i r_i * (S_ij + u_i * kv_ij)
//   S_ij  = w_i * S_ij + kv_ij
// for t = 0 .. T-1, writing y[b, t, h, :] each step and S to sT[b, h] once
// at the end. r, k, v are (B, T, H, hd), all bf16 or all fp32; w (B, T, H,
// hd), u (H, hd), s0 and sT (B, H, hd, hd) are fp32; y is fp32.
//
// The bonus term needs no work per state element: sum_i r_i * u_i * k_i *
// v_j = v_j * a with a = sum_i r_i * u_i * k_i, one dot product per step. So
// the kernel computes y_j = sum_i r_i * S_ij + v_j * a: 2 flops per state
// element for y and 3 for the update, 5 in all, plus O(hd) per step.
//
// Bound: a decode tick (T = 1) reads and writes the state once and does 5
// flops per state element, below the card's ops-per-byte ridge, so the
// memory rate bounds it; a long prefill (B 1, T 1024) does 5*T*hd^2 flops per
// head on little data and is bound by the fp32 rate. The TPU grid walked
// (B, H, T/chunk) with the time axis sequential and the state in VMEM
// scratch. Here one CTA owns one (b, h) pair and a loop over time takes the
// place of the chunk axis: thread j holds column j of S in registers for the
// whole walk, so the state never leaves the SM between steps, and s0 is read
// and sT written once. Each thread reads its own column before any write, so
// sT may alias s0 (a layer updates its cache's state in place).
//
// Per run of CH steps the CTA stages r, k, w and v (converted to fp32) in
// shared memory with plain loads and then works out each step's a, one step
// per thread; then every thread walks the run reading r_i, k_i and w_i as
// broadcast float4s. The sums over i keep four partial sums (i mod 4), so the
// chain of dependent fused multiply-adds is a quarter as long; this, the
// bonus term taken as v_j * a and the fused multiply-adds are the only
// departures from the plain version's order of fp32 operations. The library
// is built with -fmad=false, so every fused multiply-add is an explicit
// __fmaf_rn.
//
// One CTA per (b, h) gives 256 CTAs of 64 threads at the decode tick (B 8,
// H 32, hd 64) but only 32 CTAs, each walking T steps one after another, at a
// B 1 prefill: that shape sits far above its bound. The chunked form (the
// intra-chunk products on tensor cores, the state carried between chunks) is
// the redesign for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_HD = 128;
// elements of one staged array (CH steps of HD lanes): 4 arrays of 8 KB
constexpr int STAGE = 2048;

__device__ __forceinline__ float to_f32(float x) { return x; }
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

const char* rwkv6_wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
