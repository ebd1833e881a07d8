// Hand-written Hopper (sm_90a) kernel for the Mamba-1 selective scan: the
// state-space core of every mamba layer of the hybrid family (jamba), on
// prefill and on every decode tick of the serving engine.
//
// mamba_scan replaces the Pallas kernel repro/kernels/mamba_scan.py
//   mamba_scan (its pl.pallas_call at mamba_scan.py:63, body _kernel at :21).
//
// What it computes (the reference's _scan_ref, step by step in fp32): per
// batch row b and channel d, with the N states h starting at h0[b, d, :]
// (zeros without h0),
//   dA_n = exp(dt_d * A_dn)
//   h_n  = dA_n * h_n + (dt_d * x_d) * B_n
//   y_d  = sum_n h_n * C_n
// for t = 0 .. T-1, writing y[b, t, d] each step and h to hT[b, d, :] once
// at the end. dt (B, T, Di), A (Di, N), Bm and Cm (B, T, N), h0 and hT
// (B, Di, N) are fp32; x (B, T, Di) is bf16 or fp32; y is fp32. Unlike the
// Pallas kernel it starts from a carried state and takes any T and Di.
//
// Bound: a long prefill (B 1, T 1024, Di 16384, N 16) moves some 171 MB
// (dt, x and y over (T, Di), the state once) and takes B*T*Di*N = 268M
// exponentials; at the SFU's 16 per SM per clock that is the larger term,
// about 0.07 ms. A decode tick (B 8, T 1) reads and writes the 8.4 MB state
// once and is bound by the memory rate. The TPU grid walked (B, Di/dblk,
// T/chunk) with the time axis sequential and the (dblk, N) state in VMEM
// scratch. Here nothing carries over between CTAs, so a loop over time
// inside the CTA takes the place of the chunk axis, and the state lives in
// registers: one thread owns one channel and keeps all N of its states
// (h[N]) and its row of A for the whole walk, so h0 is read and hT written
// once. The N exponentials of a step are independent of each other, which
// gives each thread the instruction-level parallelism that a single warp per
// SM partition needs at B 1 (Di 16384 channels are 512 warps). The other
// layout, one thread per (channel, state) with the y sum over N lanes taken
// by shuffles, has 16x the threads but spends four shuffles per step per
// state element, more than the exponential itself.
//
// A CTA is one warp of 32 channels. Per run of CH steps it stages its
// channels' dt and x (coalesced, one row of 32 channels per load) and the
// steps' B and C rows (shared by every channel) in shared memory, then each
// thread walks the run. The state and A are staged through a padded shared
// tile so their loads and stores are coalesced too. Each CTA reads its own
// state before it writes any, and CTAs own disjoint channels, so hT may
// alias h0 (a layer updates its cache's state in place).
//
// Rounding: dt*A, dA*h, dt*x and (dt*x)*B are each rounded in fp32 as the
// plain version rounds them, and the exponential is the accurate expf (the
// library is built with -fmad=false; never --use_fast_math). Only the sum
// over N differs: four partial sums (n mod 4) joined by fused multiply-adds,
// against the plain version's reduction order. The cost is issue, not
// memory: the accurate expf is some eight FP32 instructions, so a step
// spends about 13 per state element; exp2f on a pre-scaled A, or the chunked
// form on tensor cores, is the redesign for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;   // channels per CTA: one warp, a channel a thread
constexpr int CH = 32;      // time steps staged per run
constexpr int MAX_N = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid (ceil(Di / LANES), B), LANES threads: thread `lane` owns channel
// d0 + lane; states n >= N and channels d >= Di hold zeros and write nothing.
template <typename TX, int NS>
__global__ void __launch_bounds__(LANES)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const TX* __restrict__ x, const float* h0,
                  float* __restrict__ y, float* hT, int steps, int Di,
                  int N) {
  __shared__ float dt_s[CH][LANES];
  __shared__ float x_s[CH][LANES];
  __shared__ __align__(16) float b_s[CH][NS];
  __shared__ __align__(16) float c_s[CH][NS];
  __shared__ float tile[LANES][NS + 1];  // A, h0, hT; padded: no conflicts

  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * LANES;
  const int nch = min(LANES, Di - d0);  // live channels of this CTA
  const bool live = lane < nch;
  const long long b = blockIdx.y;
  // rows d0 .. d0 + nch of A (Di, N) and of the state (B, Di, N) are each
  // one contiguous run of nch * N floats
  const long long a0 = static_cast<long long>(d0) * N;
  const long long s0 = (b * Di + d0) * N;

  float a[NS], h[NS];
  for (int i = lane; i < nch * N; i += LANES) tile[i / N][i % N] = A[a0 + i];
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NS; ++n) a[n] = (live && n < N) ? tile[lane][n] : 0.f;
  __syncwarp();
  if (h0 != nullptr) {
    for (int i = lane; i < nch * N; i += LANES)
      tile[i / N][i % N] = h0[s0 + i];
    __syncwarp();
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
    h[n] = (h0 != nullptr && live && n < N) ? tile[lane][n] : 0.f;

  const long long row0 = b * steps;  // row (b, 0) of the (B*T, .) operands
  for (int t0 = 0; t0 < steps; t0 += CH) {
    const int cnt = min(CH, steps - t0);
    __syncwarp();  // every thread is done with the previous run
#pragma unroll 8
    for (int c = 0; c < cnt; ++c) {
      const long long at = (row0 + t0 + c) * Di + d0 + lane;
      dt_s[c][lane] = live ? dt[at] : 0.f;
      x_s[c][lane] = live ? to_f32(x[at]) : 0.f;
    }
    for (int i = lane; i < cnt * NS; i += LANES) {
      const int c = i / NS, n = i % NS;
      const long long at = (row0 + t0 + c) * N + n;
      b_s[c][n] = n < N ? Bm[at] : 0.f;
      c_s[c][n] = n < N ? Cm[at] : 0.f;
    }
    __syncwarp();

    for (int c = 0; c < cnt; ++c) {
      const float dtv = dt_s[c][lane];
      const float dtx = __fmul_rn(dtv, x_s[c][lane]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float dA = expf(__fmul_rn(dtv, a[n]));
        h[n] = __fadd_rn(__fmul_rn(dA, h[n]), __fmul_rn(dtx, b_s[c][n]));
        acc[n & 3] = __fmaf_rn(h[n], c_s[c][n], acc[n & 3]);
      }
      if (live)
        y[(row0 + t0 + c) * Di + d0 + lane] =
            __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
    }
  }

  __syncwarp();
#pragma unroll
  for (int n = 0; n < NS; ++n) tile[lane][n] = h[n];
  __syncwarp();
  for (int i = lane; i < nch * N; i += LANES) hT[s0 + i] = tile[i / N][i % N];
}

template <typename TX, int NS>
int launch_ns(const float* dt, const float* A, const float* Bm,
              const float* Cm, const void* x, const float* h0, float* y,
              float* hT, int B, int steps, int Di, int N, cudaStream_t st) {
  const dim3 grid((Di + LANES - 1) / LANES, B);
  mamba_scan_kernel<TX, NS><<<grid, LANES, 0, st>>>(
      dt, A, Bm, Cm, static_cast<const TX*>(x), h0, y, hT, steps, Di, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int launch(const float* dt, const float* A, const float* Bm, const float* Cm,
           const void* x, const float* h0, float* y, float* hT, int B,
           int steps, int Di, int N, cudaStream_t st) {
  if (N <= 4)
    return launch_ns<TX, 4>(dt, A, Bm, Cm, x, h0, y, hT, B, steps, Di, N, st);
  if (N <= 8)
    return launch_ns<TX, 8>(dt, A, Bm, Cm, x, h0, y, hT, B, steps, Di, N, st);
  if (N <= 16)
    return launch_ns<TX, 16>(dt, A, Bm, Cm, x, h0, y, hT, B, steps, Di, N,
                             st);
  return launch_ns<TX, 32>(dt, A, Bm, Cm, x, h0, y, hT, B, steps, Di, N, st);
}

}  // namespace

extern "C" {

// Launch mamba_scan on `stream`. dt (B, T, Di), A (Di, N), Bm and Cm
// (B, T, N) fp32 contiguous; x (B, T, Di) contiguous, bf16 (bf16 != 0) or
// fp32; h0 (B, Di, N) fp32 contiguous, or null for a zero initial state; y
// (B, T, Di) and hT (B, Di, N) fp32 outputs, hT either h0 itself or
// disjoint from it. Takes B, T, Di >= 1, B <= 65535 and 1 <= N <= 32.
// Returns the CUDA error code of the launch (0 = success).
int mamba_scan(const float* dt, const float* A, const float* Bm,
               const float* Cm, const void* x, const float* h0, float* y,
               float* hT, int B, int T, int Di, int N, int bf16,
               void* stream) {
  if (B <= 0 || T <= 0 || Di <= 0 || B > 65535 || N < 1 || N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(dt, A, Bm, Cm, x, h0, y, hT, B, T, Di,
                                      N, st)
              : launch<float>(dt, A, Bm, Cm, x, h0, y, hT, B, T, Di, N, st);
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
