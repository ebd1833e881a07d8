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
// about 0.064 ms. A decode tick (B 8, T 1) reads and writes the 8.4 MB
// state once and is bound by the memory rate. The TPU grid walked (B,
// Di/dblk, T/chunk) with the time axis sequential and the (dblk, N) state
// in VMEM scratch. Here nothing carries over between CTAs, so a loop over
// time inside the CTA takes the place of the chunk axis, and the state
// lives in registers for the whole walk.
//
// Layout. A channel's NS (N padded to 4, 8, 16 or 32) states are spread
// over LPC = NS / 4 neighbouring lanes, SPT = 4 states per thread, and a
// CTA holds 32 channels (32 * LPC threads: 4 warps at N 16, 8 at N 32).
// At the 1024-step prefill that is 512 CTAs and 2048 warps, some 15 warps
// per SM, where one thread per channel gave 4. Each thread reads its four
// contiguous states of A and of h0 as one float4 straight from global
// memory and writes its four of hT the same way (scalar loads and stores
// where N or Di is not a multiple of 4 or an operand is not aligned).
// States n >= N and channels d >= Di hold zeros: their lanes take part in
// the shuffles and write nothing. Each state belongs to one thread, which
// reads it before it writes it, so hT may alias h0 (a layer updates its
// cache's state in place).
//
// From two steps on (the prefill), per run of CH steps the CTA stages its
// 32 channels' dt and dt * x and the steps' B and C rows in a
// double-buffered shared tile, dt and dt * x as a row of steps per channel.
// The next run's values are loaded into registers before this run computes
// (four channels or four states a load where N and Di are multiples of 4
// and the operands aligned) and stored into the other buffer after it, so
// their latency hides behind a run of steps and one barrier per run
// suffices. (A cp.async version, 4 bytes a copy since x in bf16 is a
// 2-byte element at any alignment, ran slower on the H100: each copy pays
// its own address arithmetic, and the issue slots are what the run lacks.)
// Per group of four steps (eight at N 32) a thread reads its channel's dt
// and dt * x as one 16-byte shared load per four steps each, and per step
// its four B and C values as one 16-byte shared load each; it updates its
// four states and sums its four h * C terms. The channel's LPC partials
// of LPC steps are then reduced and scattered by LPC - 1 __shfl_xor_sync
// (not 2 log2(LPC) per step), so lane l holds step l's y and puts it in a
// shared tile, written out after the run as coalesced rows. The decode
// tick (T 1) has its own kernel of the same layout and arithmetic with no
// staging: no shared memory and few registers, so enough CTAs are resident
// to keep the state's loads in flight.
//
// Rounding: dA = 2^(dt * A2) on A2 = A * float32(log2 e), rounded to fp32
// once per thread, by one MUFU.EX2 (ex2.approx.ftz: 2 ulp, a result below
// 2^-126 flushed to 0), instead of the accurate expf(dt * A), some eight
// FP32 instructions around one MUFU. The state update is h = fma(dA, h,
// dt*x * B), one rounding where the plain version takes two; dt*x and
// dt*x * B are rounded as the plain version rounds them. y is each lane's
// four h*C terms joined by fused multiply-adds from 0 in state order, then
// the lanes' partials added in the xor tree's pairs (lanes l and l ^ o for
// o = LPC/2 .. 1). ref.mamba_scan_lanes writes this arithmetic out in plain
// PyTorch. The library is built with -fmad=false (never --use_fast_math),
// so the compiler contracts nothing else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPC = 32;     // channels per CTA
constexpr int SPT = 4;      // states per thread
constexpr int MAX_N = 32;
constexpr float LOG2E = 1.44269504088896340736f;  // rounded to fp32

// Per padded state count NS: lanes per channel, threads per CTA, steps per
// run, steps per group (whole float4s of a channel's dt, whole shuffle
// rounds), the dt (and x) and B (and C) values each thread stages per run,
// and the row strides of the shared tiles: a channel's steps (padded so
// that a warp's channels read their float4s from distinct banks) and a
// step's channels in the y tile (padded so that the LPC rows a warp's
// lanes write in one store fall in distinct banks).
template <int NS>
struct Shape {
  static constexpr int LPC = NS / SPT;
  static constexpr int THREADS = CPC * LPC;
  static constexpr int CH = LPC >= 4 ? 32 : 8 * LPC;
  static constexpr int GS = LPC > 4 ? LPC : 4;
  static constexpr int PD = CH * CPC / THREADS;
  static constexpr int PB = CH * NS / THREADS;
  static constexpr int DROW = CH + 4;
  static constexpr int YROW = CPC + 32 / LPC;
  // at most 128 registers a thread: 512 threads per SM
  static constexpr int MIN_CTAS = 512 / THREADS;
  static_assert(NS % SPT == 0 && 32 % LPC == 0, "NS: 4, 8, 16 or 32");
  static_assert(THREADS % CPC == 0 && THREADS % NS == 0, "staging map");
  static_assert(CH % GS == 0 && GS % LPC == 0, "a run is whole groups");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename TX>
__device__ __forceinline__ TX zero_x();
template <>
__device__ __forceinline__ float zero_x<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_x<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// 2^v by one MUFU.EX2 (2 ulp; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float exp2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// One step of a thread's SPT states; returns its partial of y: the
// states' h * C joined by fused multiply-adds from 0 in state order.
__device__ __forceinline__ float update(float dtv, float dtx,
                                        const float (&bb)[SPT],
                                        const float (&cc)[SPT],
                                        const float (&a2)[SPT],
                                        float (&h)[SPT]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const float dA = exp2_ftz(__fmul_rn(dtv, a2[i]));
    h[i] = __fmaf_rn(dA, h[i], __fmul_rn(dtx, bb[i]));
    acc = __fmaf_rn(h[i], cc[i], acc);
  }
  return acc;
}

__device__ __forceinline__ void unpack(const float4 v, float (&out)[SPT]) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// A's row pre-scaled by log2(e) and the initial state of this thread's
// SPT states (zeros past N, past Di, and without h0)
template <bool VEC>
__device__ __forceinline__ void load_state(const float* __restrict__ A,
                                           const float* h0, long long a_at,
                                           long long s_at, int n0, int N,
                                           bool live, float (&a2)[SPT],
                                           float (&h)[SPT]) {
  if (VEC) {
    const bool in = live && n0 < N;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    unpack(in ? *reinterpret_cast<const float4*>(A + a_at) : zero, a2);
    unpack((in && h0 != nullptr)
               ? *reinterpret_cast<const float4*>(h0 + s_at) : zero, h);
  } else {
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const bool in = live && n0 + i < N;
      a2[i] = in ? A[a_at + i] : 0.f;
      h[i] = (in && h0 != nullptr) ? h0[s_at + i] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < SPT; ++i) a2[i] = __fmul_rn(a2[i], LOG2E);
}

template <bool VEC>
__device__ __forceinline__ void store_state(float* hT, long long s_at,
                                            int n0, int N, bool live,
                                            const float (&h)[SPT]) {
  if (VEC) {
    if (live && n0 < N)
      *reinterpret_cast<float4*>(hT + s_at) =
          make_float4(h[0], h[1], h[2], h[3]);
  } else {
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if (live && n0 + i < N) hT[s_at + i] = h[i];
  }
}

// The CTA's operands of one run, held in registers from its loads to its
// store into a shared buffer (which holds dt * x in place of x, and dt and
// dt * x as a row of steps per channel).
template <typename TX, int NS>
struct Stage {
  using S = Shape<NS>;
  float dt_r[S::PD];
  TX x_r[S::PD];
  float b_r[S::PB], c_r[S::PB];

  // load steps 0 .. cnt of rows row0 + step; channel d0 + ch, state n;
  // past cnt, Di or N: zeros
  __device__ __forceinline__ void load(
      const float* __restrict__ dt, const TX* __restrict__ x,
      const float* __restrict__ Bm, const float* __restrict__ Cm,
      long long row0, int cnt, int d0, int Di, int N) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int k = 0; k < S::PD; ++k) {
      const int i = k * S::THREADS + tid;
      const int step = i / CPC, ch = i % CPC;
      const bool ok = step < cnt && d0 + ch < Di;
      const long long at = (row0 + step) * Di + d0 + ch;
      dt_r[k] = ok ? dt[at] : 0.f;
      x_r[k] = ok ? x[at] : zero_x<TX>();
    }
#pragma unroll
    for (int k = 0; k < S::PB; ++k) {
      const int i = k * S::THREADS + tid;
      const int step = i / NS, n = i % NS;
      const bool ok = step < cnt && n < N;
      const long long at = (row0 + step) * N + n;
      b_r[k] = ok ? Bm[at] : 0.f;
      c_r[k] = ok ? Cm[at] : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*dt_s)[S::DROW],
                                        float (*dtx_s)[S::DROW],
                                        float (*b_s)[NS],
                                        float (*c_s)[NS]) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int k = 0; k < S::PD; ++k) {
      const int i = k * S::THREADS + tid;
      dt_s[i % CPC][i / CPC] = dt_r[k];
      dtx_s[i % CPC][i / CPC] = __fmul_rn(dt_r[k], to_f32(x_r[k]));
    }
#pragma unroll
    for (int k = 0; k < S::PB; ++k) {
      const int i = k * S::THREADS + tid;
      b_s[i / NS][i % NS] = b_r[k];
      c_s[i / NS][i % NS] = c_r[k];
    }
  }
};

// Stage with vector loads (VEC: N and Di multiples of 4, every operand
// 16-byte aligned, bf16 x 8-byte aligned): four channels of a step's dt and
// x per load, and four states of a step's B and C per load and store.
template <typename TX>
struct XQuad;  // four values of x as one load
template <>
struct XQuad<float> {
  using type = float4;
  static __device__ __forceinline__ void get(const float4 v, float (&o)[4]) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct XQuad<__nv_bfloat16> {
  using type = uint2;
  static __device__ __forceinline__ void get(const uint2 v, float (&o)[4]) {
    o[0] = __uint_as_float(v.x << 16);
    o[1] = __uint_as_float(v.x & 0xffff0000u);
    o[2] = __uint_as_float(v.y << 16);
    o[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

template <typename TX, int NS>
struct StageVec {
  using S = Shape<NS>;
  using XV = typename XQuad<TX>::type;
  static constexpr int QD = S::CH * (CPC / 4);  // (step, 4 channels)
  static constexpr int QB = S::CH * (NS / 4);   // (step, 4 states)
  static constexpr int PD = (QD + S::THREADS - 1) / S::THREADS;
  static constexpr int PB = (QB + S::THREADS - 1) / S::THREADS;
  float4 dt_r[PD];
  XV x_r[PD];
  float4 b_r[PB], c_r[PB];

  __device__ __forceinline__ void load(
      const float* __restrict__ dt, const TX* __restrict__ x,
      const float* __restrict__ Bm, const float* __restrict__ Cm,
      long long row0, int cnt, int d0, int Di, int N) {
    const int tid = threadIdx.x;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < PD; ++k) {
      const int i = k * S::THREADS + tid;
      const int step = i / (CPC / 4), ch = 4 * (i % (CPC / 4));
      const bool ok = i < QD && step < cnt && d0 + ch < Di;
      const long long at = (row0 + step) * Di + d0 + ch;
      dt_r[k] = ok ? *reinterpret_cast<const float4*>(dt + at) : zero;
      x_r[k] = ok ? *reinterpret_cast<const XV*>(x + at) : XV{};
    }
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = k * S::THREADS + tid;
      const int step = i / (NS / 4), n = 4 * (i % (NS / 4));
      const bool ok = i < QB && step < cnt && n < N;
      const long long at = (row0 + step) * N + n;
      b_r[k] = ok ? *reinterpret_cast<const float4*>(Bm + at) : zero;
      c_r[k] = ok ? *reinterpret_cast<const float4*>(Cm + at) : zero;
    }
  }

  __device__ __forceinline__ void store(float (*dt_s)[S::DROW],
                                        float (*dtx_s)[S::DROW],
                                        float (*b_s)[NS],
                                        float (*c_s)[NS]) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int k = 0; k < PD; ++k) {
      const int i = k * S::THREADS + tid;
      if (i < QD) {
        const int step = i / (CPC / 4), ch = 4 * (i % (CPC / 4));
        float d[4], xv[4];
        unpack(dt_r[k], d);
        XQuad<TX>::get(x_r[k], xv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dt_s[ch + j][step] = d[j];
          dtx_s[ch + j][step] = __fmul_rn(d[j], xv[j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = k * S::THREADS + tid;
      if (i < QB) {
        const int step = i / (NS / 4), n = 4 * (i % (NS / 4));
        *reinterpret_cast<float4*>(&b_s[step][n]) = b_r[k];
        *reinterpret_cast<float4*>(&c_s[step][n]) = c_r[k];
      }
    }
  }
};

// A if C, else B
template <bool C, typename A, typename B>
struct Pick { using type = A; };
template <typename A, typename B>
struct Pick<false, A, B> { using type = B; };

// The LPC lanes' partials v[j] of LPC steps, reduced and scattered: at each
// level o (LPC/2 .. 1) a lane keeps the half of its steps picked by bit o of
// its lane and adds its partner's partials of them. Lane ls ends with the
// full sum of step ls in v[0], equal bit for bit to what every lane of the
// xor tree p_l + p_(l^o) would hold (fp32 addition commutes).
template <int LPC>
__device__ __forceinline__ void reduce_scatter(float (&v)[LPC], int ls) {
#pragma unroll
  for (int o = LPC / 2; o > 0; o >>= 1) {
    const bool up = ls & o;
#pragma unroll
    for (int k = 0; k < o; ++k) {
      const float send = up ? v[k] : v[k + o];
      const float keep = up ? v[k + o] : v[k];
      v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
    }
  }
}

// GS steps c .. c + GS of one run from the shared tiles: each thread's
// states step by step, then the channel's partials reduced and scattered
// LPC steps at a time; lane ls puts step c + r * LPC + ls's y in y_s.
// GUARD: steps from cnt on are skipped (the last run's partial group).
template <int NS, bool GUARD>
__device__ __forceinline__ void scan_group(
    const float* dt_row, const float* dtx_row, const float (*b_s)[NS],
    const float (*c_s)[NS], float (*y_s)[Shape<NS>::YROW], int c, int cnt,
    int ch, int ls, int n0, const float (&a2)[SPT], float (&h)[SPT]) {
  using S = Shape<NS>;
  float dts[S::GS], dtxs[S::GS], v[S::GS];
#pragma unroll
  for (int q = 0; q < S::GS; q += 4) {
    const float4 d4 = *reinterpret_cast<const float4*>(dt_row + c + q);
    const float4 x4 = *reinterpret_cast<const float4*>(dtx_row + c + q);
    dts[q] = d4.x; dts[q + 1] = d4.y; dts[q + 2] = d4.z; dts[q + 3] = d4.w;
    dtxs[q] = x4.x; dtxs[q + 1] = x4.y; dtxs[q + 2] = x4.z;
    dtxs[q + 3] = x4.w;
  }
#pragma unroll
  for (int j = 0; j < S::GS; ++j) {
    v[j] = 0.f;
    if (!GUARD || c + j < cnt) {
      float bb[SPT], cc[SPT];
      unpack(*reinterpret_cast<const float4*>(&b_s[c + j][n0]), bb);
      unpack(*reinterpret_cast<const float4*>(&c_s[c + j][n0]), cc);
      v[j] = update(dts[j], dtxs[j], bb, cc, a2, h);
    }
  }
#pragma unroll
  for (int r = 0; r < S::GS; r += S::LPC) {
    float w[S::LPC];
#pragma unroll
    for (int k = 0; k < S::LPC; ++k) w[k] = v[r + k];
    reduce_scatter<S::LPC>(w, ls);
    y_s[c + r + ls][ch] = w[0];  // rows past cnt are never written out
  }
}

// grid (ceil(Di / CPC), B), Shape<NS>::THREADS threads: thread tid holds
// states ls * SPT .. + SPT of channel d0 + tid / LPC (ls = tid % LPC).
// VEC: N and Di multiples of 4 and every operand aligned (float4 state
// I/O, vector staging loads, float4 y stores). Runs of CH steps staged in
// shared memory; used from 2 steps on.
template <typename TX, int NS, bool VEC>
__global__ void __launch_bounds__(Shape<NS>::THREADS, Shape<NS>::MIN_CTAS)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const TX* __restrict__ x, const float* h0,
                  float* __restrict__ y, float* hT, int steps, int Di,
                  int N) {
  using S = Shape<NS>;
  constexpr int LPC = S::LPC;
  __shared__ __align__(16) float dt_s[2][CPC][S::DROW];
  __shared__ __align__(16) float dtx_s[2][CPC][S::DROW];
  __shared__ __align__(16) float y_s[2][S::CH][S::YROW];
  __shared__ __align__(16) float b_s[2][S::CH][NS];
  __shared__ __align__(16) float c_s[2][S::CH][NS];

  const int tid = threadIdx.x;
  const int ch = tid / LPC, ls = tid % LPC;
  const int n0 = ls * SPT;
  const int d0 = blockIdx.x * CPC;
  const bool live = d0 + ch < Di;
  const long long b = blockIdx.y;
  const long long row0 = b * steps;  // row (b, 0) of the (B*T, .) operands
  // this thread's first state in A (Di, N) and in the state (B, Di, N)
  const long long a_at = static_cast<long long>(d0 + ch) * N + n0;
  const long long s_at = (b * Di + d0 + ch) * N + n0;

  // the first run's operands are in flight with A and h0
  typename Pick<VEC, StageVec<TX, NS>, Stage<TX, NS>>::type stage;
  stage.load(dt, x, Bm, Cm, row0, min(S::CH, steps), d0, Di, N);
  float a2[SPT], h[SPT];
  load_state<VEC>(A, h0, a_at, s_at, n0, N, live, a2, h);
  stage.store(dt_s[0], dtx_s[0], b_s[0], c_s[0]);
  __syncthreads();

  int p = 0;
  for (int t0 = 0; t0 < steps; t0 += S::CH, p ^= 1) {
    const int cnt = min(S::CH, steps - t0);
    const int t1 = t0 + S::CH;
    const bool more = t1 < steps;
    if (more)
      stage.load(dt, x, Bm, Cm, row0 + t1, min(S::CH, steps - t1), d0, Di,
                 N);

    // whole groups unguarded, so a group's steps interleave; then the
    // last run's partial group, if any
    const int whole = cnt - cnt % S::GS;
#pragma unroll 1
    for (int c = 0; c < whole; c += S::GS)
      scan_group<NS, false>(dt_s[p][ch], dtx_s[p][ch], b_s[p], c_s[p], y_s[p],
                            c, cnt, ch, ls, n0, a2, h);
    if (whole < cnt)
      scan_group<NS, true>(dt_s[p][ch], dtx_s[p][ch], b_s[p], c_s[p], y_s[p],
                           whole, cnt, ch, ls, n0, a2, h);

    if (more)
      stage.store(dt_s[p ^ 1], dtx_s[p ^ 1], b_s[p ^ 1], c_s[p ^ 1]);
    __syncthreads();  // the next run's operands and this run's y are in
    if (VEC) {  // four channels a store
#pragma unroll
      for (int i = tid; i < S::CH * CPC / 4; i += S::THREADS) {
        const int c = i / (CPC / 4), chy = 4 * (i % (CPC / 4));
        if (c < cnt && d0 + chy < Di)
          *reinterpret_cast<float4*>(y + (row0 + t0 + c) * Di + d0 + chy) =
              *reinterpret_cast<const float4*>(&y_s[p][c][chy]);
      }
    } else {
#pragma unroll
      for (int i = tid; i < S::CH * CPC; i += S::THREADS) {
        const int c = i / CPC, chy = i % CPC;
        if (c < cnt && d0 + chy < Di)
          y[(row0 + t0 + c) * Di + d0 + chy] = y_s[p][c][chy];
      }
    }
  }
  store_state<VEC>(hT, s_at, n0, N, live, h);
}

// The decode tick (T 1): the same layout and arithmetic without the staged
// runs. dt and x are read straight from global memory (broadcast among a
// channel's lanes), B and C as one float4 each (VEC), and y is the xor
// tree's sum, written by lane 0; no shared memory and few registers, so up
// to 16 CTAs per SM keep the state's loads in flight.
template <typename TX, int NS, bool VEC>
__global__ void __launch_bounds__(Shape<NS>::THREADS)
mamba_scan_tick_kernel(const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const TX* __restrict__ x, const float* h0,
                       float* __restrict__ y, float* hT, int Di, int N) {
  using S = Shape<NS>;
  const int tid = threadIdx.x;
  const int ch = tid / S::LPC, ls = tid % S::LPC;
  const int n0 = ls * SPT;
  const int d = blockIdx.x * CPC + ch;
  const bool live = d < Di;
  const long long b = blockIdx.y;
  const long long a_at = static_cast<long long>(d) * N + n0;
  const long long s_at = (b * Di + d) * N + n0;
  const long long at = b * Di + d;

  const float dtv = live ? dt[at] : 0.f;
  const float xv = live ? to_f32(x[at]) : 0.f;
  float bb[SPT], cc[SPT];
  if (VEC) {
    const bool in = n0 < N;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    unpack(in ? *reinterpret_cast<const float4*>(Bm + b * N + n0) : zero,
           bb);
    unpack(in ? *reinterpret_cast<const float4*>(Cm + b * N + n0) : zero,
           cc);
  } else {
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const bool in = n0 + i < N;
      bb[i] = in ? Bm[b * N + n0 + i] : 0.f;
      cc[i] = in ? Cm[b * N + n0 + i] : 0.f;
    }
  }
  float a2[SPT], h[SPT];
  load_state<VEC>(A, h0, a_at, s_at, n0, N, live, a2, h);

  float acc = update(dtv, __fmul_rn(dtv, xv), bb, cc, a2, h);
#pragma unroll
  for (int o = S::LPC / 2; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (ls == 0 && live) y[at] = acc;
  store_state<VEC>(hT, s_at, n0, N, live, h);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TX, int NS>
int launch_ns(const float* dt, const float* A, const float* Bm,
              const float* Cm, const void* x, const float* h0, float* y,
              float* hT, int B, int steps, int Di, int N, cudaStream_t st) {
  const dim3 grid((Di + CPC - 1) / CPC, B);
  const int threads = Shape<NS>::THREADS;
  // float4 state I/O, and vector loads of the staged operands
  const bool vec = N % SPT == 0 && Di % 4 == 0 && aligned16(A) &&
                   aligned16(hT) && (h0 == nullptr || aligned16(h0)) &&
                   aligned16(dt) && aligned16(Bm) && aligned16(Cm) &&
                   aligned16(y) &&
                   (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TX))) == 0;
  const TX* xt = static_cast<const TX*>(x);
  if (steps == 1) {
    if (vec)
      mamba_scan_tick_kernel<TX, NS, true><<<grid, threads, 0, st>>>(
          dt, A, Bm, Cm, xt, h0, y, hT, Di, N);
    else
      mamba_scan_tick_kernel<TX, NS, false><<<grid, threads, 0, st>>>(
          dt, A, Bm, Cm, xt, h0, y, hT, Di, N);
  } else if (vec) {
    mamba_scan_kernel<TX, NS, true><<<grid, threads, 0, st>>>(
        dt, A, Bm, Cm, xt, h0, y, hT, steps, Di, N);
  } else {
    mamba_scan_kernel<TX, NS, false><<<grid, threads, 0, st>>>(
        dt, A, Bm, Cm, xt, h0, y, hT, steps, Di, N);
  }
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
