// Hand-written Hopper (sm_90a) kernel for the AdamW update of the train
// steps: one pass over the flat float32 gradient, m, v (and the float32
// master) and one weight tensor (bf16 or float32).
//
// It replaces no TPU kernel: the reference's AdamW (repro/optim/adamw.py)
// is plain jnp, which XLA fuses into a few loops. The port's plain version
// (kernels/ref.py adamw_update) runs about 16 elementwise passes a piece,
// each writing a float32 temporary to device memory, plus the clip's
// read and write of the gradient. This kernel replaces those passes.
//
// Bound: bytes. Per element it reads g, m, v (4 bytes each) and the base
// (the weight, 2 or 4 bytes, or the master, 4) and writes m, v, the weight
// and the master where there is one: 24 bytes with bf16 weights, 28 with
// float32 ones, 30 with bf16 weights and a master. Its 15 to 17 float32
// operations per element are far below the card's rate at those bytes
// (67 TFLOP/s against 3.35 TB/s: ~20 operations a byte), even with the
// IEEE division and square root. So the design is about bytes in flight:
// a thread takes 4 consecutive elements at a time with one 16-byte load
// each of g, m, v (and the master) and one 8- or 16-byte load of the
// weights, all issued before the first operation; the results go back as
// the same vectors. CTAs of 256 threads walk the vectors in a grid-stride
// loop over a grid of as many CTAs as the card holds at once. Where a
// tensor's flat offset leaves g, m and v off a 16-byte boundary, the first
// 1-3 elements (the head) and the last 0-3 (the tail) take the scalar
// path; where the operands' addresses do not share one phase (a float
// buffer and a weight view that no common head aligns), every element
// does. The clip's scale is read from device memory (a 0-d tensor), so a
// call needs no host read; the clipped gradient lives only in registers.
//
// Rounding contract (bitwise with the plain passes on the card): each
// float32 operation is one PyTorch CUDA op of the plain version, in its
// order, rounded once to nearest even, written with the _rn intrinsics so
// that no two fuse (the library is built with -fmad=false as well):
//   gc = g * scale                         (the clip's mul_)
//   m  = m * b1 + gc * (1 - b1)            (three ops)
//   v  = v * b2 + (gc * gc) * (1 - b2)     (four ops)
//   u  = (m * (1 / bc1)) / (sqrt(v * (1 / bc2)) + eps)
//   u  = u + base * wd                     (decayed leaves only)
//   base = base - u * lr
// PyTorch divides a tensor by a Python float as a multiplication by the
// float32 reciprocal, computed on the host (1 / bc1 and 1 / bc2 here come
// from the wrapper the same way); a tensor by a tensor as an IEEE
// division (__fdiv_rn); sqrt as an IEEE square root (__fsqrt_rn). The
// constants are the plain version's Python floats cast to float32. The
// new weight is the new base cast to the weight's dtype: bf16 by
// __float2bfloat16 (round to nearest even, what PyTorch's copy_ uses on
// sm_80 and later), float32 as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// The update's float32 constants.
struct Step {
  float b1, c1, b2, c2, ib1, ib2, eps, wd, lr;
};

// A weight's storage: bf16 as its bits, float32 as itself.
template <typename W>
struct Dtype;

template <>
struct Dtype<uint16_t> {
  static __device__ __forceinline__ float load(uint16_t b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ uint16_t store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
  }
};

template <>
struct Dtype<float> {
  static __device__ __forceinline__ float load(float f) { return f; }
  static __device__ __forceinline__ float store(float f) { return f; }
};

// Four consecutive weights, loaded and stored as one vector.
template <typename W>
struct alignas(4 * sizeof(W)) Pack4 {
  W x[4];
};

// One element's update: m and v in place; returns the new base.
template <bool DECAY>
__device__ __forceinline__ float adam(float g, float s, float& m, float& v,
                                      float base, const Step& k) {
  const float gc = __fmul_rn(g, s);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(gc, k.c1));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(gc, gc), k.c2));
  float u = __fdiv_rn(__fmul_rn(m, k.ib1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, k.ib2)), k.eps));
  if (DECAY) u = __fadd_rn(u, __fmul_rn(base, k.wd));
  return __fsub_rn(base, __fmul_rn(u, k.lr));
}

// Elements [0, head) and [head + 4 nv, n) one at a time, the 4 nv between
// as float4 vectors; master is null unless MASTER.
template <typename W, bool MASTER, bool DECAY>
__global__ void __launch_bounds__(THREADS)
adamw_update_kernel(const float* __restrict__ g, float* __restrict__ m,
                    float* __restrict__ v, float* __restrict__ master,
                    W* __restrict__ w, const float* __restrict__ scale,
                    long long head, long long nv, long long n, Step k) {
  const float s = *scale;
  const long long first =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long j = first; j < nv; j += stride) {
    const long long i = head + 4 * j;
    const float4 gv = *reinterpret_cast<const float4*>(g + i);
    float4 mv = *reinterpret_cast<const float4*>(m + i);
    float4 vv = *reinterpret_cast<const float4*>(v + i);
    float4 bv;
    if (MASTER) {
      bv = *reinterpret_cast<const float4*>(master + i);
    } else {
      const Pack4<W> p = *reinterpret_cast<const Pack4<W>*>(w + i);
      bv = make_float4(Dtype<W>::load(p.x[0]), Dtype<W>::load(p.x[1]),
                       Dtype<W>::load(p.x[2]), Dtype<W>::load(p.x[3]));
    }
    bv.x = adam<DECAY>(gv.x, s, mv.x, vv.x, bv.x, k);
    bv.y = adam<DECAY>(gv.y, s, mv.y, vv.y, bv.y, k);
    bv.z = adam<DECAY>(gv.z, s, mv.z, vv.z, bv.z, k);
    bv.w = adam<DECAY>(gv.w, s, mv.w, vv.w, bv.w, k);
    *reinterpret_cast<float4*>(m + i) = mv;
    *reinterpret_cast<float4*>(v + i) = vv;
    if (MASTER) *reinterpret_cast<float4*>(master + i) = bv;
    Pack4<W> out;
    out.x[0] = Dtype<W>::store(bv.x);
    out.x[1] = Dtype<W>::store(bv.y);
    out.x[2] = Dtype<W>::store(bv.z);
    out.x[3] = Dtype<W>::store(bv.w);
    *reinterpret_cast<Pack4<W>*>(w + i) = out;
  }
  const long long body = 4 * nv;
  for (long long r = first; r < n - body; r += stride) {
    const long long i = r < head ? r : r + body;
    float mi = m[i], vi = v[i];
    const float base = MASTER ? master[i] : Dtype<W>::load(w[i]);
    const float nb = adam<DECAY>(g[i], s, mi, vi, base, k);
    m[i] = mi;
    v[i] = vi;
    if (MASTER) master[i] = nb;
    w[i] = Dtype<W>::store(nb);
  }
}

// One launch's arguments.
struct Launch {
  dim3 grid;
  cudaStream_t st;
  const float* g;
  float *m, *v, *master;
  void* w;
  const float* scale;
  long long head, nv, n;
  Step k;
};

template <typename W, bool MASTER, bool DECAY>
void start(const Launch& a) {
  adamw_update_kernel<W, MASTER, DECAY><<<a.grid, THREADS, 0, a.st>>>(
      a.g, a.m, a.v, a.master, static_cast<W*>(a.w), a.scale, a.head, a.nv,
      a.n, a.k);
}

template <typename W, bool MASTER, bool DECAY>
const void* kernel() {
  return reinterpret_cast<const void*>(
      adamw_update_kernel<W, MASTER, DECAY>);
}

// The instances, by index 4 * (float32 weights) + 2 * master + decay.
using Start = void (*)(const Launch&);
const Start STARTS[8] = {
    start<uint16_t, false, false>, start<uint16_t, false, true>,
    start<uint16_t, true, false>,  start<uint16_t, true, true>,
    start<float, false, false>,    start<float, false, true>,
    start<float, true, false>,     start<float, true, true>};
const void* const KERNELS[8] = {
    kernel<uint16_t, false, false>(), kernel<uint16_t, false, true>(),
    kernel<uint16_t, true, false>(),  kernel<uint16_t, true, true>(),
    kernel<float, false, false>(),    kernel<float, false, true>(),
    kernel<float, true, false>(),     kernel<float, true, true>()};

// The grid: as many CTAs as the card holds at once (SMs x
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once per host
// thread, device and instance), no more than the work needs.
int grid_of(int i, long long work, unsigned* ctas) {
  constexpr int DEVICES = 16;
  thread_local int resident[DEVICES][8] = {};
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc) return rc;
  if (dev < 0 || dev >= DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!resident[dev][i]) {
    int sms = 0, per_sm = 0;
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
    if (!rc)
      rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, KERNELS[i], THREADS, 0));
    if (rc) return rc;
    resident[dev][i] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (work + THREADS - 1) / THREADS;
  *ctas = static_cast<unsigned>(need < resident[dev][i] ? need
                                                        : resident[dev][i]);
  return 0;
}

bool at_phase(const void* p, long long head, long long size, long long to) {
  return (reinterpret_cast<uintptr_t>(p) + head * size) % to == 0;
}

}  // namespace

extern "C" {

// Launch the update of n elements on `stream`: g, m, v (and master, or
// null) are the elements' float32 slices of the flat buffers, w the weight
// tensor's n elements (bf16 unless w_f32), scale a float32 in device
// memory (the clip's factor), decay whether the leaf decays; the float
// arguments are the update's float32 constants (see the contract above).
// m, v, master and w are updated in place; g is only read. Returns the
// CUDA error code of the launch (0 = success; n == 0 launches nothing).
int adamw_update(const float* g, float* m, float* v, float* master, void* w,
                 int w_f32, int decay, long long n, const float* scale,
                 float b1, float c1, float b2, float c2, float ib1,
                 float ib2, float eps, float wd, float lr, void* stream) {
  if (n < 0 || !g || !m || !v || !w || !scale)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long wsize = w_f32 ? 4 : 2;
  // the head that brings g to a 16-byte boundary; the vectors need every
  // operand there after the same head
  long long head = static_cast<long long>(
      ((16 - reinterpret_cast<uintptr_t>(g) % 16) % 16) / 4);
  const bool vec = reinterpret_cast<uintptr_t>(g) % 4 == 0 && head < n &&
                   at_phase(m, head, 4, 16) && at_phase(v, head, 4, 16) &&
                   (!master || at_phase(master, head, 4, 16)) &&
                   at_phase(w, head, wsize, 4 * wsize);
  if (!vec) head = n;
  const long long nv = (n - head) / 4;
  const long long rest = n - 4 * nv;
  const int i = (w_f32 ? 4 : 0) + (master ? 2 : 0) + (decay ? 1 : 0);
  unsigned ctas = 0;
  int rc = grid_of(i, nv > rest ? nv : rest, &ctas);
  if (rc) return rc;
  const Launch a{dim3(ctas), static_cast<cudaStream_t>(stream), g, m, v,
                 master, w, scale, head, nv, n,
                 Step{b1, c1, b2, c2, ib1, ib2, eps, wd, lr}};
  STARTS[i](a);
  return static_cast<int>(cudaGetLastError());
}

const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
