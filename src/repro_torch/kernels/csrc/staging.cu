// Hand-written Hopper (sm_90a) kernels for the staging copies of the
// PiP-MColl collectives: the row moves under every RankGrid round on the
// card (the step-6 shift, each ppermute round's multi-object send, the
// per-rank row takes).
//
// shift_blocks replaces the Pallas kernel repro/kernels/staging.py
//   shift_blocks (its pl.pallas_call at staging.py:40, body _shift_kernel):
//   out[r, k] = src[r, (k - shift[r]) mod K] for every rank r, the
//   reference's roll(v, shift, 0) of one (K, m) block-major gather buffer
//   applied to all R ranks at once.
// pack_blocks replaces repro/kernels/staging.py pack_blocks (its
//   pl.pallas_call at staging.py:66, body _pack_kernel):
//   out[r, j] = src[r, idx[r, j]], with a zero row where idx[r, j] lies
//   outside [0, K). The reference's flat form (K rows of one (N, m) buffer)
//   is R = 1; a ppermute round is that flat form over the grid's ranks, its
//   source map -1 where no rank sends.
//
// Both move bytes, not values: a row is row_bytes bytes and goes through
// unchanged, whatever the dtype (float32, bf16, float8, the integers, bool,
// complex), signed zeros and NaN payloads included. So no per-dtype code
// and no signed view of the unsigned types.
//
// Bound: bytes only. Each output row is read once and written once, so a
// call moves 2 * R * J * row_bytes (plus the 8-byte shift or index per
// row); at 3.35 TB/s the pip_mcoll allgather's step-6 roll at 4 MiB per
// rank (V (8, 2, 16 MiB)) is about 0.16 ms. At 8 B per rank the bound is
// nanoseconds and the call is launch and host cost, the paper's regime.
// The TPU kernel brought the shift or the index list in by scalar prefetch
// and let the BlockSpec index map pick the source block. Here the shift and
// the index are read from device memory by each CTA, so a call needs no
// host round trip and no host-to-device copy.
//
// Layout: two, by row length. A row of at least THREADS vectors is walked
// by grid.x and the threads (grid.y walks the rows, a stride loop past
// 65535), so a CTA reads its row's shift or index once. Shorter rows are
// walked as one flat grid-stride range of (row, vector) pairs, so a take
// of a million 4-byte rows keeps every thread busy instead of one per CTA.
// Accesses are the widest that the row bytes, both base pointers and both
// source strides allow: 16-byte vectors where they all divide by 16, down
// to single bytes. The choices are made on the host per call, and are
// choices inside the kernel, never a switch to the plain version. The
// source rows are strided (rank stride and row stride in bytes), so a
// sliced operand such as V[:, :send_cnt] is gathered where it lies; each
// source row itself is contiguous. The output is a fresh contiguous tensor
// that never overlaps the source. Offsets are 64-bit: a 4 MiB-per-rank
// allgather moves 256 MiB buffers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_GRID_X = 1 << 16;   // CTAs along one row
constexpr long long MAX_GRID_Y = 65535;     // rows in flight, then a loop
constexpr long long MAX_FLAT_CTAS = 1 << 13;  // short rows: grid-stride

// Source row of output row (r, k) of a shift: (r, (k - shift[r]) mod K).
struct ShiftRows {
  const char* src;
  const long long* shift;
  long long K, rank_stride, row_stride;
  __device__ const char* operator()(long long row) const {
    const long long r = row / K, k = row - r * K;
    long long s = (k - shift[r]) % K;
    if (s < 0) s += K;
    return src + r * rank_stride + s * row_stride;
  }
};

// Source row of output row (r, j) of a pack: (r, idx[r, j]), or none (a
// zero row) where the index lies outside [0, K).
struct PackRows {
  const char* src;
  const long long* idx;
  long long J, K, rank_stride, row_stride;
  __device__ const char* operator()(long long row) const {
    const long long s = idx[row];
    if (s < 0 || s >= K) return nullptr;
    return src + (row / J) * rank_stride + s * row_stride;
  }
};

// Output rows [0, n_rows) of nv vectors V each, from rows(row) (null: a
// zero row).
template <typename V, bool LONG_ROWS, typename Rows>
__device__ __forceinline__ void copy_rows(const Rows& rows, char* out,
                                          long long n_rows, long long nv) {
  V* o = reinterpret_cast<V*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  if (LONG_ROWS) {
    for (long long row = blockIdx.y; row < n_rows; row += gridDim.y) {
      const V* s = reinterpret_cast<const V*>(rows(row));
      V* d = o + row * nv;
      if (s) {
        for (long long v = first; v < nv; v += stride) d[v] = s[v];
      } else {
        for (long long v = first; v < nv; v += stride) d[v] = V{};
      }
    }
  } else {
    for (long long i = first; i < n_rows * nv; i += stride) {
      const long long row = i / nv;
      const V* s = reinterpret_cast<const V*>(rows(row));
      o[i] = s ? s[i - row * nv] : V{};
    }
  }
}

template <typename V, bool LONG_ROWS>
__global__ void shift_blocks_kernel(ShiftRows rows, char* __restrict__ out,
                                    long long n_rows, long long nv) {
  copy_rows<V, LONG_ROWS>(rows, out, n_rows, nv);
}

template <typename V, bool LONG_ROWS>
__global__ void pack_blocks_kernel(PackRows rows, char* __restrict__ out,
                                   long long n_rows, long long nv) {
  copy_rows<V, LONG_ROWS>(rows, out, n_rows, nv);
}

// The widest access (16, 8, 4, 2 or 1 bytes) that divides the row bytes,
// both base addresses and both source strides.
int width(const void* src, const void* out, long long row_bytes,
          long long rank_stride, long long row_stride) {
  const unsigned long long all =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out) |
      static_cast<unsigned long long>(row_bytes) |
      static_cast<unsigned long long>(rank_stride) |
      static_cast<unsigned long long>(row_stride);
  for (int w = 16; w > 1; w /= 2)
    if (all % w == 0) return w;
  return 1;
}

template <typename V, bool LONG_ROWS>
void start(const ShiftRows& rows, dim3 grid, char* out, long long n_rows,
           long long nv, cudaStream_t st) {
  shift_blocks_kernel<V, LONG_ROWS><<<grid, THREADS, 0, st>>>(rows, out,
                                                              n_rows, nv);
}

template <typename V, bool LONG_ROWS>
void start(const PackRows& rows, dim3 grid, char* out, long long n_rows,
           long long nv, cudaStream_t st) {
  pack_blocks_kernel<V, LONG_ROWS><<<grid, THREADS, 0, st>>>(rows, out,
                                                             n_rows, nv);
}

template <typename V, typename Rows>
int launch_v(const Rows& rows, void* out, long long n_rows,
             long long row_bytes, cudaStream_t st) {
  const long long nv = row_bytes / static_cast<long long>(sizeof(V));
  char* o = static_cast<char*>(out);
  if (nv >= THREADS) {
    long long x = (nv + THREADS - 1) / THREADS;
    if (x > MAX_GRID_X) x = MAX_GRID_X;
    const long long y = n_rows < MAX_GRID_Y ? n_rows : MAX_GRID_Y;
    start<V, true>(rows, dim3(static_cast<unsigned>(x),
                              static_cast<unsigned>(y)), o, n_rows, nv, st);
  } else {
    long long x = (n_rows * nv + THREADS - 1) / THREADS;
    if (x > MAX_FLAT_CTAS) x = MAX_FLAT_CTAS;
    start<V, false>(rows, dim3(static_cast<unsigned>(x)), o, n_rows, nv,
                    st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Rows>
int launch(Rows rows, const void* src, void* out, long long n_rows,
           long long row_bytes, cudaStream_t st) {
  switch (width(src, out, row_bytes, rows.rank_stride, rows.row_stride)) {
    case 16:
      return launch_v<uint4>(rows, out, n_rows, row_bytes, st);
    case 8:
      return launch_v<uint2>(rows, out, n_rows, row_bytes, st);
    case 4:
      return launch_v<unsigned>(rows, out, n_rows, row_bytes, st);
    case 2:
      return launch_v<unsigned short>(rows, out, n_rows, row_bytes, st);
    default:
      return launch_v<unsigned char>(rows, out, n_rows, row_bytes, st);
  }
}

bool bad_sizes(long long R, long long rows, long long row_bytes,
               long long rank_stride, long long row_stride) {
  return R <= 0 || rows <= 0 || row_bytes <= 0 || rank_stride < 0 ||
         row_stride < 0;
}

}  // namespace

extern "C" {

// Launch shift_blocks on `stream`: src holds R ranks of K rows of row_bytes
// bytes, row (r, k) at src + r * rank_stride + k * row_stride (each row
// contiguous); shift (R,) int64 in device memory; out (R, K, row_bytes)
// contiguous, disjoint from src. Takes R, K, row_bytes >= 1. Returns the
// CUDA error code of the launch (0 = success).
int staging_shift_blocks(const void* src, void* out, const long long* shift,
                         long long R, long long K, long long row_bytes,
                         long long rank_stride, long long row_stride,
                         void* stream) {
  if (bad_sizes(R, K, row_bytes, rank_stride, row_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const ShiftRows rows{static_cast<const char*>(src), shift, K, rank_stride,
                       row_stride};
  return launch(rows, src, out, R * K, row_bytes,
                static_cast<cudaStream_t>(stream));
}

// Launch pack_blocks on `stream`: src holds R ranks of K rows as above
// (rank_stride is unused for R == 1, the flat form); idx (R, J) int64 in
// device memory; out (R, J, row_bytes) contiguous, disjoint from src; an
// index outside [0, K) writes a zero row. Takes R, J, row_bytes >= 1 and
// K >= 0. Returns the CUDA error code of the launch (0 = success).
int staging_pack_blocks(const void* src, void* out, const long long* idx,
                        long long R, long long J, long long K,
                        long long row_bytes, long long rank_stride,
                        long long row_stride, void* stream) {
  if (bad_sizes(R, J, row_bytes, rank_stride, row_stride) || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PackRows rows{static_cast<const char*>(src), idx, J, K, rank_stride,
                      row_stride};
  return launch(rows, src, out, R * J, row_bytes,
                static_cast<cudaStream_t>(stream));
}

const char* staging_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
