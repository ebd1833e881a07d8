// Device memory that processes on one card share through CUDA IPC: the
// slots of the "shm" transport (distributed/transport.py), which a sender
// fills and its receiver reads in place, device to device, with no host
// copy (the paper's PiP ranks reading each other's buffers).
//
// No kernel: this file replaces no TPU kernel and moves no byte itself.
// It allocates, exports, opens, closes and frees. A slot comes from
// cudaMalloc and not from PyTorch's caching allocator: a block of that
// allocator sits at an offset inside a segment, and an expandable segment
// cannot be exported by legacy IPC at all. The copies in and out of a slot
// are PyTorch's, on its current stream, ordered across processes by the
// interprocess events the transport records.
//
// Every function takes the card's index (the runtime linked into this
// library keeps its own current device) and returns the cudaError_t.
#include <cuda_runtime.h>
#include <stdint.h>

static_assert(sizeof(cudaIpcMemHandle_t) == 64,
              "the transport's control block holds 64-byte handles");

extern "C" {

// bytes of device memory at *ptr, its IPC handle written to handle[0..63]
int ipc_alloc(int device, long long bytes, void** ptr, char* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = 0;
    return (int)err;
  }
  const char* src = (const char*)&h;
  for (int i = 0; i < (int)sizeof(h); ++i) handle[i] = src[i];
  return 0;
}

// another process's allocation, mapped into this one at *ptr
int ipc_open(int device, const char* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  char* dst = (char*)&h;
  for (int i = 0; i < (int)sizeof(h); ++i) dst[i] = handle[i];
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// unmap what ipc_open mapped (before its owner frees it)
int ipc_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaIpcCloseMemHandle(ptr);
}

// free what ipc_alloc allocated
int ipc_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFree(ptr);
}

const char* ipc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
