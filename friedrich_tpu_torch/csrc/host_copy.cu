// Host-memory helpers of the out-of-core factorization
// (friedrich_tpu_torch/ops/outofcore.py): page-locking a host buffer that
// torch allocated, and strided copies between it and the card on a stream.
// No kernels: the copies run on the card's copy engines.

#include <cuda_runtime.h>

#include <cstddef>

extern "C" {

// Page-locks `bytes` of host memory at `p` (cudaHostRegister), so that
// copies from and to it run asynchronously at the link's rate.
int friedrich_host_register(void* p, size_t bytes) {
  return static_cast<int>(cudaHostRegister(p, bytes, cudaHostRegisterDefault));
}

int friedrich_host_unregister(void* p) {
  return static_cast<int>(cudaHostUnregister(p));
}

// 1 if the host memory at `p` is page-locked (registered or allocated by
// CUDA), else 0.
int friedrich_host_is_locked(const void* p) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, p) != cudaSuccess) {
    cudaGetLastError();  // clear the error an unknown pointer leaves
    return 0;
  }
  return attr.type == cudaMemoryTypeHost ? 1 : 0;
}

// `height` rows of `width` bytes from `src` (row pitch `spitch` bytes) to
// `dst` (row pitch `dpitch`), host to card (`to_device` != 0) or card to
// host, queued on `stream`.
int friedrich_copy_2d(void* dst, size_t dpitch, const void* src, size_t spitch, size_t width,
                      size_t height, int to_device, void* stream) {
  return static_cast<int>(cudaMemcpy2DAsync(
      dst, dpitch, src, spitch, width, height,
      to_device ? cudaMemcpyHostToDevice : cudaMemcpyDeviceToHost,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
