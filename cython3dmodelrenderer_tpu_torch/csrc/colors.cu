// The fallback colours of an untextured model, from pinned host memory to
// the (T, 3, 3) float32 colours F1 reads.
//
// The renderer draws one colour a triangle, (T, 3) uint8, into a pinned
// host buffer (native/mt_draw.cpp). This kernel reads those bytes straight
// from the host over PCIe (pinned memory is mapped into the device's
// address space) and writes each colour three times, once a vertex, as
// float32. It stands for a copy to the card and an expand, which cost the
// host two PyTorch calls and a launch more; it has no TPU counterpart.
//
// Block b owns triangles [256 b, 256 b + 256): it reads their 768 bytes
// in 4-byte words (3 * 256 b is a multiple of 4) into shared memory, the
// tail of a last partial block byte by byte, then writes 9 floats a
// triangle, coalesced. A byte to float conversion is exact, so the result
// equals the plain version (ops/colors.py::vertex_colors_plain) bit for
// bit. Bound: bytes, 3 read and 36 written a triangle.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // triangles a block

__global__ void vertex_colors_kernel(const uint8_t* __restrict__ bytes,
                                     int64_t n_tris, float* __restrict__ out) {
  __shared__ __align__(4) uint8_t tile[3 * kThreads];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int n = static_cast<int>(
      n_tris - first < kThreads ? n_tris - first : kThreads);
  const uint8_t* src = bytes + 3 * first;
  const int n_bytes = 3 * n;
  const int n_words = n_bytes / 4;
  for (int k = threadIdx.x; k < n_words; k += kThreads)
    reinterpret_cast<uint32_t*>(tile)[k] =
        reinterpret_cast<const uint32_t*>(src)[k];
  for (int k = 4 * n_words + threadIdx.x; k < n_bytes; k += kThreads)
    tile[k] = src[k];
  __syncthreads();
  float* dst = out + 9 * first;
  for (int k = threadIdx.x; k < 9 * n; k += kThreads)
    dst[k] = static_cast<float>(tile[3 * (k / 9) + k % 3]);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One launch on `stream`: host_bytes (n_tris, 3) uint8 in pinned host
// memory, out (n_tris, 3, 3) float32 on `device`. Returns a cudaError_t
// code (0 = launched); memory that is not pinned gives an error.
int vertex_colors_launch(void* host_bytes, int64_t n_tris, float* out,
                         int device, void* stream) {
  if (n_tris <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* bytes = nullptr;
  err = cudaHostGetDevicePointer(&bytes, host_bytes, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: every launcher checks the last error
    return static_cast<int>(err);
  }
  const int64_t blocks = (n_tris + kThreads - 1) / kThreads;
  vertex_colors_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), n_tris, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
