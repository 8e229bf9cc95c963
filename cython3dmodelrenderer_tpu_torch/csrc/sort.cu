// Bitonic sort of non-negative int32 keys, ascending, in place.
//
// Replaces the TPU kernel cython3dmodelrenderer_tpu/ops/sort_pallas.py
// (_make_kernel, launched by bitonic_sort_i32), which ran the whole network
// on a VMEM-resident (n/128, 128) block with lane/sublane rolls. Here:
//
//  * n <= 2^15 keys: ONE block of 1024 threads sorts them in shared memory
//    (up to 128 KB of dynamic shared memory, above the 48 KB default, so
//    the launcher raises the kernel's limit with cudaFuncSetAttribute);
//  * larger n: every 2^15-key block sorts itself in shared memory with the
//    direction its global index gives, then each later merge stage k runs
//    its wide distances (j >= 2^15) as one global-memory pass per j and its
//    narrow ones (j < 2^15) as one shared-memory pass over each block.
//
// The caller pads n to a power of two with INT32_MAX (the padding sorts to
// the tail). The frame's pair keys are unique, though duplicates sort too.
//
// What bounds it on an H100: the single-block case is latency bound — one
// SM walks log2(n)(log2(n)+1)/2 passes with a block barrier between each
// (120 passes at n = 2^15), touching 128 KB of shared memory per pass; the
// other 131 SMs idle. The frame's pair lists (tens of thousands of keys)
// fit this case. Above 2^15 keys each global pass reads and writes all n
// keys once (bandwidth bound, 8n bytes per pass).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBlockKeys = 1 << 15;            // keys per shared-memory block

// index of the lower element of the t-th compare pair at distance j
// (insert a zero bit at position log2(j) into t)
__device__ __forceinline__ int pair_low(int t, int j) {
  return 2 * t - (t & (j - 1));
}

__device__ __forceinline__ void compare_swap(int* s, int i, int l, bool asc) {
  const int a = s[i];
  const int b = s[l];
  if ((a > b) == asc) {
    s[i] = b;
    s[l] = a;
  }
}

// Stages k = 2..len of the network over one block of `len` keys. The
// direction of each pair comes from its GLOBAL index (ascending iff
// (i & k) == 0), so neighbouring blocks come out in alternating order,
// ready for the merge stages above `len`.
__global__ void __launch_bounds__(kThreads)
sort_blocks_kernel(int* __restrict__ keys, int len) {
  extern __shared__ int s[];
  const int base = blockIdx.x * len;
  for (int t = threadIdx.x; t < len; t += blockDim.x) s[t] = keys[base + t];
  __syncthreads();
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < len / 2; t += blockDim.x) {
        const int i = pair_low(t, j);
        compare_swap(s, i, i + j, ((base + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < len; t += blockDim.x) keys[base + t] = s[t];
}

// The distances j < len of merge stage k, one block of `len` keys each.
__global__ void __launch_bounds__(kThreads)
merge_blocks_kernel(int* __restrict__ keys, int len, int k) {
  extern __shared__ int s[];
  const int base = blockIdx.x * len;
  for (int t = threadIdx.x; t < len; t += blockDim.x) s[t] = keys[base + t];
  __syncthreads();
  for (int j = len >> 1; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < len / 2; t += blockDim.x) {
      const int i = pair_low(t, j);
      compare_swap(s, i, i + j, ((base + i) & k) == 0);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < len; t += blockDim.x) keys[base + t] = s[t];
}

// One compare-exchange pass of stage k at distance j over all n keys.
__global__ void global_pass_kernel(int* __restrict__ keys, int n, int k, int j) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const int i = pair_low(t, j);
  compare_swap(keys, i, i + j, (i & k) == 0);
}

cudaError_t allow_shared(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      sort_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(merge_blocks_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sort keys[0:n) ascending in place on `stream`. n must be a power of two
// >= 2 (the wrapper pads). Returns a cudaError_t code (0 = launched).
int sort_i32_launch(int* keys, int n, int device, void* stream) {
  if (n < 2 || (n & (n - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int len = n < kBlockKeys ? n : kBlockKeys;
  const size_t smem = static_cast<size_t>(len) * sizeof(int);
  err = allow_shared(smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  sort_blocks_kernel<<<n / len, kThreads, smem, st>>>(keys, len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 2 * len; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= len; j >>= 1) {
      const int threads = 256;
      const int blocks = (n / 2 + threads - 1) / threads;
      global_pass_kernel<<<blocks, threads, 0, st>>>(keys, n, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    merge_blocks_kernel<<<n / len, kThreads, smem, st>>>(keys, len, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
