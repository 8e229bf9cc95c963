// f32 instruction-rate calibration: a chain of multiply-add and
// compare-select over a (grid, 16, 32, 128) f32 input (kernel P2).
//
// Replaces the TPU kernel tools/probes/vpu_cal.py (make.kernel, launched
// by make.run_once). For each of the 16*32*128 elements, walk the grid
// steps IN ORDER:
//
//     acc = x[i] + acc * 1e-30                      (acc = 0 before step 0)
//     repeat n_ops / 2 times, j = 0, 1, ...:
//         acc = acc * x[i] + j
//         acc = acc > x[i] ? acc - x[i] : acc
//
// and write acc after the last step. The TPU ran the grid in order on one
// core and carried acc from step to step in VMEM scratch. Blocks on an
// H100 run in no order, so here one thread owns one element (65,536
// threads) and loops over the steps itself, acc in a register.
//
// Float contract: __fmul_rn / __fadd_rn / __fsub_rn, and the file builds
// with -fmad=false, so a multiply and an add are never fused: each pair of
// ops is FMUL, FADD, FSETP and a predicated FADD (the select folds into
// the predicate) — B1's instruction mix (csrc/raster.cu), which is what is
// being calibrated.
// The plain PyTorch version (probes/vpu_cal.py::run_once_plain) rounds the
// same way, so the two agree bit for bit; acc never turns NaN (it stays
// >= 0, and an overflow to inf stays inf).
//
// What bounds it on an H100: operations. At n_ops = 512 and 64 steps the
// chain is 65,536 * 64 * 256 * 4 = 4.3e9 instructions (0.128 ms at 33.5 T
// f32 instructions/s) against 17 MB read (5 us at 3.35 TB/s). Each thread's
// chain is dependent, and 2,048 warps (about 15 per SM) are in flight, so
// the latency of a dependent FP32 instruction may hold it below the peak;
// measuring that is the point, so the design does nothing about it. n_ops
// is a template parameter so the loop unrolls fully and j is an immediate,
// as in the TPU kernel's unrolled Python loop.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
vpu_cal_kernel(const float* __restrict__ x, int grid, int n,
               float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int i = 0; i < grid; ++i) {
    const float xi = x[static_cast<size_t>(i) * n + e];
    acc = __fadd_rn(xi, __fmul_rn(acc, 1e-30f));
#pragma unroll
    for (int j = 0; j < NOPS / 2; ++j) {
      acc = __fadd_rn(__fmul_rn(acc, xi), static_cast<float>(j));
      acc = acc > xi ? __fsub_rn(acc, xi) : acc;
    }
  }
  out[e] = acc;
}

template <int NOPS>
cudaError_t launch(const float* x, int grid, int n, float* out,
                   cudaStream_t stream) {
  vpu_cal_kernel<NOPS><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(x, grid, n, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One run on `stream`: x (grid, n) f32, out (n,) f32. n_ops is one of 8,
// 32, 128, 512. Returns a cudaError_t code (0 = launched).
int vpu_cal_launch(const float* x, int grid, int n, int n_ops, float* out,
                   int device, void* stream) {
  if (grid <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_ops) {
    case 8: err = launch<8>(x, grid, n, out, s); break;
    case 32: err = launch<32>(x, grid, n, out, s); break;
    case 128: err = launch<128>(x, grid, n, out, s); break;
    case 512: err = launch<512>(x, grid, n, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
