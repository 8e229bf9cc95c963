// Tile rasterizer: coverage, strict-< depth test, winner attributes, and the
// G-buffer and/or (Lambert-shaded) uint8 image, written in image layout.
//
// Replaces the TPU kernel cython3dmodelrenderer_tpu/ops/raster_pallas.py
// (_make_kernel_grouped, launched by _raster_tiles_grouped). That kernel
// packed 16 count-sorted tiles into the 128 lanes of each candidate chunk,
// resolved depth with a lane-local running minimum plus a roll-doubling
// epilogue, and emitted group-packed blocks that XLA gathered back into
// image order. None of that is needed here:
//
//  * one block per 16x32 tile, one thread per pixel (512 threads);
//  * the block walks its tile's bin — the sorted (tile, triangle) pair list
//    gives each tile a contiguous run of triangle ids in ascending order —
//    in chunks of 128 candidates. For each chunk the block reads
//    rows[tri] INDIRECTLY through the pair list (no gathered copy of the
//    rows exists) and stages the 16 geometry columns (three λ planes, the
//    z plane, the ceil bbox) in shared memory; every thread then reads the
//    same candidate at once (a shared-memory broadcast);
//  * each thread keeps its running (z, triangle) winner with a strict <,
//    walking candidates in ascending triangle order, so exact z ties go to
//    the earliest triangle with no rank bookkeeping;
//  * at the end the thread evaluates only the winner's attribute planes
//    (read once from global memory) and writes color/z/normal and/or the
//    u8 BGR pixel straight to its (H, W, C) position. Pixels of a partial
//    edge tile that lie outside the image are never written.
//
// Float contract (must match the plain PyTorch version bit for bit):
// planes are evaluated as px*A + (py*B + C) (raster_pallas.py:501-506)
// with explicitly rounded __fmul_rn/__fadd_rn (and the file is built with
// -fmad=false); pixel coordinates are the integer positions tx*32+ix,
// ty*16+iy; NaN coefficients of degenerate triangles fail every compare;
// the u8 cast is int32 truncation then & 255; Lambert follows the kernel's
// order: dot = nx*lx + ny*ly + nz*lz, sqrt(nx*nx + ny*ny + nz*nz),
// clip(dot / (nrm + 1e-6), 0, 1), multiply (raster_pallas.py:642-651).
//
// What bounds it on an H100: per candidate each thread does ~16 flops and
// 9 compares against values broadcast from shared memory, so the block is
// bound by issue rate (ALU + shared-memory loads), not by device memory —
// a frame reads ~64 B per pair plus ~136 B per covered pixel and writes
// 3 B (image) or 28 B (G-buffer) per pixel. Blocks whose tile bins are
// long dominate; a tile with an empty bin only writes its background.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kChunk = 128;       // candidates staged per pass
constexpr int kGeom = 16;         // geometry columns: 12 plane coefs + bbox
constexpr int kAttr0 = 16;        // first attribute-plane column

__device__ __forceinline__ float eval_plane(const float* c, float px, float py) {
  return __fadd_rn(__fmul_rn(px, c[0]), __fadd_rn(__fmul_rn(py, c[1]), c[2]));
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(__float2int_rz(v) & 255);
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ rows, int row_w,
              const int* __restrict__ pair_tri,
              const int* __restrict__ tile_starts,
              const int* __restrict__ tile_counts,
              int ntx, int height, int width, int n_attrs, float z_init,
              int shade, float lx, float ly, float lz,
              float* __restrict__ color, float* __restrict__ zbuf,
              float* __restrict__ normal, uint8_t* __restrict__ image) {
  __shared__ float s_geom[kChunk * kGeom];
  __shared__ int s_tri[kChunk];

  const int tile = blockIdx.x;
  const int ix = threadIdx.x % kTileW;
  const int iy = threadIdx.x / kTileW;
  const int x = (tile % ntx) * kTileW + ix;
  const int y = (tile / ntx) * kTileH + iy;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];

  float best_z = INFINITY;
  int best_tri = -1;
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    __syncthreads();                       // the previous chunk is consumed
    if (threadIdx.x < n) s_tri[threadIdx.x] = pair_tri[start + c0 + threadIdx.x];
    __syncthreads();
    for (int e = threadIdx.x; e < n * kGeom; e += kThreads) {
      const int k = e / kGeom;
      const int col = e % kGeom;
      s_geom[e] = rows[static_cast<size_t>(s_tri[k]) * row_w + col];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* g = &s_geom[k * kGeom];
      const float l0 = eval_plane(g + 0, px, py);
      const float l1 = eval_plane(g + 3, px, py);
      const float l2 = eval_plane(g + 6, px, py);
      const float z = eval_plane(g + 9, px, py);
      const bool good = (l0 >= 0.0f) & (l1 >= 0.0f) & (l2 >= 0.0f)
                        & (px >= g[12]) & (px < g[13])
                        & (py >= g[14]) & (py < g[15])
                        & (z >= 0.0f) & (z <= 1.0f);
      if (good && z < best_z) {
        best_z = z;
        best_tri = s_tri[k];
      }
    }
  }
  if (x >= width || y >= height) return;

  const bool has = best_tri >= 0;
  float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (has) {
    const float* r = rows + static_cast<size_t>(best_tri) * row_w + kAttr0;
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {   // unrolled: a[] stays in registers
      // + 0.0f: a -0.0 plane value reads +0.0, as the JAX kernel's
      // one-hot winner sum gives it
      if (ch < n_attrs) a[ch] = __fadd_rn(eval_plane(r + 3 * ch, px, py), 0.0f);
    }
  }
  const size_t pix = static_cast<size_t>(y) * width + x;
  if (zbuf != nullptr) {
    zbuf[pix] = has ? best_z : z_init;
    for (int c = 0; c < 3; ++c) {
      color[pix * 3 + c] = a[c];
      normal[pix * 3 + c] = a[3 + c];
    }
  }
  if (image != nullptr) {
    float cb = a[0], cg = a[1], cr = a[2];
    if (shade && has) {
      const float nx = a[3], ny = a[4], nz = a[5];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(nx, lx), __fmul_rn(ny, ly)),
                                  __fmul_rn(nz, lz));
      const float nrm = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(nx, nx),
                                                       __fmul_rn(ny, ny)),
                                             __fmul_rn(nz, nz)));
      float s = __fdiv_rn(dot, __fadd_rn(nrm, 1e-6f));
      s = s < 0.0f ? 0.0f : s;             // compares keep NaN, like jnp.clip
      s = s > 1.0f ? 1.0f : s;
      cb = __fmul_rn(cb, s);
      cg = __fmul_rn(cg, s);
      cr = __fmul_rn(cr, s);
    }
    image[pix * 3 + 0] = to_u8(cb);
    image[pix * 3 + 1] = to_u8(cg);
    image[pix * 3 + 2] = to_u8(cr);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rasterize an (nty x ntx)-tile frame on `stream`. rows: (T, row_w) f32
// plane rows; pair_tri: the sorted pairs' triangle ids; tile_starts /
// tile_counts: each tile's run in pair_tri. color/zbuf/normal (all set or
// all null) receive the G-buffer, image (or null) the u8 BGR image.
// Returns a cudaError_t code (0 = launched).
int raster_launch(const float* rows, int row_w, const int* pair_tri,
                  const int* tile_starts, const int* tile_counts,
                  int ntx, int nty, int height, int width, int n_attrs,
                  float z_init, int shade, float lx, float ly, float lz,
                  float* color, float* zbuf, float* normal, uint8_t* image,
                  int device, void* stream) {
  if (n_attrs != 3 && n_attrs != 6) return static_cast<int>(cudaErrorInvalidValue);
  if (row_w < kAttr0 + 3 * n_attrs) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_kernel<<<ntx * nty, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, row_w, pair_tri, tile_starts, tile_counts, ntx, height, width,
      n_attrs, z_init, shade, lx, ly, lz, color, zbuf, normal, image);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
