// Tile rasterizer: coverage, strict-< depth test, winner attributes, and the
// G-buffer and/or (Lambert-shaded) uint8 image, written in image layout.
//
// Replaces the TPU kernel cython3dmodelrenderer_tpu/ops/raster_pallas.py
// (_make_kernel_grouped, launched by _raster_tiles_grouped) and, on the
// counting-sort bins, the one-tile kernel _make_kernel (B3). The TPU kernel
// packed 16 count-sorted tiles into the 128 lanes of each candidate chunk,
// resolved depth with lane-class ranks and a roll-doubling epilogue, and
// emitted group-packed blocks that XLA gathered back into image order.
// What it computes is kept; how is not:
//
//  * one block per 16x32 tile (512 threads, one per pixel); with
//    n_views > 1 the grid stacks n_views frames' tiles, block b rendering
//    tile b % tiles_per_view of view b / tiles_per_view at offset
//    view * H * W of (V, H, W, C) outputs, with view-relative pixel
//    coordinates (n_views == 1 is the single-view launch, bit for bit);
//  * the winner of a pixel is the lexicographic minimum of (z, triangle)
//    over the candidates that cover it: what a strict-< walk of the tile's
//    ascending bin keeps. Each covering candidate gives the pixel the
//    64-bit key (bits of z + 0.0f) << 32 | triangle, and the pixel keeps
//    the least. A covered z lies in [0, 1] (the range test), so its bits
//    order as the floats do; + 0.0f folds -0.0 into +0.0, which the walk
//    also treats as equal; NaN fails the range test and never reaches a
//    key. A minimum does not depend on order, so candidates may be taken
//    in any order and every run gives the same bits;
//  * the block stages up to 512 candidates a pass, one per thread: the
//    triangle id from the bin, its 16 geometry columns (three λ planes, the
//    z plane, the ceil bbox) and the bbox's window in the tile, clamped to
//    the tile and the image;
//  * each warp owns a 4 x 8 block of the tile and each lane one pixel of
//    it. A ballot over 32 staged windows at a time gives the warp the
//    candidates whose window meets its block; of those, each lane
//    evaluates only the ones whose window holds its pixel, with the full
//    per-pixel test of the old walk, and keeps its key minimum in a
//    register: no atomics, no shared key array;
//  * the window only bounds the work, it never decides coverage: for an
//    integer px and any float bound, px >= xl <=> px >= ceil(xl) and
//    px < xr <=> px < ceil(xr), so the window holds every pixel that passes
//    the bbox compares. Bounds are clamped as floats before any conversion
//    to int, and a NaN or empty bbox gives an empty window by an explicit
//    !(xl < xr) test (fminf / fmaxf would drop the NaN);
//  * at the end each thread decodes its key, evaluates the winner's z plane
//    again (so a winning -0.0 is written as -0.0, as the walk wrote it) and
//    its attribute planes, and writes color/z/normal and/or the u8 BGR
//    pixel straight to its (H, W, C) position. Pixels of a partial edge
//    tile that lie outside the image are never evaluated or written.
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
// What bounds it on an H100: a frame reads ~68 B per pair (the id and the
// geometry columns) plus ~150 B per covered pixel (the winner's planes) and
// writes 3 B (image) or 28 B (G-buffer) per pixel; the walk needs ~28
// f32 instructions per pixel of a candidate's window, which is what the
// bound counts (ops/raster.py::walk_instructions). Measured (PERF.md §6):
//  * the old walk evaluated every candidate at all 512 pixels of its tile,
//    43x the window pixels at torus262k@1024², and was 65-90% of the time;
//  * a warp per candidate with 64-bit shared atomicMin (a CAS loop on this
//    card) lost at short bins, where half the warps idle; the atomics alone
//    were a third of its walk;
//  * warps owning whole rows met twice the candidates that 4 x 8 blocks
//    meet at 3 x 4-pixel windows;
//  * what remains is latency: a tile's work is a chain of dependent loads
//    (the bin entry, the ids, the rows, the winner's planes), hidden only by
//    the blocks in flight, so the kernel is held to 32 registers for 4
//    blocks an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kBlockH = 4;        // the pixels a warp owns: 4 x 8
constexpr int kBlockW = 8;
constexpr int kChunk = kThreads;  // candidates staged per pass, one a thread
constexpr int kGeom = 16;         // geometry columns: 12 plane coefs + bbox
constexpr int kAttr0 = 16;        // first attribute-plane column
constexpr unsigned long long kNoWinner = ~0ull;

__device__ __forceinline__ float eval_plane(const float* c, float px, float py) {
  return __fadd_rn(__fmul_rn(px, c[0]), __fadd_rn(__fmul_rn(py, c[1]), c[2]));
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(__float2int_rz(v) & 255);
}

// [lo, hi) of the integer positions in [t0, t1) that pass p >= a and p < b:
// the ceil bounds clamped to [t0, t1] as floats, then converted.
__device__ __forceinline__ void window(float a, float b, int t0, int t1,
                                       int* lo, int* len) {
  const float f0 = static_cast<float>(t0), f1 = static_cast<float>(t1);
  const int l = static_cast<int>(fminf(fmaxf(ceilf(a), f0), f1));
  const int h = static_cast<int>(fminf(fmaxf(ceilf(b), f0), f1));
  *lo = l - t0;
  *len = (a < b) ? max(h - l, 0) : 0;    // NaN or empty: no pixel
}

__global__ void __launch_bounds__(kThreads, 4)   // 32 registers: 4 blocks an SM
raster_kernel(const float* __restrict__ rows, int row_w,
              const int* __restrict__ pair_tri,
              const int* __restrict__ tile_starts,
              const int* __restrict__ tile_counts,
              int ntx, int tiles_per_view, int height, int width,
              int n_attrs, float z_init,
              int shade, float lx, float ly, float lz,
              float* __restrict__ color, float* __restrict__ zbuf,
              float* __restrict__ normal, uint8_t* __restrict__ image) {
  __shared__ float4 s_geom[kChunk][kGeom / 4];
  __shared__ int s_tri[kChunk];
  __shared__ int s_win[kChunk];     // x0 | y0 << 8 | w << 16 | h << 24

  const int tile = blockIdx.x;              // stacked (view, local tile) id
  const int view = tile / tiles_per_view;
  const int local = tile - view * tiles_per_view;
  const int ox = (local % ntx) * kTileW;    // the tile's view-relative origin
  const int oy = (local / ntx) * kTileH;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  // each warp owns a 4 x 8 block of the tile, each lane one pixel of it
  const int lane = threadIdx.x % 32;
  const int bx = (threadIdx.x / 32) % (kTileW / kBlockW) * kBlockW;
  const int by = (threadIdx.x / 32) / (kTileW / kBlockW) * kBlockH;
  const int ix = bx + lane % kBlockW;
  const int iy = by + lane / kBlockW;
  const int x = ox + ix;
  const int y = oy + iy;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);

  unsigned long long best = kNoWinner;      // this pixel's least key
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    __syncthreads();                        // the previous chunk is walked
    if (threadIdx.x < n) {
      const int tri = pair_tri[start + c0 + threadIdx.x];
      const float* r = rows + static_cast<size_t>(tri) * row_w;
      float g[kGeom];
#pragma unroll
      for (int c = 0; c < kGeom; ++c) g[c] = r[c];
#pragma unroll
      for (int q = 0; q < kGeom / 4; ++q)
        s_geom[threadIdx.x][q] = make_float4(g[4 * q], g[4 * q + 1],
                                             g[4 * q + 2], g[4 * q + 3]);
      int x0, w, y0, h;
      window(g[12], g[13], ox, min(ox + kTileW, width), &x0, &w);
      window(g[14], g[15], oy, min(oy + kTileH, height), &y0, &h);
      if (w == 0 || h == 0) x0 = y0 = w = h = 0;   // so it meets no block
      s_tri[threadIdx.x] = tri;
      s_win[threadIdx.x] = x0 | (y0 << 8) | (w << 16) | (h << 24);
    }
    __syncthreads();
    for (int base = 0; base < n; base += 32) {
      // the candidates among the next 32 whose window meets this block
      int win = 0;
      if (base + lane < n) win = s_win[base + lane];
      const int x0 = win & 0xff, y0 = (win >> 8) & 0xff;
      const bool meets = (x0 < bx + kBlockW) & (x0 + ((win >> 16) & 0xff) > bx)
                         & (y0 < by + kBlockH) & (y0 + (win >> 24) > by);
      unsigned int hits = __ballot_sync(0xffffffffu, meets);
      while (hits) {
        const int j = __ffs(hits) - 1;
        hits &= hits - 1;
        const int k = base + j;
        const int wk = __shfl_sync(0xffffffffu, win, j);
        if ((static_cast<unsigned>(ix - (wk & 0xff))
             >= static_cast<unsigned>((wk >> 16) & 0xff))
            | (static_cast<unsigned>(iy - ((wk >> 8) & 0xff))
               >= static_cast<unsigned>(wk >> 24)))
          continue;                         // this pixel is outside
        float g[kGeom];
#pragma unroll
        for (int q = 0; q < kGeom / 4; ++q) {
          const float4 v = s_geom[k][q];
          g[4 * q] = v.x; g[4 * q + 1] = v.y; g[4 * q + 2] = v.z; g[4 * q + 3] = v.w;
        }
        const float l0 = eval_plane(g + 0, px, py);
        const float l1 = eval_plane(g + 3, px, py);
        const float l2 = eval_plane(g + 6, px, py);
        const float z = eval_plane(g + 9, px, py);
        const bool good = (l0 >= 0.0f) & (l1 >= 0.0f) & (l2 >= 0.0f)
                          & (px >= g[12]) & (px < g[13])
                          & (py >= g[14]) & (py < g[15])
                          & (z >= 0.0f) & (z <= 1.0f);
        if (good) {
          const unsigned long long key =
              (static_cast<unsigned long long>(
                   __float_as_uint(__fadd_rn(z, 0.0f))) << 32)
              | static_cast<unsigned int>(s_tri[k]);
          best = key < best ? key : best;
        }
      }
    }
  }
  if (x >= width || y >= height) return;

  const bool has = best != kNoWinner;
  float best_z = z_init;
  float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (has) {
    const float* r = rows + static_cast<size_t>(best & 0xffffffffu) * row_w;
    best_z = eval_plane(r + 9, px, py);
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {   // unrolled: a[] stays in registers
      // + 0.0f: a -0.0 plane value reads +0.0, as the JAX kernel's
      // one-hot winner sum gives it
      if (ch < n_attrs)
        a[ch] = __fadd_rn(eval_plane(r + kAttr0 + 3 * ch, px, py), 0.0f);
    }
  }
  const size_t pix = (static_cast<size_t>(view) * height + y) * width + x;
  if (zbuf != nullptr) {
    zbuf[pix] = best_z;
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

// Rasterize n_views stacked (nty x ntx)-tile frames on `stream`. rows:
// (T, row_w) f32 plane rows; pair_tri: the sorted pairs' triangle ids;
// tile_starts / tile_counts: each (view, tile) run in pair_tri, view-major.
// color/zbuf/normal (all set or all null) receive the (V, H, W, C)
// G-buffer, image (or null) the (V, H, W, 3) u8 BGR image. Returns a
// cudaError_t code (0 = launched).
int raster_launch(const float* rows, int row_w, const int* pair_tri,
                  const int* tile_starts, const int* tile_counts,
                  int ntx, int nty, int n_views, int height, int width,
                  int n_attrs,
                  float z_init, int shade, float lx, float ly, float lz,
                  float* color, float* zbuf, float* normal, uint8_t* image,
                  int device, void* stream) {
  if (n_attrs != 3 && n_attrs != 6) return static_cast<int>(cudaErrorInvalidValue);
  if (row_w < kAttr0 + 3 * n_attrs) return static_cast<int>(cudaErrorInvalidValue);
  if (n_views < 1 || static_cast<long long>(ntx) * nty * n_views > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_kernel<<<ntx * nty * n_views, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      rows, row_w, pair_tri, tile_starts, tile_counts, ntx, ntx * nty,
      height, width, n_attrs, z_init, shade, lx, ly, lz, color, zbuf, normal,
      image);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
