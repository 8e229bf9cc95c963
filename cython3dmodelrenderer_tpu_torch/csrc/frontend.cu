// The frame's front end in one pass (kernel F1): pose, cull, projection,
// fast shade, plane rows and tile spans.
//
// Replaces XLA glue, not a pallas_call site: inside its jitted frame the
// JAX package fuses cython3dmodelrenderer_tpu/fillers.py:54
// (_geometry_stage: visibility_masks + project_to_screen), the fast-shade
// lambert_shade of the vertex colours (ops/raster_pallas.py:1406-1410) and
// ops/binning.py:52 (plane_data) into a few XLA kernels; a sweep adds each
// view's pose (parallel/multiview.py:64-77, 189-229). Eager PyTorch ran the
// same chain as ~150 operations a frame and ~170 a view of a sweep batch.
// The wrapper is ops/frontend.py::frame_planes; its plain version,
// frame_planes_plain, is that chain, and F1 equals it bit for bit.
//
// One thread a (view, triangle), i = v * n_tris + t, computing in order:
//  1. the pose (when poses is given): v @ R^T + shift and n @ R^T, each
//     dot product (a0*b0 + a1*b1) + a2*b2 (ops/transforms.py::_dot3);
//  2. the culling masks on the posed arrays: degenerate iff the 2-D edge
//     cross is 0, backfacing iff ((n0z + n1z) + n2z) / 3 >= 0;
//  3. the projection ((x*P0j + y*P1j) + z*P2j) + P3j with every product,
//     the zeros' too (a NaN, an inf or a -0.0 carries as in torch), then
//     the divide by w;
//  4. fast shade: each vertex colour times clip(dot / (|n| + 1e-6), 0, 1)
//     with dot = ((nx*lx + 0.0) + ny*ly) + nz*lz (illumination.py);
//  5. plane_data: the three lambda planes by IEEE division, the z plane,
//     the clipped ceil bbox (amin/amax propagate NaN; ceil, clamp to
//     [0, hi], NaN -> 0, int), the empty-bbox rule, the attribute planes,
//     and the spans with their floor divisions.
// Every multiply and add rounds on its own: cuda_build's NVCC_FLAGS carry
// -fmad=false, and nvcc's defaults give IEEE division and square root.
//
// Outputs: rows (n, 16 + 3 * n_attrs) f32, spans (5, n) int32 = tx0, cx,
// ty0 + v * nty, cy, cx * cy, and the int64 pair total, summed by integer
// atomics (order-free) after a memset in the launcher.
//
// What bounds it on an H100: each (view, triangle) reads 72 bytes of
// vertices and normals (108 with colours) and writes a 64-136-byte row and
// 20 bytes of spans, against ~200-300 f32 instructions: ~264 bytes a
// triangle at 6 channels, so the memory bound (~1.3 us at 16,128
// triangles) is far below the launch latency. The design is one pass with
// no scratch memory, each input read once and each output written once.
// Rows are stored row by row (each thread's 64-136 bytes, uncoalesced
// across the warp); staging them through shared memory is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowHead = 16;         // 12 plane coefficients + the bbox

struct Frame {
  float pm[4][4];          // the row-vector projection matrix
  float half_w, half_h;    // width / 2, height / 2
  int width, height, tile_w, tile_h, nty;
  int n_attrs;             // 0, 3 (colours) or 6 (colours, normals)
  int shade;               // bake Lambert into the vertex colours
  float lx, ly, lz;        // the pre-negated unit light
};

// torch.amin / torch.amax over three values: NaN when any is NaN
__device__ __forceinline__ float amin3(float a, float b, float c) {
  if (isnan(a) || isnan(b) || isnan(c)) return nanf("");
  return fminf(fminf(a, b), c);
}

__device__ __forceinline__ float amax3(float a, float b, float c) {
  if (isnan(a) || isnan(b) || isnan(c)) return nanf("");
  return fmaxf(fmaxf(a, b), c);
}

// raster_ref._clipped_ceil: clamp(ceil(v), 0, hi), NaN -> 0, to int32
__device__ __forceinline__ int clipped_ceil(float v, int hi) {
  const float c = ceilf(v);
  if (isnan(c)) return 0;
  return static_cast<int>(fminf(fmaxf(c, 0.0f), static_cast<float>(hi)));
}

// floor division by a positive divisor (torch's // on int32)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// binning.plane_data's coeffs: lambda around vertex a with edge b -> c
__device__ __forceinline__ void coeffs(float xa, float ya, float xb, float yb,
                                       float xc, float yc, float* a, float* b,
                                       float* c) {
  const float d = (xb - xc) * (ya - yc) - (yb - yc) * (xa - xc);
  *a = -(yb - yc) / d;
  *b = (xb - xc) / d;
  *c = ((yb - yc) * xc - (xb - xc) * yc) / d;
}

__global__ void __launch_bounds__(kThreads)
frontend_kernel(const float* __restrict__ verts,
                const float* __restrict__ norms,
                const float* __restrict__ colors,
                const float* __restrict__ poses, int n_tris, int n_views,
                Frame f, float* __restrict__ rows, int* __restrict__ spans,
                unsigned long long* __restrict__ total) {
  const long long n = static_cast<long long>(n_tris) * n_views;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  long long pairs = 0;
  if (i < n) {
    const int view = static_cast<int>(i / n_tris);
    const long long t = i - static_cast<long long>(view) * n_tris;
    float p[3][3], nr[3][3];
    for (int k = 0; k < 3; ++k)
      for (int j = 0; j < 3; ++j) {
        p[k][j] = verts[t * 9 + k * 3 + j];
        nr[k][j] = norms[t * 9 + k * 3 + j];
      }
    if (poses != nullptr) {          // q[r * 3 + c] = R^T[r][c], q[9 + j] = shift
      const float* q = poses + view * 12;
      for (int k = 0; k < 3; ++k) {
        float pv[3], nv[3];
        for (int j = 0; j < 3; ++j) {
          pv[j] = ((p[k][0] * q[j] + p[k][1] * q[3 + j]) + p[k][2] * q[6 + j])
                  + q[9 + j];
          nv[j] = (nr[k][0] * q[j] + nr[k][1] * q[3 + j]) + nr[k][2] * q[6 + j];
        }
        for (int j = 0; j < 3; ++j) {
          p[k][j] = pv[j];
          nr[k][j] = nv[j];
        }
      }
    }

    // projection.visibility_masks on the (posed) arrays
    const float e1x = p[1][0] - p[0][0], e1y = p[1][1] - p[0][1];
    const float e2x = p[2][0] - p[0][0], e2y = p[2][1] - p[0][1];
    const float cross = e1x * e2y - e1y * e2x;
    const float mean_nz = ((nr[0][2] + nr[1][2]) + nr[2][2]) / 3.0f;
    const bool active = !(cross == 0.0f) && !(mean_nz >= 0.0f);

    // projection.project_to_screen
    float sx[3], sy[3], sz[3];
    for (int k = 0; k < 3; ++k) {
      const float x = p[k][0], y = p[k][1], z = p[k][2];
      float h[4];
      for (int j = 0; j < 4; ++j)
        h[j] = ((x * f.pm[0][j] + y * f.pm[1][j]) + z * f.pm[2][j]) + f.pm[3][j];
      sx[k] = (h[0] / h[3] + 1.0f) * f.half_w;
      sy[k] = (h[1] / h[3] + 1.0f) * f.half_h;
      sz[k] = h[2] / h[3];
    }

    // binning.plane_data
    float a0, b0, c0, a1, b1, c1, a2, b2, c2;
    coeffs(sx[0], sy[0], sx[1], sy[1], sx[2], sy[2], &a0, &b0, &c0);
    coeffs(sx[1], sy[1], sx[2], sy[2], sx[0], sy[0], &a1, &b1, &c1);
    coeffs(sx[2], sy[2], sx[0], sy[0], sx[1], sy[1], &a2, &b2, &c2);
    int xl = clipped_ceil(amin3(sx[0], sx[1], sx[2]), f.width);
    int xr = clipped_ceil(amax3(sx[0], sx[1], sx[2]), f.width);
    int yl = clipped_ceil(amin3(sy[0], sy[1], sy[2]), f.height);
    int yr = clipped_ceil(amax3(sy[0], sy[1], sy[2]), f.height);
    const bool nonempty = active && xr > xl && yr > yl;
    if (!nonempty) xl = xr = yl = yr = 0;

    const int width = kRowHead + 3 * f.n_attrs;
    float* row = rows + i * width;
    row[0] = a0; row[1] = b0; row[2] = c0;
    row[3] = a1; row[4] = b1; row[5] = c1;
    row[6] = a2; row[7] = b2; row[8] = c2;
    row[9] = (a0 * sz[0] + a1 * sz[1]) + a2 * sz[2];
    row[10] = (b0 * sz[0] + b1 * sz[1]) + b2 * sz[2];
    row[11] = (c0 * sz[0] + c1 * sz[1]) + c2 * sz[2];
    row[12] = static_cast<float>(xl);
    row[13] = static_cast<float>(xr);
    row[14] = static_cast<float>(yl);
    row[15] = static_cast<float>(yr);
    if (f.n_attrs > 0) {
      float val[3][6];                // per vertex: B G R [nx ny nz]
      for (int k = 0; k < 3; ++k) {
        float s = 1.0f;
        if (f.shade) {                // illumination.lambert_shade
          const float nx = nr[k][0], ny = nr[k][1], nz = nr[k][2];
          const float dot = ((nx * f.lx + 0.0f) + ny * f.ly) + nz * f.lz;
          const float norm = sqrtf((nx * nx + ny * ny) + nz * nz);
          s = dot / (norm + 1e-6f);
          s = s < 0.0f ? 0.0f : s;    // a NaN shadow stays NaN
          s = s > 1.0f ? 1.0f : s;
        }
        for (int ch = 0; ch < 3; ++ch) {
          const float c = colors[t * 9 + k * 3 + ch];
          val[k][ch] = f.shade ? c * s : c;
        }
        for (int ch = 3; ch < 6; ++ch) val[k][ch] = nr[k][ch - 3];
      }
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {   // static indices: val stays in registers
        if (ch >= f.n_attrs) break;
        const float v0 = val[0][ch], v1 = val[1][ch], v2 = val[2][ch];
        row[kRowHead + 3 * ch] = (a0 * v0 + a1 * v1) + a2 * v2;
        row[kRowHead + 3 * ch + 1] = (b0 * v0 + b1 * v1) + b2 * v2;
        row[kRowHead + 3 * ch + 2] = (c0 * v0 + c1 * v1) + c2 * v2;
      }
    }

    const int tx0 = nonempty ? floor_div(xl, f.tile_w) : 0;
    const int tx1 = nonempty ? floor_div(xr - 1, f.tile_w) : -1;
    const int ty0 = nonempty ? floor_div(yl, f.tile_h) : 0;
    const int ty1 = nonempty ? floor_div(yr - 1, f.tile_h) : -1;
    const int cx = max(tx1 - tx0 + 1, 0);
    const int cy = max(ty1 - ty0 + 1, 0);
    spans[i] = tx0;
    spans[n + i] = cx;
    spans[2 * n + i] = ty0 + view * f.nty;
    spans[3 * n + i] = cy;
    spans[4 * n + i] = cx * cy;
    pairs = static_cast<long long>(cx) * cy;
  }
  for (int o = 16; o > 0; o >>= 1) pairs += __shfl_down_sync(kFull, pairs, o);
  if ((threadIdx.x & 31) == 0 && pairs != 0)
    atomicAdd(total, static_cast<unsigned long long>(pairs));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// verts, norms (n_tris, 3, 3) f32; colors (n_tris, 3, 3) f32 or null when
// n_attrs == 0; poses (n_views, 4, 3) f32 (R^T over the shift) or null for
// one unposed view; pm the 16 floats of the projection matrix (host
// memory). Writes rows (n_views * n_tris, 16 + 3 * n_attrs), spans
// (5, n_views * n_tris) and the int64 total. Returns a cudaError_t code.
int frontend_launch(const float* verts, const float* norms,
                    const float* colors, const float* poses, int n_tris,
                    int n_views, const float* pm, int width, int height,
                    int tile_w, int tile_h, int n_attrs, int shade, float lx,
                    float ly, float lz, float* rows, int* spans,
                    long long* total, int device, void* stream) {
  const long long n = static_cast<long long>(n_tris) * n_views;
  if (n_tris < 0 || n_views < 1 || (n_views > 1 && poses == nullptr)
      || !(n_attrs == 0 || n_attrs == 3 || n_attrs == 6)
      || (n > 0 && n_attrs > 0 && colors == nullptr) || (shade && n_attrs == 0)
      || width < 1 || height < 1 || tile_w < 1 || tile_h < 1
      || n > static_cast<long long>(kThreads) * 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(total, 0, sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  Frame f;
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) f.pm[r][c] = pm[r * 4 + c];
  f.half_w = static_cast<float>(width / 2.0);
  f.half_h = static_cast<float>(height / 2.0);
  f.width = width;
  f.height = height;
  f.tile_w = tile_w;
  f.tile_h = tile_h;
  f.nty = (height + tile_h - 1) / tile_h;
  f.n_attrs = n_attrs;
  f.shade = shade;
  f.lx = lx;
  f.ly = ly;
  f.lz = lz;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  frontend_kernel<<<blocks, kThreads, 0, s>>>(
      verts, norms, colors, poses, n_tris, n_views, f, rows, spans,
      reinterpret_cast<unsigned long long*>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
