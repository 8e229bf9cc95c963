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
// Outputs: rows (n, 16 + 3 * n_attrs) f32, allocated in whole blocks of
// kThreads rows (the caller returns the first n), spans (5, n) int32 =
// tx0, cx, ty0 + v * nty, cy, cx * cy, and the int64 pair total.
//
// What bounds it on an H100: each (view, triangle) reads 72 bytes of
// vertices and normals (108 with colours) and writes a 64-136-byte row and
// 20 bytes of spans, against ~200-300 f32 instructions and ~21 IEEE
// divisions: ~264 bytes a triangle at 6 channels, so bytes bound it
// (0.0207 ms at 262,144 triangles; at 16,128, 1.3 us, below a launch's
// latency, where the chain of divisions a thread runs sets the time).
// The design moves every byte in whole sectors:
//  - a block of kThreads (view, triangle)s first copies its triangles'
//    vertices, normals and colours (one run of kThreads * 36 bytes each,
//    wrapping to the arrays' start at a view boundary) into shared memory
//    with coalesced 4-byte loads; a thread reads its 9 floats at a stride
//    of 9 words, free of bank conflicts;
//  - each thread stages its row in shared memory (float4 stores for 16
//    columns, float2 for 34, floats for 25: at most 4-way conflicts, none
//    at 25 or 34), and one thread hands the block's contiguous
//    kThreads * row bytes to the copy engine (cp.async.bulk, TMA) after
//    fence.proxy.async; it waits for the engine's read before the block
//    exits; spans are stored coalesced, a word a thread;
//  - 128 threads a block give 16,128 triangles 126 blocks on the 132 SMs
//    and cap the static shared memory at 31,264 bytes (7 blocks an SM);
//  - the pair total comes in the same launch: each block adds its count to
//    a cached accumulator (integer atomics: exact in any order), fences
//    and takes a ticket; the last block writes the total and zeroes the
//    accumulator and the ticket for the next call (no memset).
// Measured on an H100 (PERF.md §6), 262,144 triangles at 6
// channels reach 0.56 of the bytes bound: the row copy streams at ~2.5
// TB/s, but each block loads, computes and stores in turn, and 7 blocks
// an SM keep too few input loads in flight to cover the rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowHead = 16;         // 12 plane coefficients + the bbox
constexpr int kTriFloats = 9;        // a triangle's 3 x 3 floats

struct Frame {
  float pm[4][4];          // the row-vector projection matrix
  float half_w, half_h;    // width / 2, height / 2
  int width, height, tile_w, tile_h, nty;
  int shade;               // bake Lambert into the vertex colours
  float lx, ly, lz;        // the pre-negated unit light
};

// A block's shared memory: the staged rows first (the bulk copy's source,
// 128-byte aligned), then the inputs, then the warps' pair counts.
template <int kAttrs>
struct Staging {
  static constexpr int kWidth = kRowHead + 3 * kAttrs;
  static constexpr int kInputs = kAttrs > 0 ? 3 : 2;
  float rows[kThreads * kWidth];
  float in[kInputs][kThreads * kTriFloats];
  long long pairs[kWarps];
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

// A thread's row into its staging slot (16-byte aligned at 16 columns,
// 8-byte at 34) in the widest stores the alignment allows.
template <int W>
__device__ __forceinline__ void stage_row(float* dst, const float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W; c += 4)
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int c = 0; c < W; c += 2)
      *reinterpret_cast<float2*>(dst + c) = make_float2(v[c], v[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) dst[c] = v[c];
  }
}

template <int kAttrs>
__global__ void __launch_bounds__(kThreads)
frontend_kernel(const float* __restrict__ verts,
                const float* __restrict__ norms,
                const float* __restrict__ colors,
                const float* __restrict__ poses, int n_tris, long long n,
                Frame f, float* __restrict__ rows, int* __restrict__ spans,
                long long* __restrict__ total,
                unsigned long long* __restrict__ sync) {
  using S = Staging<kAttrs>;
  constexpr int kWidth = S::kWidth;
  __shared__ __align__(128) S s;
  const int tid = threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int k = static_cast<int>(
      n - i0 < kThreads ? n - i0 : static_cast<long long>(kThreads));
  int view0 = 0;                     // the block's first (view, triangle)
  long long t0 = 0;
  if (n_tris > 0) {
    view0 = static_cast<int>(i0 / n_tris);
    t0 = i0 - static_cast<long long>(view0) * n_tris;
  }

  // the block's triangles: one run of k * 9 floats from t0 * 9, wrapping
  // to the arrays' start at each view boundary; coalesced 4-byte loads
  const long long run = static_cast<long long>(kTriFloats) * n_tris;
#pragma unroll
  for (int r = 0; r < kTriFloats; ++r) {
    const int e = r * kThreads + tid;
    if (e < k * kTriFloats) {
      long long src = t0 * kTriFloats + e;
      while (src >= run) src -= run;
      s.in[0][e] = verts[src];
      s.in[1][e] = norms[src];
      if constexpr (kAttrs > 0) s.in[2][e] = colors[src];
    }
  }
  __syncthreads();

  long long pairs = 0;
  if (tid < k) {
    const long long i = i0 + tid;
    long long t = t0 + tid;
    int view = view0;
    while (t >= n_tris) {
      t -= n_tris;
      ++view;
    }
    const float* vin = s.in[0] + tid * kTriFloats;
    const float* nin = s.in[1] + tid * kTriFloats;
    float p[3][3], nr[3][3];
    for (int k3 = 0; k3 < 3; ++k3)
      for (int j = 0; j < 3; ++j) {
        p[k3][j] = vin[k3 * 3 + j];
        nr[k3][j] = nin[k3 * 3 + j];
      }
    if (poses != nullptr) {          // q[r * 3 + c] = R^T[r][c], q[9 + j] = shift
      const float* q = poses + view * 12;
      for (int k3 = 0; k3 < 3; ++k3) {
        float pv[3], nv[3];
        for (int j = 0; j < 3; ++j) {
          pv[j] = ((p[k3][0] * q[j] + p[k3][1] * q[3 + j]) + p[k3][2] * q[6 + j])
                  + q[9 + j];
          nv[j] = (nr[k3][0] * q[j] + nr[k3][1] * q[3 + j])
                  + nr[k3][2] * q[6 + j];
        }
        for (int j = 0; j < 3; ++j) {
          p[k3][j] = pv[j];
          nr[k3][j] = nv[j];
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
    for (int k3 = 0; k3 < 3; ++k3) {
      const float x = p[k3][0], y = p[k3][1], z = p[k3][2];
      float h[4];
      for (int j = 0; j < 4; ++j)
        h[j] = ((x * f.pm[0][j] + y * f.pm[1][j]) + z * f.pm[2][j]) + f.pm[3][j];
      sx[k3] = (h[0] / h[3] + 1.0f) * f.half_w;
      sy[k3] = (h[1] / h[3] + 1.0f) * f.half_h;
      sz[k3] = h[2] / h[3];
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

    float row[kWidth];
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
    if constexpr (kAttrs > 0) {
      const float* cin = s.in[2] + tid * kTriFloats;
      float val[3][6];                // per vertex: B G R [nx ny nz]
      for (int k3 = 0; k3 < 3; ++k3) {
        float sh = 1.0f;
        if (f.shade) {                // illumination.lambert_shade
          const float nx = nr[k3][0], ny = nr[k3][1], nz = nr[k3][2];
          const float dot = ((nx * f.lx + 0.0f) + ny * f.ly) + nz * f.lz;
          const float norm = sqrtf((nx * nx + ny * ny) + nz * nz);
          sh = dot / (norm + 1e-6f);
          sh = sh < 0.0f ? 0.0f : sh;  // a NaN shadow stays NaN
          sh = sh > 1.0f ? 1.0f : sh;
        }
        for (int ch = 0; ch < 3; ++ch) {
          const float c = cin[k3 * 3 + ch];
          val[k3][ch] = f.shade ? c * sh : c;
        }
        for (int ch = 3; ch < 6; ++ch) val[k3][ch] = nr[k3][ch - 3];
      }
#pragma unroll
      for (int ch = 0; ch < kAttrs; ++ch) {
        const float v0 = val[0][ch], v1 = val[1][ch], v2 = val[2][ch];
        row[kRowHead + 3 * ch] = (a0 * v0 + a1 * v1) + a2 * v2;
        row[kRowHead + 3 * ch + 1] = (b0 * v0 + b1 * v1) + b2 * v2;
        row[kRowHead + 3 * ch + 2] = (c0 * v0 + c1 * v1) + c2 * v2;
      }
    }
    stage_row<kWidth>(s.rows + tid * kWidth, row);

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
  if ((tid & 31) == 0) s.pairs[tid >> 5] = pairs;
  // the staged rows become visible to the copy engine (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (tid != 0) return;

  if (k > 0) {                       // the block's kThreads rows, one copy
    const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(s.rows));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n\t"
        "cp.async.bulk.commit_group;"
        :: "l"(rows + i0 * kWidth), "r"(src),
           "r"(static_cast<unsigned>(sizeof(s.rows)))
        : "memory");
  }
  long long block_pairs = 0;
  for (int w = 0; w < kWarps; ++w) block_pairs += s.pairs[w];
  if (block_pairs != 0)
    atomicAdd(&sync[0], static_cast<unsigned long long>(block_pairs));
  __threadfence();                   // the count lands before the ticket
  if (atomicAdd(&sync[1], 1ull) == gridDim.x - 1ull) {
    __threadfence();                 // every other block's count is in
    *total = static_cast<long long>(atomicExch(&sync[0], 0ull));
    atomicExch(&sync[1], 0ull);
  }
  if (k > 0)                         // the engine has read the staging area
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <int kAttrs>
cudaError_t launch(const float* verts, const float* norms,
                   const float* colors, const float* poses, int n_tris,
                   long long n, const Frame& f, float* rows, int* spans,
                   long long* total, unsigned long long* sync,
                   cudaStream_t s) {
  const long long blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  frontend_kernel<kAttrs><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      verts, norms, colors, poses, n_tris, n, f, rows, spans, total, sync);
  return cudaGetLastError();
}

template <int kAttrs>
void kernel_constants(int* out) {
  cudaFuncAttributes attr{};
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, frontend_kernel<kAttrs>);
  out[0] = kThreads;
  out[1] = err == cudaSuccess ? static_cast<int>(attr.sharedSizeBytes) : -1;
  out[2] = err == cudaSuccess ? attr.numRegs : -1;
  out[3] = err == cudaSuccess ? static_cast<int>(attr.localSizeBytes) : -1;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// verts, norms (n_tris, 3, 3) f32; colors (n_tris, 3, 3) f32 or null when
// n_attrs == 0; poses (n_views, 4, 3) f32 (R^T over the shift) or null for
// one unposed view; pm the 16 floats of the projection matrix (host
// memory). Writes rows (n_views * n_tris rounded up to whole blocks of
// kThreads, 16 + 3 * n_attrs; 16-byte aligned), spans (5, n_views *
// n_tris) and the int64 total; sync is two zeroed int64 words (the
// accumulator and the ticket) that the launch leaves zeroed, one pair a
// stream. Returns a cudaError_t code.
int frontend_launch(const float* verts, const float* norms,
                    const float* colors, const float* poses, int n_tris,
                    int n_views, const float* pm, int width, int height,
                    int tile_w, int tile_h, int n_attrs, int shade, float lx,
                    float ly, float lz, float* rows, int* spans,
                    long long* total, unsigned long long* sync, int device,
                    void* stream) {
  const long long n = static_cast<long long>(n_tris) * n_views;
  if (n_tris < 0 || n_views < 1 || (n_views > 1 && poses == nullptr)
      || !(n_attrs == 0 || n_attrs == 3 || n_attrs == 6)
      || (n > 0 && n_attrs > 0 && colors == nullptr) || (shade && n_attrs == 0)
      || width < 1 || height < 1 || tile_w < 1 || tile_h < 1
      || n > static_cast<long long>(kThreads) * 0x7fffffffLL
      || total == nullptr || sync == nullptr
      || (n > 0 && reinterpret_cast<uintptr_t>(rows) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  f.shade = shade;
  f.lx = lx;
  f.ly = ly;
  f.lz = lz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_attrs) {
    case 0:
      err = launch<0>(verts, norms, colors, poses, n_tris, n, f, rows, spans,
                      total, sync, s);
      break;
    case 3:
      err = launch<3>(verts, norms, colors, poses, n_tris, n, f, rows, spans,
                      total, sync, s);
      break;
    default:
      err = launch<6>(verts, norms, colors, poses, n_tris, n, f, rows, spans,
                      total, sync, s);
  }
  return static_cast<int>(err);
}

// The launch constants the wrapper's plan (ops/frontend.py::frontend_plan)
// mirrors, for one n_attrs: threads a block, the built kernel's static
// shared memory, registers a thread and local (spilled) bytes a thread
// (-1 where the runtime cannot say).
void frontend_constants(int n_attrs, int* out) {
  if (n_attrs == 0)
    kernel_constants<0>(out);
  else if (n_attrs == 3)
    kernel_constants<3>(out);
  else
    kernel_constants<6>(out);
}

}  // extern "C"
