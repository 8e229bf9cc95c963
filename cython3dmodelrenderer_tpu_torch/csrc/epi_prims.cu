// Per-replica cost of the raster epilogue's primitives (kernel P1).
//
// Replaces the TPU kernel tools/probes/epi_prims.py (make_kernel, launched
// by prim_ms.run; primitives _prim_body). For a (16, 32, 128) f32 tile x
// and one of 15 primitives, the output is the f32 scalar
//
//     acc = 0;  for rep < reps:  acc += prim(x + rep * 1e-30)
//
// summed in rep order, where prim computes a whole tensor (a lane min, a
// roll, a segmented sum, an epilogue) and returns one element of it or its
// sum (see probes/epi_prims.py for each primitive's plain statement). The
// scratch tensors are attr = x and, for the group primitives (epi_cur8,
// epi_rr_group), attr6[c] = x + c.
//
// Where the TPU design does not carry over, and what this one does:
//
//  * Memory. The TPU kept the 256 KB tile and the 1.5 MB attr6 in VMEM.
//    A block has at most 227 KB of shared memory, so the work is split by
//    TH row: block h holds row h of x, attr (16 KB each) and attr6 (96 KB)
//    in dynamic shared memory (opted in above 48 KB; the segmented-sum
//    primitives hold the 64 KB segment matrix and a 16 KB staging row
//    instead of attr6). A launch that asks for more than the card allows
//    is refused by cudaFuncSetAttribute, and the launcher returns that
//    error.
//  * Layout. Every primitive works along the 128-lane axis of one (h, w)
//    row, so warp w of block h owns row (h, w) and lane l holds the four
//    consecutive lanes k = 4l..4l+3. A 128-lane min or sum is a local
//    step and a 5-step shuffle tree; a 16-lane segment is 4 threads, so
//    segmented ops are 2 shuffle steps; a circular roll by s is one
//    __shfl_sync per register (from lane l - s/4 or l - s/4 - 1). The
//    16-lane slice primitives (slicered, epi_slice) run on the quad that
//    holds lanes 48..63; the other lanes compute alongside at no saving.
//  * Replicas run IN SEQUENCE inside each block, as the TPU ran them on
//    one core: the 16 blocks (one per TH row, 1024 threads each) walk all
//    reps, so the slope over reps measures the LATENCY of one replica of
//    one row on one SM (16 SMs busy in parallel), not the card's
//    throughput.
//  * The combine is deterministic: warp w writes its (h, w) partial of
//    rep r to partials[r][h][w]; combine_kernel sums each rep's 512
//    partials in (h, w) order, then the reps in order. For the
//    primitives whose scalar is one element (reduce, wherered, extract,
//    roll, stack6red, segsum, segsum6) only row (0, 0) contributes and
//    the others write 0, so the scalar is that element exactly.
//  * Keeping the work. nvcc removes work whose result is unused, and those
//    element primitives use one element of their tensor. Every element of
//    their tensor goes through keep(), an empty asm volatile with the value
//    as input, so it must be computed in every replica. The summed
//    primitives feed every element into the scalar. Where the TPU stacked
//    six identical channels (segsum6, stack6red, epi_cur, epi_bfly_stripe),
//    each channel's input passes through opaque() (an empty asm volatile
//    that the compiler must treat as a new value) so the six channels are
//    six computations, not one.
//  * segsum and segsum6 (a HIGHEST-precision MXU product on the TPU) are
//    the kernel's own f32 loop over k = 0..127 in order, __fmul_rn then
//    __fadd_rn: full f32, no TF32, no tensor cores.
//
// Float contract: explicit __fadd_rn/__fmul_rn, -fmad=false. Each
// primitive's elements equal the plain PyTorch version's bit for bit
// (mins, maxes, selects and rolls are exact; segsum's loop is the plain
// version's order); only the sums over many elements (the epi_* sums,
// slicered, epi_bfly_once) are taken in another order than torch's.
//
// What bounds it on an H100: per replica, tens of instructions per element
// (epi_cur6: ~27 per element, 65,536 elements) against no device memory
// (the tile is read once), so the bound is operations; in sequence on 16
// SMs, dependent shuffle trees make each replica latency bound, which is
// what the probe measures.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTH = 16;
constexpr int kTW = 32;
constexpr int kK = 128;
constexpr int kRow = kTW * kK;            // floats in one TH row
constexpr int kThreads = kTW * 32;        // one warp per (h, w) row
constexpr int kCombineThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum Prim {
  kReduce, kWhereRed, kExtract, kRoll, kSegSum, kSegSum6, kStack6Red,
  kEpiCur, kEpiBflyOnce, kEpiBflyStripe, kSliceRed, kEpiSlice, kEpiCur6,
  kEpiCur8, kEpiRrGroup, kNumPrims
};

__host__ __device__ constexpr bool is_group(int p) {
  return p == kEpiCur8 || p == kEpiRrGroup;
}
__host__ __device__ constexpr bool is_segsum(int p) {
  return p == kSegSum || p == kSegSum6;
}

// Dynamic shared memory a primitive's block needs, in bytes.
int smem_need(int p) {
  int floats = 2 * kRow;                                   // x, attr
  if (is_group(p)) floats += 6 * kRow;                     // attr6
  if (is_segsum(p)) floats += kK * kK + kRow;              // smat, stage
  return floats * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void keep(float v) { asm volatile("" ::"f"(v)); }

__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// min / max over the 4 lanes of a quad (one 16-lane segment)
__device__ __forceinline__ float quad_min(float v) {
  v = fminf(v, __shfl_xor_sync(kFull, v, 1));
  return fminf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

// sum over the warp, valid in lane 0 (a fixed tree: deterministic)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float min4(const float (&v)[4]) {
  return fminf(fminf(v[0], v[1]), fminf(v[2], v[3]));
}

__device__ __forceinline__ float sum4(const float (&v)[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]), v[3]);
}

// Circular roll of a 128-lane row by SH: out lane k = v lane (k - SH) mod
// 128, as jnp.roll / pltpu.roll. Lane k = 4 * lane + i.
template <int SH>
__device__ __forceinline__ void roll(const float (&v)[4], float (&out)[4],
                                     int lane) {
  constexpr int s = ((SH % kK) + kK) % kK;
  constexpr int q = s / 4;
  constexpr int r = s % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int src = i >= r ? i - r : i - r + 4;
    const int from = (i >= r ? lane - q : lane - q - 1) & 31;
    out[i] = __shfl_sync(kFull, v[src], from);
  }
}

struct Row {
  float x[4];            // x + rep * 1e-30 at lanes 4l..4l+3
  float attr[4];         // attr at the same lanes
  float x000;            // (x + rep * 1e-30)[0, 0, 0]
  const float* s_attr;   // attr row (kTW, kK) in shared memory
  const float* s_attr6;  // attr6 rows (6, kTW, kK), group primitives
  const float* s_smat;   // (kK, kK), segsum primitives
  float* s_stage;        // this warp's 128 floats, segsum primitives
  int w, lane;
};

__device__ __forceinline__ float lanef(const Row& r, int i) {
  return static_cast<float>(4 * r.lane + i);
}

// Running sum of an epilogue block [av0, av1, av2, zt_out, av3, av4, av5, 0]
// in that order, fed av_c for c = 0..5 (the trailing + 0 is the caller's).
__device__ __forceinline__ float plane_sum(float t, int c, float av,
                                           float zt_out) {
  t = c == 0 ? av : __fadd_rn(t, av);
  return c == 2 ? __fadd_rn(t, zt_out) : t;
}

// The production per-stripe epilogue for segment `s` with attribute
// channels a(c, i) (epi_cur, epi_cur6, epi_cur8's stripes): the sum of
// [av0, av1, av2, zt_out, av3, av4, av5, 0], valid in every lane.
template <typename Attr>
__device__ __forceinline__ float stripe(const Row& r, int s, Attr a) {
  const bool inseg = r.lane / 4 == s;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = inseg ? r.x[i] : INFINITY;
  const float zt = warp_min(min4(v));
  const bool has = !isinf(zt);
  const float zt_out = has ? zt : 0.0f;
  bool cand[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cand[i] = inseg && r.x[i] == zt;
    v[i] = cand[i] ? lanef(r, i) : INFINITY;
  }
  const float lmin = warp_min(min4(v));
  bool win[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) win[i] = cand[i] && lanef(r, i) == lmin;
  float t = 0.0f;
  for (int c = 0; c < 6; ++c) {
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) m = fmaxf(m, win[i] ? a(c, i) : -INFINITY);
    m = warp_max(m);          // every lane shuffles, then selects
    t = plane_sum(t, c, has ? m : 0.0f, zt_out);
  }
  return __fadd_rn(t, 0.0f);
}

// Segmented min within 16-lane segments by masked roll-doubling in both
// directions (epi_bfly_once's segmin).
template <int SH>
__device__ __forceinline__ void segmin_round(float (&v)[4], int lane) {
  float f[4], b[4];
  roll<SH>(v, f, lane);          // lane k <- k - SH
  roll<kK - SH>(v, b, lane);     // lane k <- k + SH
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lmod = (4 * lane + i) % 16;
    v[i] = fminf(v[i], lmod >= SH ? f[i] : INFINITY);
    v[i] = fminf(v[i], lmod < 16 - SH ? b[i] : INFINITY);
  }
}

__device__ __forceinline__ void segmin(float (&v)[4], int lane) {
  segmin_round<1>(v, lane);
  segmin_round<2>(v, lane);
  segmin_round<4>(v, lane);
  segmin_round<8>(v, lane);
}

// Unmasked circular roll-doubling by 8, 16, 32, 64: every lane gets the
// min (or sum) of its lane class k % 8 (epi_rr_group's segred).
template <int SH, bool kAdd>
__device__ __forceinline__ void segred_round(float (&v)[4], int lane) {
  float t[4];
  roll<SH>(v, t, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = kAdd ? __fadd_rn(v[i], t[i]) : fminf(v[i], t[i]);
}

template <bool kAdd>
__device__ __forceinline__ void segred(float (&v)[4], int lane) {
  segred_round<8, kAdd>(v, lane);
  segred_round<16, kAdd>(v, lane);
  segred_round<32, kAdd>(v, lane);
  segred_round<64, kAdd>(v, lane);
}

// y = row @ smat for this (h, w) row, one k at a time in order; lane l
// computes y[4l..4l+3]. Reads the row from the warp's staging area.
__device__ __forceinline__ void segsum_row(const Row& r, float (&y)[4],
                                           bool fresh) {
  y[0] = y[1] = y[2] = y[3] = 0.0f;
  const float4* sm = reinterpret_cast<const float4*>(r.s_smat);
#pragma unroll 8
  for (int k = 0; k < kK; ++k) {
    const float xk = fresh ? opaque(r.s_stage[k]) : r.s_stage[k];
    const float4 m = sm[k * (kK / 4) + r.lane];
    y[0] = __fadd_rn(y[0], __fmul_rn(xk, m.x));
    y[1] = __fadd_rn(y[1], __fmul_rn(xk, m.y));
    y[2] = __fadd_rn(y[2], __fmul_rn(xk, m.z));
    y[3] = __fadd_rn(y[3], __fmul_rn(xk, m.w));
  }
}

// One replica of primitive P on row (h, w): this warp's share of the
// scalar, valid in lane 0. `origin` is true for row (0, 0), the row whose
// element the element primitives return.
template <int P>
__device__ float prim(const Row& r, bool origin) {
  const int lane = r.lane;
  const bool seg3 = lane / 4 == 3;
  if constexpr (P == kReduce) {
    const float m = warp_min(min4(r.x));
    keep(m);
    return origin ? m : 0.0f;
  }
  if constexpr (P == kWhereRed) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = seg3 ? r.x[i] : INFINITY;
    const float m = warp_min(min4(v));
    keep(m);
    return origin ? m : 0.0f;
  }
  if constexpr (P == kExtract) {
    const float e = __shfl_sync(kFull, r.x[0], 12);      // lane 48
    keep(e);
    return origin ? e : 0.0f;
  }
  if constexpr (P == kRoll) {
    float o[4];
    roll<16>(r.x, o, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) keep(o[i]);
    return origin ? o[0] : 0.0f;
  }
  if constexpr (P == kSegSum || P == kSegSum6) {
    reinterpret_cast<float4*>(r.s_stage)[lane] =
        make_float4(r.x[0], r.x[1], r.x[2], r.x[3]);
    __syncwarp();
    float y[4];
    float first = 0.0f;
    constexpr int kCopies = P == kSegSum6 ? 6 : 1;
    for (int c = 0; c < kCopies; ++c) {
      segsum_row(r, y, kCopies > 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) keep(y[i]);
      if (c == 0) first = y[0];
    }
    __syncwarp();                 // the stage is rewritten next replica
    return origin ? first : 0.0f;
  }
  if constexpr (P == kStack6Red) {
    float first = 0.0f;
    for (int c = 0; c < 6; ++c) {
      const float x0 = opaque(r.x000);
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m = fmaxf(m, seg3 ? __fadd_rn(r.attr[i], x0) : -INFINITY);
      m = warp_max(m);
      keep(m);
      if (c == 0) first = m;
    }
    return origin ? first : 0.0f;
  }
  if constexpr (P == kEpiCur) {
    return stripe(r, 3, [&](int, int i) {
      return __fadd_rn(r.attr[i], opaque(r.x000));
    });
  }
  if constexpr (P == kEpiCur6) {
    return stripe(r, 3, [&](int c, int i) {
      return __fadd_rn(r.attr[i], static_cast<float>(c));
    });
  }
  if constexpr (P == kEpiCur8) {
    float total = 0.0f;
    for (int s = 0; s < 8; ++s) {
      const float t = stripe(r, s, [&](int c, int i) {
        return __fadd_rn(r.s_attr6[c * kRow + r.w * kK + 4 * lane + i], r.x000);
      });
      total = __fadd_rn(total, t);
    }
    return total;
  }
  if constexpr (P == kEpiBflyOnce) {
    float ztb[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ztb[i] = r.x[i];
    segmin(ztb, lane);
    bool cand[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cand[i] = r.x[i] == ztb[i];
      l[i] = cand[i] ? lanef(r, i) : INFINITY;
    }
    segmin(l, lane);
    float s1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s1[i] = cand[i] && lanef(r, i) == l[i] ? r.x[i] : 0.0f;
    return __fadd_rn(warp_sum(sum4(s1)), warp_sum(sum4(ztb)));
  }
  if constexpr (P == kEpiBflyStripe) {
    bool win[4];
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      win[i] = r.x[i] > 0.5f;               // the stand-in mask
      v[i] = seg3 ? r.x[i] : INFINITY;
    }
    const float zt = warp_min(min4(v));
    const bool has = !isinf(zt);
    const float zt_out = has ? zt : 0.0f;
    float t = 0.0f;
    for (int c = 0; c < 6; ++c) {
      const float x0 = opaque(r.x000);
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m = fmaxf(m, win[i] && seg3 ? __fadd_rn(r.attr[i], x0) : -INFINITY);
      m = warp_max(m);          // every lane shuffles, then selects
      t = plane_sum(t, c, has ? m : 0.0f, zt_out);
    }
    return __fadd_rn(t, 0.0f);
  }
  if constexpr (P == kSliceRed) {
    const float m = quad_min(min4(r.x));
    return __shfl_sync(kFull, m, 12);        // the quad of lanes 48..63
  }
  if constexpr (P == kEpiSlice) {
    // every quad runs the slice epilogue on its own lanes; quad 3's
    // (lanes 48..63) is the one returned
    const int j = lane & 3;
    const float zt = quad_min(min4(r.x));
    const bool has = !isinf(zt);
    const float zt_out = has ? zt : 0.0f;
    bool cand[4];
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cand[i] = r.x[i] == zt;
      v[i] = cand[i] ? lanef(r, i) : INFINITY;
    }
    const float lmin = quad_min(min4(v));
    float t = 0.0f;
    for (int c = 0; c < 6; ++c) {
      const float* a = r.s_attr + r.w * kK + ((3 + c) % 8) * 16 + 4 * j;
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool win = cand[i] && lanef(r, i) == lmin;
        m = fmaxf(m, win ? __fadd_rn(a[i], r.x[i]) : -INFINITY);
      }
      m = quad_max(m);          // every lane shuffles, then selects
      t = plane_sum(t, c, has ? m : 0.0f, zt_out);
    }
    return __shfl_sync(kFull, __fadd_rn(t, 0.0f), 12);
  }
  if constexpr (P == kEpiRrGroup) {
    float ztb[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ztb[i] = r.x[i];
    segred<false>(ztb, lane);
    bool win[4], has[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool cand = r.x[i] == ztb[i];
      l[i] = cand ? lanef(r, i) : INFINITY;
      has[i] = !isinf(ztb[i]);
    }
    segred<false>(l, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      win[i] = r.x[i] == ztb[i] && lanef(r, i) == l[i];
    // lane class pcls = k / 8 = lane / 2; plane order [p0, p1, p2, zt_out,
    // p3, p4, p5, 0]; lanes 64..127 (pcls >= 8) stay 0
    const int pcls = lane / 2;
    float gout[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) gout[i] = pcls == 3 && has[i] ? ztb[i] : 0.0f;
    for (int c = 0; c < 6; ++c) {
      float aw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a6 = __fadd_rn(
            r.s_attr6[c * kRow + r.w * kK + 4 * lane + i], r.x000);
        aw[i] = win[i] ? a6 : 0.0f;
      }
      segred<true>(aw, lane);
      const int p = c < 3 ? c : c + 1;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (pcls == p) gout[i] = has[i] ? aw[i] : 0.0f;
    }
    return warp_sum(sum4(gout));
  }
  return 0.0f;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
epi_kernel(const float* __restrict__ x, const float* __restrict__ smat,
           int reps, float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_x = smem;
  float* s_attr = s_x + kRow;
  float* s_extra = s_attr + kRow;          // attr6, or smat then the stage
  const int h = blockIdx.x;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int at = w * kK + 4 * lane;

  const float4 xin =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(h) * kRow)[at / 4];
  reinterpret_cast<float4*>(s_x)[at / 4] = xin;
  reinterpret_cast<float4*>(s_attr)[at / 4] = xin;
  if (is_group(P)) {
    for (int c = 0; c < 6; ++c) {
      const float fc = static_cast<float>(c);
      reinterpret_cast<float4*>(s_extra + c * kRow)[at / 4] =
          make_float4(__fadd_rn(xin.x, fc), __fadd_rn(xin.y, fc),
                      __fadd_rn(xin.z, fc), __fadd_rn(xin.w, fc));
    }
  }
  if (is_segsum(P)) {
    for (int e = threadIdx.x; e < kK * kK / 4; e += kThreads)
      reinterpret_cast<float4*>(s_extra)[e] =
          reinterpret_cast<const float4*>(smat)[e];
  }
  const float x000_in = x[0];
  __syncthreads();

  Row r;
  r.s_attr = s_attr;
  r.s_attr6 = s_extra;
  r.s_smat = s_extra;
  r.s_stage = s_extra + kK * kK + w * kK;
  r.w = w;
  r.lane = lane;
  const bool origin = h == 0 && w == 0;
  for (int rep = 0; rep < reps; ++rep) {
    const float pert = __fmul_rn(static_cast<float>(rep), 1e-30f);
    const float4 xv = reinterpret_cast<const float4*>(s_x)[at / 4];
    const float4 av = reinterpret_cast<const float4*>(s_attr)[at / 4];
    r.x[0] = __fadd_rn(xv.x, pert);
    r.x[1] = __fadd_rn(xv.y, pert);
    r.x[2] = __fadd_rn(xv.z, pert);
    r.x[3] = __fadd_rn(xv.w, pert);
    r.attr[0] = av.x;
    r.attr[1] = av.y;
    r.attr[2] = av.z;
    r.attr[3] = av.w;
    r.x000 = __fadd_rn(x000_in, pert);
    const float part = prim<P>(r, origin);
    if (lane == 0)
      partials[(static_cast<size_t>(rep) * kTH + h) * kTW + w] = part;
  }
}

// out[0] = sum over reps, in order, of each rep's partials summed in
// (h, w) order.
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ partials, int reps,
               float* __restrict__ out) {
  __shared__ float s_v[kCombineThreads];
  float acc = 0.0f;
  for (int base = 0; base < reps; base += kCombineThreads) {
    const int rep = base + threadIdx.x;
    if (rep < reps) {
      const float* p = partials + static_cast<size_t>(rep) * kTH * kTW;
      float v = 0.0f;
      for (int h = 0; h < kTH; ++h) {
        float row = p[h * kTW];
        for (int w = 1; w < kTW; ++w) row = __fadd_rn(row, p[h * kTW + w]);
        v = h == 0 ? row : __fadd_rn(v, row);
      }
      s_v[threadIdx.x] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int n = min(kCombineThreads, reps - base);
      for (int t = 0; t < n; ++t) acc = __fadd_rn(acc, s_v[t]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = acc;
}

template <int P>
cudaError_t launch(const float* x, const float* smat, int reps,
                   float* partials, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      epi_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  epi_kernel<P><<<kTH, kThreads, smem_bytes, stream>>>(x, smat, reps,
                                                       partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory primitive `prim` needs, in bytes (-1: no such).
int epi_prims_smem_bytes(int prim) {
  return prim >= 0 && prim < kNumPrims ? smem_need(prim) : -1;
}

// Primitive `prim` (the order of probes/epi_prims.py ALL_PRIMS) over
// `reps` replicas on `stream`: x (16, 32, 128) f32, smat (128, 128) f32,
// partials (max(reps, 1), 16, 32) f32 scratch, out (1,) f32. smem_bytes
// is the dynamic shared memory to ask for (at least the primitive's
// need). Returns a cudaError_t code (0 = both kernels launched).
int epi_prims_launch(int prim, const float* x, const float* smat, int reps,
                     float* partials, float* out, int smem_bytes, int device,
                     void* stream) {
  if (prim < 0 || prim >= kNumPrims || reps < 0 || smem_bytes < smem_need(prim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prim) {
#define CASE(P) \
    case P: err = launch<P>(x, smat, reps, partials, smem_bytes, s); break;
    CASE(kReduce) CASE(kWhereRed) CASE(kExtract) CASE(kRoll) CASE(kSegSum)
    CASE(kSegSum6) CASE(kStack6Red) CASE(kEpiCur) CASE(kEpiBflyOnce)
    CASE(kEpiBflyStripe) CASE(kSliceRed) CASE(kEpiSlice) CASE(kEpiCur6)
    CASE(kEpiCur8) CASE(kEpiRrGroup)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<<<1, kCombineThreads, 0, s>>>(partials, reps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
