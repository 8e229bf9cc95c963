// Group-interleaved lane-class placement of (triangle, tile) pairs (kernel B5).
//
// Replaces the TPU kernel cython3dmodelrenderer_tpu/ops/binsort_pallas.py
// (_make_group_kernel, launched by bin_sort_grouped). The TPU kernel walked
// the packed pairs (tri << 14) | tile in expansion order (triangle, then
// its tiles row-major) in ONE scalar loop, bumping a per-tile cursor in
// SMEM: pair i of tile t with rank r (the number of earlier pairs of t)
// goes to
//
//     pos = base[t] + (r % b) * group * sub + (r / b) * group,  b = blocks[t]
//
// and is stored only when pos < bound[t] and r < b * sub; only the first
// n_pairs = min(total, slot_cap) pairs of the expansion are walked.
//
// The rank is exactly what kernel B4 (csrc/radix_sort.cu binsort_launch,
// ops/binsort.py::bin_sort) computes, stably: its bins hold each tile's
// pairs in triangle order, so the pair at bin slot j of tile t has rank
// r = j - tile_starts[t]. The clamp drops the tail of the expansion, which
// is the tail of every bin it touches, so the surviving pairs keep their
// ranks. The wrapper (ops/binsort_grouped.py::bin_sort_grouped) runs B4,
// then three launches of this file around one B2 sort (csrc/radix_sort.cu
// sort_i32 of the 31-bit tile keys):
//
//  * group_keys_kernel: each tile's packed key (inv << 14) | tile, inv =
//    2^17 - 1 - min(ceil(count / sub), 2^17 - 1) (descending stripe demand,
//    ascending tile id), and order[] filled with n_tris;
//  * group_tables_kernel, ONE block (n_tiles < 2^14, a few thousand groups
//    at most): from the sorted keys stids and sstripes (padded with the
//    sentinel tile), the groups' chunk counts, their cumulative clamp to
//    slot_cap / 128 chunks (gchunks, gstarts, total_slots), n_active, each
//    tile's base / bound / blocks (entry n_tiles: 0, 0, 1), and the cut:
//    the triangle tc whose span holds expansion pair n_pairs (n_tris when
//    nothing is cut) and how many of its pairs survive;
//  * bin_place_kernel: one thread a binned pair. It finds its tile by a
//    binary search of tile_starts, takes its rank, keeps the pair iff
//    tri < tc, or tri == tc and its row-major index in tc's span is below
//    the surviving count, and stores order[pos] = tri under both guards.
//    No atomics and no cursor table: every position depends on the bins
//    alone, so every run places the same way.
//
// What bounds it on an H100: at most 2^17 slots, 2^14 tiles and B4's pairs,
// so the work is a few microseconds behind launch latency; the design is
// one C call a kernel and no host round trip beyond the wrapper's one read
// of the pair total, which B4 sizes its work from. The tables kernel's scans
// run contiguous runs a thread (one block-wide scan each), the placement's
// search 14 dependent loads of an L2-resident table.
//
// Preconditions (the wrapper checks them): spans inside the ntx-wide grid of
// n_tiles < 2^14 tiles, sum cx*cy == total, n_tris < 2^17, slot_cap a
// multiple of 128 below 2^17, group * sub == 128.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileBits = 14;
constexpr int kTileMask = (1 << kTileBits) - 1;
constexpr int kMaxStripes = (1 << 17) - 1;           // the key's inv field
constexpr int kChunk = 128;                          // slots a chunk
constexpr long long kMaxTotalChunks = (1 << 24) - 1; // total_slots saturation
constexpr int kFillThreads = 256;
constexpr int kTableThreads = 1024;
constexpr int kTableWarps = kTableThreads / kWarp;
constexpr int kPlaceThreads = 256;

// Exclusive sum of one value a thread over the table block; `total`
// receives the block's sum. Ends synced.
__device__ long long block_exclusive_sum(long long v, long long* part,
                                         long long* total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  long long inc = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == kWarp - 1) part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const long long p = lane < kTableWarps ? part[lane] : 0;
    long long q = p;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, q, o);
      if (lane >= o) q += y;
    }
    if (lane < kTableWarps) part[lane] = q - p;
    if (lane == kWarp - 1) *total = q;
  }
  __syncthreads();
  const long long out = part[warp] + inc - v;
  __syncthreads();
  return out;
}

// keys[t] for t < n_tiles; order[i] = fill for i < slot_cap.
__global__ void __launch_bounds__(kFillThreads)
group_keys_kernel(const int* __restrict__ counts, int n_tiles, int sub,
                  int* __restrict__ keys, int* __restrict__ order,
                  int slot_cap, int fill) {
  const int n = max(n_tiles, slot_cap);
  for (int i = blockIdx.x * kFillThreads + threadIdx.x; i < n;
       i += gridDim.x * kFillThreads) {
    if (i < n_tiles) {
      const long long stripes = (static_cast<long long>(counts[i]) + sub - 1) / sub;
      const int inv = kMaxStripes - static_cast<int>(
          stripes < kMaxStripes ? stripes : kMaxStripes);
      keys[i] = (inv << kTileBits) | i;
    }
    if (i < slot_cap) order[i] = fill;
  }
}

// One block. `cut` receives {tc, surviving pairs of tc}.
__global__ void __launch_bounds__(kTableThreads)
group_tables_kernel(const int* __restrict__ skey, const int* __restrict__ counts,
                    int n_tiles, int group, int sub, int allowed, int n_pairs,
                    int total, const int* __restrict__ cx,
                    const int* __restrict__ cy, int n_tris,
                    int* __restrict__ stids, int* __restrict__ sstripes,
                    int* __restrict__ gchunks, int* gstarts,
                    int* __restrict__ total_slots, int* __restrict__ n_active,
                    int* __restrict__ base, int* __restrict__ bound,
                    int* __restrict__ blocks, int* __restrict__ cut) {
  __shared__ long long part[kWarp];
  __shared__ long long s_total;
  const int tid = threadIdx.x;
  const int n_groups = (n_tiles + group - 1) / group;
  const int n_sorted = n_groups * group;

  // stids / sstripes (sentinel-padded) and the active-tile count
  long long active = 0;
  for (int k = tid; k < n_sorted; k += kTableThreads) {
    if (k < n_tiles) {
      const int key = skey[k];
      stids[k] = key & kTileMask;
      sstripes[k] = kMaxStripes - (key >> kTileBits);
      active += counts[k] > 0;
    } else {
      stids[k] = n_tiles;
      sstripes[k] = 0;
    }
  }
  block_exclusive_sum(active, part, &s_total);
  if (tid == 0) *n_active = static_cast<int>(s_total);

  // the groups' chunk demand (each group's first tile holds its most
  // stripes, and lies below n_tiles), scanned and clamped; thread t owns a
  // contiguous run of groups
  const int per = (n_groups + kTableThreads - 1) / kTableThreads;
  const int g0 = min(tid * per, n_groups), g1 = min(g0 + per, n_groups);
  long long run = 0;
  for (int g = g0; g < g1; ++g) run += kMaxStripes - (skey[g * group] >> kTileBits);
  long long csum = block_exclusive_sum(run, part, &s_total);
  for (int g = g0; g < g1; ++g) {
    const long long prev = csum;
    csum += kMaxStripes - (skey[g * group] >> kTileBits);
    const long long start_c = prev < allowed ? prev : allowed;
    const long long cum_c = csum < allowed ? csum : allowed;
    gchunks[g] = static_cast<int>(cum_c - start_c);
    gstarts[g] = static_cast<int>(kChunk * start_c);
  }
  if (tid == 0) {
    const long long all = s_total;
    gstarts[n_groups] = static_cast<int>(kChunk * (all < allowed ? all : allowed));
    *total_slots = static_cast<int>(
        kChunk * (all < kMaxTotalChunks ? all : kMaxTotalChunks));
    base[n_tiles] = 0;
    bound[n_tiles] = 0;
    blocks[n_tiles] = 1;
  }
  __syncthreads();                       // gstarts visible to the block

  for (int k = tid; k < n_tiles; k += kTableThreads) {
    const int tile = skey[k] & kTileMask;
    const int g = k / group;
    const int gs = gstarts[g], ge = gstarts[g + 1];
    base[tile] = gs + k % group;
    bound[tile] = ge;
    blocks[tile] = max((ge - gs) / (group * sub), 1);
  }

  // the cut: the first triangle whose inclusive pair prefix passes n_pairs
  if (n_pairs >= total) {
    if (tid == 0) {
      cut[0] = n_tris;
      cut[1] = 0;
    }
    return;
  }
  const int tper = (n_tris + kTableThreads - 1) / kTableThreads;
  const int t0 = min(tid * tper, n_tris), t1 = min(t0 + tper, n_tris);
  long long pairs = 0;
  for (int t = t0; t < t1; ++t) pairs += static_cast<long long>(cx[t]) * cy[t];
  long long prefix = block_exclusive_sum(pairs, part, &s_total);
  if (prefix > n_pairs || prefix + pairs <= n_pairs) return;
  for (int t = t0; t < t1; ++t) {
    const long long pc = static_cast<long long>(cx[t]) * cy[t];
    if (prefix + pc > n_pairs) {         // exactly one thread, one triangle
      cut[0] = t;
      cut[1] = static_cast<int>(n_pairs - prefix);
      return;
    }
    prefix += pc;
  }
}

// One thread a binned pair j < total.
__global__ void __launch_bounds__(kPlaceThreads)
bin_place_kernel(const int* __restrict__ pair_tri,
                 const int* __restrict__ starts, int total, int n_tiles,
                 int ntx, const int* __restrict__ tx0,
                 const int* __restrict__ ty0, const int* __restrict__ cx,
                 const int* __restrict__ cut, const int* __restrict__ base,
                 const int* __restrict__ bound,
                 const int* __restrict__ blocks, int group, int sub,
                 int slot_cap, int* __restrict__ order) {
  const int j = blockIdx.x * kPlaceThreads + threadIdx.x;
  if (j >= total) return;
  int lo = 0, hi = n_tiles;              // the last tile whose bin starts <= j
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(starts + mid) <= j) lo = mid; else hi = mid;
  }
  const int t = lo;
  const int r = j - starts[t];
  const int tri = pair_tri[j];
  const int tc = cut[0];
  if (tri > tc) return;
  if (tri == tc) {                       // row-major index in tc's span
    const int idx = (t / ntx - ty0[tri]) * cx[tri] + (t % ntx - tx0[tri]);
    if (idx >= cut[1]) return;
  }
  const int b = blocks[t];
  const int pos = base[t] + (r % b) * (group * sub) + (r / b) * group;
  if (pos >= 0 && pos < bound[t] && pos < slot_cap && r < b * sub)
    order[pos] = tri;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// keys (n_tiles int32) from B4's tile counts; order (slot_cap int32)
// filled with `fill`. Returns a cudaError_t code.
int group_keys_launch(const int* counts, int n_tiles, int sub, int* keys,
                      int* order, int slot_cap, int fill, int device,
                      void* stream) {
  if (n_tiles < 1 || n_tiles > kTileMask || sub < 1 || slot_cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = n_tiles > slot_cap ? n_tiles : slot_cap;
  group_keys_kernel<<<(n + kFillThreads - 1) / kFillThreads, kFillThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      counts, n_tiles, sub, keys, order, slot_cap, fill);
  return static_cast<int>(cudaGetLastError());
}

// The tables from the sorted keys skey (n_tiles) and B4's counts:
// stids/sstripes (n_sorted), gchunks (n_groups), gstarts (n_groups + 1),
// total_slots and n_active (1 each), base/bound/blocks (n_tiles + 1), cut
// (2). n_pairs = min(total, slot_cap); cx/cy the spans (read only when
// n_pairs < total). Returns a cudaError_t code.
int group_tables_launch(const int* skey, const int* counts, int n_tiles,
                        int group, int sub, int slot_cap, int n_pairs,
                        int total, const int* cx, const int* cy, int n_tris,
                        int* stids, int* sstripes, int* gchunks, int* gstarts,
                        int* total_slots, int* n_active, int* base, int* bound,
                        int* blocks, int* cut, int device, void* stream) {
  if (n_tiles < 1 || n_tiles > kTileMask || group < 1 || sub < 1
      || group * sub != kChunk || slot_cap < 0 || slot_cap % kChunk
      || n_pairs < 0 || n_pairs > total || n_tris < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_tables_kernel<<<1, kTableThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      skey, counts, n_tiles, group, sub, slot_cap / kChunk, n_pairs, total, cx,
      cy, n_tris, stids, sstripes, gchunks, gstarts, total_slots, n_active,
      base, bound, blocks, cut);
  return static_cast<int>(cudaGetLastError());
}

// order[pos] = tri for each of B4's binned pairs (pair_tri, tile_starts;
// total of them) that survives the cut and both guards. Returns a
// cudaError_t code.
int bin_place_launch(const int* pair_tri, const int* starts, int total,
                     int n_tiles, int ntx, const int* tx0, const int* ty0,
                     const int* cx, const int* cut, const int* base,
                     const int* bound, const int* blocks, int group, int sub,
                     int slot_cap, int* order, int device, void* stream) {
  if (total < 1 || n_tiles < 1 || n_tiles > kTileMask || ntx < 1 || group < 1
      || sub < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_place_kernel<<<(total + kPlaceThreads - 1) / kPlaceThreads,
                     kPlaceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pair_tri, starts, total, n_tiles, ntx, tx0, ty0, cx, cut, base, bound,
      blocks, group, sub, slot_cap, order);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
