// Stable LSD radix sort of non-negative int32 keys, with an optional int32
// value that moves with its key: the core of kernels B2 (ops/sort.py::
// sort_i32) and B4 (ops/binsort.py::bin_sort).
//
// Replaces two TPU kernels:
//  * cython3dmodelrenderer_tpu/ops/sort_pallas.py::_make_kernel (B2), a
//    bitonic network over one VMEM-resident (n/128, 128) block, launched by
//    bitonic_sort_i32; a sort without scatter had to be a network there;
//  * cython3dmodelrenderer_tpu/ops/binsort_pallas.py::_make_kernel (B4),
//    one scalar loop over the triangles in order bumping a per-tile cursor
//    in SMEM for each (triangle, tile) pair, launched by bin_sort.
// Both compute a stable sort of non-negative integer keys whose width the
// caller knows: B2 the packed pair keys (tile << tri_bits) | tri, at most 31
// bits; B4 the pairs' tile ids, ceil(log2 n_tiles) bits, carrying the
// triangle ids as values.
//
// Passes: ceil(bits / 8) digits of 8 bits (256 bins), lowest first. Each
// pass is a stable counting sort on its digit, so the whole is stable and
// equals torch.sort (stable) bit for bit. Keys must lie in [0, 2^bits).
//
// Ranking, on both paths: a warp takes a contiguous run of the keys, 32 at
// a time in order; nine ballots group the lanes that hold the same digit
// (match_digit); a lane's rank is its warp's running count of that digit
// plus the number of lower lanes in its group, and the group's lowest lane
// advances the count. One exclusive scan of the (digit, warp) counts, digit-major,
// gives every warp its first slot per digit. No atomic decides a position,
// so every run gives the same order (csrc/binsort_grouped.cu ranks so too).
//
//  * n <= 131,072 (kOneLaunchMaxKeys), sort_coop_kernel: ONE cooperative
//    launch of ceil(n / 2,048) CTAs, one 2,048-key tile each, that walks
//    every pass: rank the tile in shared memory, store its 256 digit
//    counts, grid barrier, add the earlier tiles' counts and every tile's
//    digit totals, scatter, grid barrier. The keys stay in L2 between
//    passes (17,473 keys are 70 KB). No scratch needs clearing, so the
//    call is one launch. This covers the sort route's whole budget (fewer
//    than 2^17 pairs): 9 CTAs at sphere16k@1024^2. One 1,024-thread CTA
//    holding every key in shared memory is bound by its one SM's issue
//    rate: on an H100 it sorted 17,473 keys slower than torch.sort.
//  * Larger n, onesweep: upsweep_kernel reads the keys once and builds every
//    pass's digit histogram (per-CTA shared histograms added into global
//    memory with atomics: a sum of counts does not depend on the order of
//    the additions). B4's expand_kernel builds them while it writes the
//    pairs, so B4 has no upsweep. Then one scatter_kernel launch a pass:
//    each CTA takes a tile of 2,048 keys by an atomic ticket (not by
//    blockIdx, so every tile it waits on belongs to a CTA that is already
//    running), ranks it in shared memory as above, publishes its per-digit
//    counts in look-back words (flag in bits 31..30, count in 29..0), adds
//    the earlier tiles' words until it meets an inclusive prefix (decoupled
//    look-back), publishes its own inclusive prefix and scatters. Each CTA
//    scans the 256 global digit counts itself: no scan kernel. The
//    launchers clear histograms, tickets and look-back words with one
//    cudaMemsetAsync on the caller's stream before every call.
//
// B4 (binsort_launch): memset, expand_kernel (the spans' (tile, tri) pairs
// in triangle order, each triangle's tiles row-major, at offsets from a
// decoupled look-back scan of cx*cy; tile_counts by warp-aggregated global
// atomics; the digit histograms), the sort of the tile ids carrying the
// triangle ids, and scan_kernel (tile_starts, the exclusive scan of the
// counts, chained by look-back too): 3 + passes launches, or 4 on the
// one-launch path.
//
// B4 takes its pair total from the card: the front end's int64 total and a
// host capacity. Buffers, the memset, the route and every grid follow the
// capacity; the kernels read the total (live_keys) and bound their work by
// it: a one-launch CTA past it ranks an empty tile, a onesweep CTA past it
// returns. The sort is stable, so either route gives a total within the
// capacity the bins of an exactly sized call, bit for bit. A total past the
// capacity (an overflow) bins nothing: the bins come out empty, nothing is
// written past the capacity, and the caller, which reads the total after
// the frame, runs it again at a capacity that holds it.
//
// What bounds it on an H100: bytes — each pass reads and writes every key,
// 8 B a key without values, 16 B with (B4's expansion adds 8 B a pair
// written and the spans read once) — and, at the frame's sizes, launch
// latency: 17,473 keys are 140 KB a pass, tens of nanoseconds of HBM time
// against microseconds a launch. So the frame's sort is one launch whose
// passes meet at grid barriers, and the large path reads the keys once
// for all histograms and once a pass, writes them once a pass, with no
// padding, no cursor table and no separate scan kernels.
//
// Guards: a position outside [0, n) is never written (keys past 2^bits or
// spans whose pairs do not add up to `total` give a wrong order, not a
// stray store); n < 2^30 (the look-back word's count).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;              // 256 bins a pass
constexpr int kMaxPasses = 4;                        // 32 bits
constexpr int kTileThreads = 256;                    // one thread a digit
constexpr int kTileWarps = kTileThreads / kWarp;     // 8
constexpr int kTileKeys = 2048;                      // keys a onesweep tile
constexpr int kUpsweepMaxCtas = 512;
constexpr int kExpandThreads = 256;
constexpr int kExpandTris = 1024;                    // triangles an expand CTA
constexpr int kTrisPerThread = kExpandTris / kExpandThreads;
constexpr int kScanThreads = 1024;
constexpr int kCoopMaxTiles = 64;                    // CTAs of the one launch
constexpr int kOneLaunchMaxKeys = kCoopMaxTiles * kTileKeys;      // 131,072
constexpr int kMaxN = (1 << 30) - 1;
constexpr unsigned kFlagAgg = 1u << 30;              // a tile's own count
constexpr unsigned kFlagInc = 2u << 30;              // its inclusive prefix
constexpr unsigned kCountMask = (1u << 30) - 1;
static_assert(kTileThreads == kRadix, "one scatter thread a digit");
static_assert(kTileKeys % kTileWarps == 0, "equal warp runs a tile");

__device__ __forceinline__ int digit(int key, int shift) {
  return static_cast<int>((static_cast<unsigned>(key) >> shift) & (kRadix - 1));
}

// The lanes whose digit equals this lane's (d in [0, 256), or -1 for a lane
// with no key, which matches only such lanes): __match_any_sync on 8-bit
// digits, built from nine warp ballots.
__device__ __forceinline__ unsigned match_digit(int d) {
  const unsigned live = __ballot_sync(kFull, d >= 0);
  unsigned m = d >= 0 ? live : ~live;
#pragma unroll
  for (int b = 0; b < kRadixBits; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned v = __ballot_sync(kFull, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

// The keys a call sorts: n, or with B4's device pair total, that total
// when it fits in n (the capacity), else none (an overflow).
__device__ __forceinline__ int live_keys(int n, const long long* total) {
  if (total == nullptr) return n;
  const long long t = *total;
  return t >= 0 && t <= n ? static_cast<int>(t) : 0;
}

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_volatile(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// Exclusive sum of one value a thread over a block of W warps; `total` (if
// given) receives the block's sum. `part` holds W ints. Ends synced.
template <int W>
__device__ int block_exclusive_sum(int v, int* part, int* total = nullptr) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int inc = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == kWarp - 1) part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int p = lane < W ? part[lane] : 0;
    int q = p;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, q, o);
      if (lane >= o) q += y;
    }
    if (lane < W) part[lane] = q - p;
    if (lane == kWarp - 1 && total != nullptr) *total = q;
  }
  __syncthreads();
  const int out = part[warp] + inc - v;
  __syncthreads();
  return out;
}

// Warp w's counter of digit d: digit-major rows of W counters padded to
// W + 1, so that the lanes of one warp, holding distinct digits, hit
// distinct shared-memory banks.
template <int W>
__device__ __forceinline__ int slot(int d, int w) {
  return d * (W + 1) + w;
}

// In-place exclusive scan of the counters in digit-major order (256 x W
// of them) by the block's W x 32 threads, 8 a thread. Ends synced.
template <int W>
__device__ void scan_counts(int* cnt, int* part) {
  constexpr int kPer = kRadix / kWarp;               // 8, inside one row
  static_assert(W % kPer == 0, "a thread's counters lie in one digit row");
  const int e = threadIdx.x * kPer;
  int* mine = cnt + slot<W>(e / W, e % W);
  int v[kPer];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = mine[i];
    sum += v[i];
  }
  int run = block_exclusive_sum<W>(sum, part);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    mine[i] = run;
    run += v[i];
  }
  __syncthreads();
}

// Walk 1: warp `warp` counts the digits of keys[lo, hi) into its column
// counter slot<W>(d, warp). The loop is uniform across the warp.
template <int W>
__device__ void count_run(const int* keys, int lo, int hi, int shift, int* cnt,
                          int warp, int lane) {
  const unsigned lower = (1u << lane) - 1u;
  for (int b = lo; b < hi; b += kWarp) {
    const int i = b + lane;
    const int d = i < hi ? digit(keys[i], shift) : -1;
    const unsigned peers = match_digit(d);
    if (d >= 0 && (peers & lower) == 0) cnt[slot<W>(d, warp)] += __popc(peers);
    __syncwarp();
  }
}

// Walk 2: the same run in the same order; each key goes to base[d] (0 when
// base is null) + its warp's next slot for d. keys_out null: keys not
// written (B4's last pass needs only the values).
template <int W, bool kValues>
__device__ void scatter_run(const int* keys, const int* vals, int lo, int hi,
                            int shift, int* cnt, const int* base, int* keys_out,
                            int* vals_out, int n, int warp, int lane) {
  const unsigned lower = (1u << lane) - 1u;
  for (int b = lo; b < hi; b += kWarp) {
    const int i = b + lane;
    const bool live = i < hi;
    const int key = live ? keys[i] : 0;
    const int d = live ? digit(key, shift) : -1;
    const unsigned peers = match_digit(d);
    int r = 0;
    if (live) r = cnt[slot<W>(d, warp)] + __popc(peers & lower);
    __syncwarp();                         // every read precedes the bump
    if (live && (peers & lower) == 0) cnt[slot<W>(d, warp)] = r + __popc(peers);
    __syncwarp();                         // bumps visible to the next step
    if (!live) continue;
    const int pos = r + (base != nullptr ? base[d] : 0);
    if (pos < 0 || pos >= n) continue;
    if (keys_out != nullptr) keys_out[pos] = key;
    if (kValues) vals_out[pos] = vals[i];
  }
}

// The shared state of one 2,048-key tile.
template <bool kValues>
struct TileSmem {
  int keys[kTileKeys];
  int vals[kValues ? kTileKeys : 1];
  int cnt[kRadix * (kTileWarps + 1)];
  int part[kWarp];
  int base[kRadix];                       // a digit's first output slot
};

// Loads keys (and values) [t0, t0 + m) through L2 (other CTAs wrote them),
// ranks them on the digit at `shift`; returns thread d's count of digit d
// in the tile and sets `local` to the digit's first slot in the tile.
template <bool kValues>
__device__ int rank_tile(TileSmem<kValues>& s, const int* keys_in,
                         const int* vals_in, int t0, int m, int shift,
                         int& local) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  for (int i = tid; i < kRadix * (kTileWarps + 1); i += kTileThreads) s.cnt[i] = 0;
#pragma unroll
  for (int j = 0; j < kTileKeys / kTileThreads; ++j) {   // loads in flight
    const int i = j * kTileThreads + tid;
    if (i < m) {
      s.keys[i] = __ldcg(keys_in + t0 + i);
      if (kValues) s.vals[i] = __ldcg(vals_in + t0 + i);
    }
  }
  __syncthreads();
  constexpr int kPer = kTileKeys / kTileWarps;
  const int lo = min(warp * kPer, m), hi = min(lo + kPer, m);
  count_run<kTileWarps>(s.keys, lo, hi, shift, s.cnt, warp, lane);
  __syncthreads();
  scan_counts<kTileWarps>(s.cnt, s.part);
  local = s.cnt[slot<kTileWarps>(tid, 0)];
  const int next = tid + 1 < kRadix ? s.cnt[slot<kTileWarps>(tid + 1, 0)] : m;
  return next - local;
}

// Scatters the ranked tile to s.base[d] + its slot past the digit's first.
template <bool kValues>
__device__ void scatter_tile(TileSmem<kValues>& s, int m, int shift,
                             int* keys_out, int* vals_out, int n) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  constexpr int kPer = kTileKeys / kTileWarps;
  const int lo = min(warp * kPer, m), hi = min(lo + kPer, m);
  scatter_run<kTileWarps, kValues>(s.keys, s.vals, lo, hi, shift, s.cnt,
                                   s.base, keys_out, vals_out, n, warp, lane);
}

// The one-launch sort: CTA b keeps tile b through every pass; passes meet
// at grid barriers. tile_counts: gridDim.x x 256 words, no clearing needed.
// keys_last 0: the last pass writes values only. The input may be the
// output: every tile is loaded before the pass's first barrier. n keys, or
// live_keys(n, total): a CTA past them ranks an empty tile (every CTA
// meets the barriers).
template <bool kValues>
__global__ void __launch_bounds__(kTileThreads)
sort_coop_kernel(const int* keys_in, const int* vals_in, int* keys_out,
                 int* vals_out, int* keys_tmp, int* vals_tmp, int n,
                 const long long* total, int passes, int keys_last,
                 int* tile_counts) {
  __shared__ TileSmem<kValues> s;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int tid = threadIdx.x, tile = blockIdx.x, tiles = gridDim.x;
  n = live_keys(n, total);
  const int t0 = tile * kTileKeys, m = max(0, min(kTileKeys, n - t0));
  const int* src_k = keys_in;
  const int* src_v = vals_in;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kRadixBits;
    const bool to_out = (passes - 1 - p) % 2 == 0;     // the last pass: out
    int* dst_k = to_out ? keys_out : keys_tmp;
    int* dst_v = to_out ? vals_out : vals_tmp;
    int local;
    const int own = rank_tile(s, src_k, src_v, t0, m, shift, local);
    tile_counts[tile * kRadix + tid] = own;
    grid.sync();
    int before = 0, all = 0;
#pragma unroll 16
    for (int t = 0; t < tiles; ++t) {
      const int c = __ldcg(tile_counts + t * kRadix + tid);
      if (t < tile) before += c;
      all += c;
    }
    s.base[tid] = block_exclusive_sum<kTileWarps>(all, s.part) + before - local;
    __syncthreads();
    const bool last = p == passes - 1;
    scatter_tile(s, m, shift, last && !keys_last ? nullptr : dst_k, dst_v, n);
    if (!last) grid.sync();
    src_k = dst_k;
    src_v = dst_v;
  }
}

// Every pass's digit histogram, added into hist[passes][256].
__global__ void __launch_bounds__(kTileThreads)
upsweep_kernel(const int* __restrict__ keys, int n, int passes, int* hist) {
  __shared__ int s[kMaxPasses * kRadix];
  const int tid = threadIdx.x, lane = tid % kWarp;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = tid; i < passes * kRadix; i += kTileThreads) s[i] = 0;
  __syncthreads();
  const int stride = gridDim.x * kTileThreads;
  for (int b = blockIdx.x * kTileThreads + (tid - lane); b < n; b += stride) {
    const int i = b + lane;
    const int key = i < n ? keys[i] : 0;
    for (int p = 0; p < passes; ++p) {
      const int d = i < n ? digit(key, p * kRadixBits) : -1;
      const unsigned peers = match_digit(d);
      if (d >= 0 && (peers & lower) == 0) atomicAdd(&s[p * kRadix + d], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = tid; i < passes * kRadix; i += kTileThreads)
    if (s[i] != 0) atomicAdd(&hist[i], s[i]);
}

// Thread t's inclusive prefix over the look-back words look[0..tile) of its
// column (stride `stride`), after publishing `own` for tile `tile`.
__device__ int look_back(unsigned* look, int tile, int stride, int own) {
  unsigned* mine = look + static_cast<size_t>(tile) * stride;
  if (tile == 0) {
    store_volatile(mine, kFlagInc | static_cast<unsigned>(own));
    return 0;
  }
  store_volatile(mine, kFlagAgg | static_cast<unsigned>(own));
  int prefix = 0;
  for (int t = tile - 1; t >= 0; --t) {
    const unsigned* w = look + static_cast<size_t>(t) * stride;
    unsigned v;
    while (((v = load_volatile(w)) & ~kCountMask) == 0) {
    }
    prefix += static_cast<int>(v & kCountMask);
    if ((v & ~kCountMask) == kFlagInc) break;
  }
  store_volatile(mine, kFlagInc | static_cast<unsigned>(prefix + own));
  return prefix;
}

// One onesweep pass: hist = this pass's 256 global counts, look = its
// (tiles, 256) look-back words, ticket = its tile counter. n keys, or
// live_keys(n, total): a CTA whose tile lies past them returns at once (it
// holds the highest tickets, and a tile waits only on lower ones).
template <bool kValues>
__global__ void __launch_bounds__(kTileThreads)
scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
               int* keys_out, int* vals_out, int n, const long long* total,
               int shift, const int* __restrict__ hist, int* ticket,
               unsigned* look) {
  __shared__ TileSmem<kValues> s;
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int t0 = tile * kTileKeys;
  n = live_keys(n, total);
  if (t0 >= n) return;
  const int start = block_exclusive_sum<kTileWarps>(hist[tid], s.part);  // synced
  const int m = min(kTileKeys, n - t0);
  int local;
  const int own = rank_tile(s, keys_in, vals_in, t0, m, shift, local);
  s.base[tid] = start + look_back(look + tid, tile, kRadix, own) - local;
  __syncthreads();
  scatter_tile(s, m, shift, keys_out, vals_out, n);
}

// B4's pairs: CTA (by ticket) expands triangles [tile * 1024, +1024) into
// keys (tile ids) and vals (triangle ids) at offsets from a look-back scan
// of cx * cy; counts the pairs per tile; adds the digit histograms (hist
// null: the one-launch sort needs none). live_keys(capacity, total) pairs:
// none on an overflow, whose bins stay empty.
__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const int* __restrict__ tx0, const int* __restrict__ cx,
              const int* __restrict__ ty0, const int* __restrict__ cy,
              int n_tris, int ntx, int n_tiles, int capacity,
              const long long* total_in, int passes, int* counts, int* hist,
              int* ticket, unsigned* look, int* keys, int* vals) {
  __shared__ int s_off[kExpandTris];
  __shared__ int s_hist[kMaxPasses * kRadix];
  __shared__ int part[kWarp];
  __shared__ int s_tile, s_total, s_prefix;
  const int total = live_keys(capacity, total_in);
  if (total == 0) return;
  const int tid = threadIdx.x, lane = tid % kWarp;
  const unsigned lower = (1u << lane) - 1u;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  for (int i = tid; i < kMaxPasses * kRadix; i += kExpandThreads) s_hist[i] = 0;
  __syncthreads();
  const int t0 = s_tile * kExpandTris;
  int pc[kTrisPerThread];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kTrisPerThread; ++j) {
    const int tri = t0 + tid * kTrisPerThread + j;
    pc[j] = tri < n_tris ? cx[tri] * cy[tri] : 0;
    sum += pc[j];
  }
  int off = block_exclusive_sum<kExpandThreads / kWarp>(sum, part, &s_total);
#pragma unroll
  for (int j = 0; j < kTrisPerThread; ++j) {
    s_off[tid * kTrisPerThread + j] = off;
    off += pc[j];
  }
  if (tid == 0) s_prefix = look_back(look, s_tile, 1, s_total);
  __syncthreads();
  const int btotal = s_total, prefix = s_prefix;
  for (int b = tid - lane; b < btotal; b += kExpandThreads) {
    const int j = b + lane;
    const bool live = j < btotal && prefix + j < total;
    int tile = -1;
    if (live) {
      int lo = 0, hi = kExpandTris;       // the last triangle with s_off <= j
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= j) lo = mid; else hi = mid;
      }
      const int tri = t0 + lo;
      const int k = j - s_off[lo];
      const int w = cx[tri];
      const int dy = k / w;
      tile = (ty0[tri] + dy) * ntx + tx0[tri] + (k - dy * w);
      keys[prefix + j] = tile;
      vals[prefix + j] = tri;
    }
    const bool counted = live && tile >= 0 && tile < n_tiles;
    const unsigned peers = __match_any_sync(kFull, counted ? tile : -1);
    if (counted && (peers & lower) == 0) atomicAdd(&counts[tile], __popc(peers));
    if (hist != nullptr) {
      for (int p = 0; p < passes; ++p) {
        const int d = live ? digit(tile, p * kRadixBits) : -1;
        const unsigned dp = match_digit(d);
        if (d >= 0 && (dp & lower) == 0) atomicAdd(&s_hist[p * kRadix + d], __popc(dp));
      }
    }
  }
  if (hist == nullptr) return;
  __syncthreads();
  for (int i = tid; i < passes * kRadix; i += kExpandThreads)
    if (s_hist[i] != 0) atomicAdd(&hist[i], s_hist[i]);
}

// starts = the exclusive scan of counts[0, n): a CTA (by ticket) a run of
// 1,024 counts, chained by a decoupled look-back.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int* __restrict__ starts, int n,
            int* ticket, unsigned* look) {
  __shared__ int part[kWarp];
  __shared__ int s_tile, s_total, s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int i = s_tile * kScanThreads + threadIdx.x;
  const int c = i < n ? counts[i] : 0;
  const int excl = block_exclusive_sum<kScanThreads / kWarp>(c, part, &s_total);
  if (threadIdx.x == 0) s_prefix = look_back(look, s_tile, 1, s_total);
  __syncthreads();
  if (i < n) starts[i] = s_prefix + excl;
}

int passes_of(int bits) { return (bits + kRadixBits - 1) / kRadixBits; }
int tiles_of(int n) { return (n + kTileKeys - 1) / kTileKeys; }

// int32 words of the zeroed onesweep scratch: histograms, tickets,
// look-back words (ops/sort.py::plan mirrors this).
size_t onesweep_words(int n, int passes) {
  return static_cast<size_t>(passes) * (kRadix + 1)
      + static_cast<size_t>(passes) * tiles_of(n) * kRadix;
}

// The passes over n keys (values if vals_in), or over live_keys(n, total)
// of them in grids sized for n: from keys_in/vals_in into
// keys_out/vals_out, through keys_tmp/vals_tmp when there are two passes or
// more. onesweep false: the one launch, scratch = ceil(n / 2,048) x 256
// words for the tiles' counts; true: the onesweep passes, scratch = the
// zeroed onesweep scratch with its histograms added. keys_last false: the
// last pass writes values only.
template <bool kValues>
cudaError_t sort_passes(const int* keys_in, const int* vals_in, int* keys_out,
                        int* vals_out, int* keys_tmp, int* vals_tmp, int n,
                        const long long* total, int passes, int* scratch,
                        bool onesweep, bool keys_last, cudaStream_t st) {
  const int tiles = tiles_of(n);
  if (!onesweep) {
    if (tiles > kCoopMaxTiles) return cudaErrorInvalidValue;
    int last_keys = keys_last;
    void* args[] = {&keys_in, &vals_in, &keys_out, &vals_out, &keys_tmp,
                    &vals_tmp, &n, &total, &passes, &last_keys, &scratch};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(sort_coop_kernel<kValues>), dim3(tiles),
        dim3(kTileThreads), args, 0, st);
  }
  int* hist = scratch;
  int* tickets = hist + passes * kRadix;
  unsigned* look = reinterpret_cast<unsigned*>(tickets + passes);
  const int* src_k = keys_in;
  const int* src_v = vals_in;
  for (int p = 0; p < passes; ++p) {
    const bool to_out = (passes - 1 - p) % 2 == 0;      // the last pass: out
    int* dst_k = to_out ? keys_out : keys_tmp;
    int* dst_v = to_out ? vals_out : vals_tmp;
    const bool last = p == passes - 1;
    scatter_kernel<kValues><<<tiles, kTileThreads, 0, st>>>(
        src_k, src_v, last && !keys_last ? nullptr : dst_k, dst_v, n, total,
        p * kRadixBits, hist + p * kRadix, tickets + p,
        look + static_cast<size_t>(p) * tiles * kRadix);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src_k = dst_k;
    src_v = dst_v;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The constants the wrappers' planner (ops/sort.py) mirrors, for a check on
// the card: {radix bits, keys a tile, keys of the one-launch path,
// triangles an expand CTA, counts a scan CTA}.
void radix_constants(int* out) {
  out[0] = kRadixBits;
  out[1] = kTileKeys;
  out[2] = kOneLaunchMaxKeys;
  out[3] = kExpandTris;
  out[4] = kScanThreads;
}

// B2: sort keys[0, n) (all in [0, 2^bits)) ascending into out on `stream`;
// tmp: n words, used when there are two passes or more. n <= 131,072: one
// cooperative launch, scratch = ceil(n / 2,048) x 256 words. Else the
// onesweep path: scratch = onesweep_words(n, passes) words, cleared here.
// Returns a cudaError_t code (0 = launched).
int radix_sort_launch(const int* keys, int* out, int* tmp, int n, int bits,
                      int* scratch, int device, void* stream) {
  if (n < 1 || n > kMaxN || bits < 1 || bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int passes = passes_of(bits);
  const bool onesweep = n > kOneLaunchMaxKeys;
  if (onesweep) {
    err = cudaMemsetAsync(scratch, 0, onesweep_words(n, passes) * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ctas = tiles_of(n) < kUpsweepMaxCtas ? tiles_of(n) : kUpsweepMaxCtas;
    upsweep_kernel<<<ctas, kTileThreads, 0, st>>>(keys, n, passes, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(sort_passes<false>(keys, nullptr, out, nullptr, tmp,
                                             nullptr, n, nullptr, passes,
                                             scratch, onesweep, true, st));
}

// B4 on `stream`: bins of the (triangle, tile) pairs of the spans
// tx0/cx/ty0/cy (n_tris each, inside the ntx-wide grid of n_tiles tiles),
// sized for `capacity` pairs. total: null when the spans hold exactly
// `capacity` pairs; else the device's int64 sum of cx*cy (the front end's
// pair total), binned when it is at most `capacity`, else an overflow:
// empty bins. scratch: 2 * n_tiles + 2 + ceil(n_tris / 1024) +
// ceil(n_tiles / 1024) words cleared here, then ceil(capacity / 2,048) x
// 256 words when capacity <= 131,072 (the one-launch sort), else
// onesweep_words(capacity, passes) words, cleared too. Words [0, n_tiles)
// receive tile_starts, [n_tiles, 2 n_tiles) tile_counts. work: 3 *
// capacity words (the sorted keys, ping-pong keys and values); pair_tri:
// capacity words, the binned triangle ids first. bits = ceil(log2
// n_tiles) (at least 1). Returns a cudaError_t code.
int binsort_launch(const int* tx0, const int* cx, const int* ty0, const int* cy,
                   int n_tris, int ntx, int n_tiles, const long long* total,
                   int capacity, int bits, int* scratch, int* work,
                   int* pair_tri, int device, void* stream) {
  if (n_tris < 0 || n_tiles < 1 || capacity < 0 || capacity > kMaxN
      || bits < 1 || bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int passes = passes_of(bits);
  const int tri_tiles = (n_tris + kExpandTris - 1) / kExpandTris;
  const int scan_tiles = (n_tiles + kScanThreads - 1) / kScanThreads;
  const bool onesweep = capacity > kOneLaunchMaxKeys;
  int* starts = scratch;
  int* counts = starts + n_tiles;
  int* ticket = counts + n_tiles;                     // the expansion's
  unsigned* look = reinterpret_cast<unsigned*>(ticket + 1);
  int* scan_ticket = ticket + 1 + tri_tiles;
  unsigned* scan_look = reinterpret_cast<unsigned*>(scan_ticket + 1);
  int* sort_scratch = scan_ticket + 1 + scan_tiles;
  const size_t words = 2 * static_cast<size_t>(n_tiles) + 2 + tri_tiles
      + scan_tiles + (onesweep ? onesweep_words(capacity, passes) : 0);
  err = cudaMemsetAsync(scratch, 0, words * sizeof(int), st);
  if (err != cudaSuccess || capacity == 0 || n_tris == 0)
    return static_cast<int>(err);
  // the pairs go where the first pass does not write: the output buffers
  // when the onesweep passes are even (the one launch loads every tile
  // before it writes), the ping-pong ones when odd
  int* keys_out = work;
  int* keys_tmp = work + capacity;
  int* vals_tmp = work + 2 * static_cast<size_t>(capacity);
  const bool in_out = !onesweep || passes % 2 == 0;
  int* keys0 = in_out ? keys_out : keys_tmp;
  int* vals0 = in_out ? pair_tri : vals_tmp;
  expand_kernel<<<tri_tiles, kExpandThreads, 0, st>>>(
      tx0, cx, ty0, cy, n_tris, ntx, n_tiles, capacity, total, passes, counts,
      onesweep ? sort_scratch : nullptr, ticket, look, keys0, vals0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<scan_tiles, kScanThreads, 0, st>>>(counts, starts, n_tiles,
                                                   scan_ticket, scan_look);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sort_passes<true>(
      keys0, vals0, keys_out, pair_tri, keys_tmp, vals_tmp, capacity, total,
      passes, sort_scratch, onesweep, false, st));
}

}  // extern "C"
