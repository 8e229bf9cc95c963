// Group-interleaved lane-class placement of (triangle, tile) pairs (kernel B5).
//
// Replaces the TPU kernel cython3dmodelrenderer_tpu/ops/binsort_pallas.py
// (_make_group_kernel, launched by bin_sort_grouped). The pairs arrive as
// one packed int32 each, (tri << 14) | tile, in triangle order; pairs past
// the expansion's clamp target the sentinel tile n_tiles, whose bound is 0.
// Pair i of tile t with rank r (the number of earlier pairs of t) goes to
//
//     pos = base[t] + (r % b) * group * sub + (r / b) * group,  b = blocks[t]
//
// and is stored only when pos < bound[t] and r < b * sub; an unstored pair
// still counts in the ranks of the pairs after it. The TPU kernel got the
// ranks from ONE scalar loop bumping a per-tile cursor in SMEM. Here the
// ranks are computed in parallel and deterministically:
//
//  * the pairs are cut into blocks of K consecutive pairs;
//  * pass A (group_count_kernel) counts each block's pairs per tile into
//    its row of a (blocks, n_tiles + 1) int32 table with atomicAdd (a count
//    does not depend on the order the atomics land in);
//  * the wrapper scans each column (exclusive cumsum): block k's cursor for
//    tile t is the number of t's pairs in blocks 0..k-1;
//  * pass B (group_place_kernel): one warp per block takes its pairs 32 at
//    a time, in order. __match_any_sync groups the lanes that hold the same
//    tile; a lane's rank is the cursor plus the number of lower lanes in
//    its group, and the group's lowest lane advances the cursor by the
//    group's size. No atomic decides a rank, so every run places the same
//    way, and each rank is exactly the scalar loop's.
//
// What bounds it on an H100: at most 2^17 pairs (the packed key) and
// 2^14 + 1 cursor columns, so a call is a few microseconds of work behind
// launch latency; pass B's warp steps are a chain of dependent cursor
// round trips through L1/L2, K / 32 steps per warp, so K sets its critical
// path and the table's size (zeroing, the wrapper's column scan) sets how
// small K may be (binsort_grouped.block_split).
//
// The kernels walk the first n_pairs pairs, the unclamped ones; the
// sentinel tail is never read (the TPU kernel's unrolled loop read up to 7
// of it).
//
// Preconditions (the wrapper's glue builds them): every tile field is in
// [0, n_tiles]; base/bound/blocks have n_tiles + 1 entries with blocks >= 1;
// every stored pos lies in [0, slot_cap) (bound <= slot_cap).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kCountThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileBits = 14;
constexpr int kTileMask = (1 << kTileBits) - 1;

// Pass A: block k adds one to table[k, tile] for each of its pairs
// [k*per_block, (k+1)*per_block).
__global__ void __launch_bounds__(kCountThreads)
group_count_kernel(const int* __restrict__ pairs, int n_pairs, int per_block,
                   int n_cols, int* __restrict__ table) {
  const int lo = blockIdx.x * per_block;
  const int hi = min(lo + per_block, n_pairs);
  int* row = table + static_cast<size_t>(blockIdx.x) * n_cols;
  for (int i = lo + threadIdx.x; i < hi; i += kCountThreads) {
    atomicAdd(&row[pairs[i] & kTileMask], 1);
  }
}

// Pass B: one warp per block of pairs; `cursors` row k holds block k's
// first rank per tile and is consumed.
__global__ void __launch_bounds__(kWarp)
group_place_kernel(const int* __restrict__ pairs, int n_pairs, int per_block,
                   int n_cols, int* __restrict__ cursors,
                   const int* __restrict__ base, const int* __restrict__ bound,
                   const int* __restrict__ blocks, int group, int sub,
                   int* __restrict__ order) {
  const int lo = blockIdx.x * per_block;
  const int hi = min(lo + per_block, n_pairs);
  int* cur = cursors + static_cast<size_t>(blockIdx.x) * n_cols;
  const int lane = threadIdx.x;
  const unsigned lower = (1u << lane) - 1u;
  for (int i0 = lo; i0 < hi; i0 += kWarp) {
    const int i = i0 + lane;
    const bool live = i < hi;
    const int p = live ? pairs[i] : 0;
    const int tile = live ? (p & kTileMask) : -1;   // -1 matches no tile
    const unsigned peers = __match_any_sync(kFull, tile);
    int r = 0;
    if (live) r = cur[tile] + __popc(peers & lower);
    __syncwarp();                     // every read precedes the bump
    if (live && (peers & lower) == 0) cur[tile] = r + __popc(peers);
    __syncwarp();                     // bumps visible to the next step
    if (!live) continue;
    const int b = blocks[tile];
    const int pos = base[tile] + (r % b) * (group * sub) + (r / b) * group;
    if (pos < bound[tile] && r < b * sub) order[pos] = p >> kTileBits;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Pass A on `stream` over ceil(n_pairs / per_block) blocks; `table`
// ((blocks, n_cols) int32, n_cols = n_tiles + 1) must be zeroed. Returns a
// cudaError_t code.
int group_count_launch(const int* pairs, int n_pairs, int per_block,
                       int n_cols, int* table, int device, void* stream) {
  if (n_pairs <= 0 || per_block <= 0 || n_cols <= 0 || n_cols > kTileMask + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = (n_pairs + per_block - 1) / per_block;
  group_count_kernel<<<nblocks, kCountThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pairs, n_pairs, per_block, n_cols, table);
  return static_cast<int>(cudaGetLastError());
}

// Pass B on `stream`: `cursors` ((blocks, n_cols) int32) from the column
// scan of pass A's table; base/bound/blocks the per-tile placement tables
// (n_cols entries); order (slot_cap int32, pre-filled) receives the stored
// triangle ids. Returns a cudaError_t code.
int group_place_launch(const int* pairs, int n_pairs, int per_block,
                       int n_cols, int* cursors, const int* base,
                       const int* bound, const int* blocks, int group, int sub,
                       int* order, int device, void* stream) {
  if (n_pairs <= 0 || per_block <= 0 || n_cols <= 0 || n_cols > kTileMask + 1
      || group <= 0 || sub <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = (n_pairs + per_block - 1) / per_block;
  group_place_kernel<<<nblocks, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      pairs, n_pairs, per_block, n_cols, cursors, base, bound, blocks, group,
      sub, order);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
