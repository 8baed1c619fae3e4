// K22 member_compact — the live rows of B members over one slab, as
// member-major row ids.
//
// Replaces: tidb_tpu/executor/microbatch.py _demux's per-member
// `np.nonzero(live[k])[0]` over the batched program's [B, cap] live mask
// (device_emit.py:558 emit_batched's output), which the reference runs on
// the host after fetching every lane of every column. Here the ids are
// made on the card, K18 gathers every output column through them, and
// only live rows cross to the host. B = 1 is the individual filter
// path's compaction (the reference's `live` fetched whole and indexed on
// the host).
//
//   live [B, cap] bool → counts [B] int64, offsets [B + 1] int64
//   (offsets[k] = the live rows of members before k), ids [total] int32:
//   ids[offsets[k] + j] is the row of member k's j-th live row, in
//   ascending row order.
//
// K19 delta_perm's count, scan and scatter with a member axis:
//   tile_counts:  one block per (tile of 1024 rows, member): warp ballots
//                 and __popc count the tile's live rows;
//   tile_offsets: one block scans the B x tiles counts (member-major, so
//                 the scan runs across members) into each tile's first
//                 output slot, and writes offsets and counts;
//   (the wrapper reads offsets[B] back: one sync, then allocates ids)
//   tile_scatter: re-reads the tile, ranks each live row within its warp
//                 (ballot + __popc of the lower lanes) and the warps
//                 within the tile (a shuffle scan), and stores the row.
//
// What bounds it on an H100: bytes — the mask is read twice (one byte a
// row, B x cap bytes each time) and each id written once (4 bytes a live
// row). At B = 16 and cap = 8,388,608 the scan runs over 131,072 tile
// counts in one block. No atomics: the order is the rows' own.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int TILE = 1024;        // rows per tile, one per thread
constexpr int WARPS = TILE / 32;  // == 32: warp 0 reduces the warp counts

__global__ void __launch_bounds__(TILE)
    tile_counts(const unsigned char* __restrict__ live, long long cap,
                long long ntiles, long long* __restrict__ tiles) {
  __shared__ int warp_n[WARPS];
  const long long member = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * TILE +
                      threadIdx.x;
  const bool f = i < cap && live[member * cap + i] != 0;
  const unsigned bal = __ballot_sync(0xffffffffu, f);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_n[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    int v = warp_n[lane];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) tiles[member * ntiles + blockIdx.x] = v;
  }
}

// in place: tiles[t] ← the sum of tiles[0..t) over the member-major
// B x ntiles counts; then offsets[k] (k ≤ B) and counts[k] (k < B)
__global__ void __launch_bounds__(TILE)
    tile_offsets(long long* __restrict__ tiles, int members,
                 long long ntiles, long long* __restrict__ offsets,
                 long long* __restrict__ counts) {
  typedef cub::BlockScan<long long, TILE> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long n = static_cast<long long>(members) * ntiles;
  long long carry = 0;
  for (long long base = 0; base < n; base += TILE) {
    const long long i = base + threadIdx.x;
    const long long v = i < n ? tiles[i] : 0;
    long long ex, agg;
    Scan(tmp).ExclusiveSum(v, ex, agg);
    if (i < n) tiles[i] = carry + ex;
    carry += agg;
    __syncthreads();
  }
  for (int k = threadIdx.x; k <= members; k += TILE) {
    const long long start =
        k == members ? carry : (ntiles > 0 ? tiles[k * ntiles] : 0);
    offsets[k] = start;
    if (k < members) {
      const long long end = k + 1 == members
                                ? carry
                                : (ntiles > 0 ? tiles[(k + 1) * ntiles] : 0);
      counts[k] = end - start;
    }
  }
}

__global__ void __launch_bounds__(TILE)
    tile_scatter(const unsigned char* __restrict__ live, long long cap,
                 long long ntiles, const long long* __restrict__ tiles,
                 int* __restrict__ ids) {
  __shared__ int warp_base[WARPS];
  const long long member = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * TILE +
                      threadIdx.x;
  const bool f = i < cap && live[member * cap + i] != 0;
  const unsigned bal = __ballot_sync(0xffffffffu, f);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_base[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    const int v = warp_base[lane];
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    warp_base[lane] = incl - v;   // exclusive: live rows of lower warps
  }
  __syncthreads();
  if (!f) return;
  const long long dst = tiles[member * ntiles + blockIdx.x] +
                        warp_base[warp] + __popc(bal & ((1u << lane) - 1u));
  ids[dst] = static_cast<int>(i);
}

bool bad_shape(int members, long long cap) {
  return members < 1 || members > 65535 || cap < 0 || cap > 0x7fffffffLL ||
         (cap + TILE - 1) / TILE > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// live: members x cap bools (row-major); tiles: members * ceil(cap / 1024)
// int64 scratch (at least one entry); offsets: members + 1 int64 (out);
// counts: members int64 (out).
int tt_member_count(const void* live, int members, long long cap,
                    void* tiles, void* offsets, void* counts, void* stream) {
  if (bad_shape(members, cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launches
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntiles = (cap + TILE - 1) / TILE;
  long long* t = static_cast<long long*>(tiles);
  if (ntiles > 0)
    tile_counts<<<dim3(static_cast<unsigned>(ntiles),
                       static_cast<unsigned>(members)),
                  TILE, 0, st>>>(static_cast<const unsigned char*>(live),
                                 cap, ntiles, t);
  tile_offsets<<<1, TILE, 0, st>>>(t, members, ntiles,
                                   static_cast<long long*>(offsets),
                                   static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// tiles: as tt_member_count left them; ids: offsets[members] int32 (out).
int tt_member_scatter(const void* live, int members, long long cap,
                      const void* tiles, void* ids, void* stream) {
  if (bad_shape(members, cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  const long long ntiles = (cap + TILE - 1) / TILE;
  if (ntiles == 0) return 0;
  tile_scatter<<<dim3(static_cast<unsigned>(ntiles),
                      static_cast<unsigned>(members)),
                 TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(live), cap, ntiles,
      static_cast<const long long*>(tiles), static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
