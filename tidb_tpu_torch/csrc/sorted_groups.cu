// K10 group_ids and K11 sorted_search — the halves of the sort formulation
// that follow the sort.
//
// K10 replaces the back half of tidb_tpu/ops/factorize.py factorize and
// _dense1: the boundaries between sorted neighbours (a NULL flag that
// differs, or two valid values that differ under the dtype's own `!=`, so
// -0.0 meets +0.0 and a NaN meets nothing, as in the JAX function),
// masked by the sorted row's liveness for factorize and unmasked for
// _dense1; their inclusive scan to gid_s; n_groups; gids[sidx] =
// clip(gid_s, 0, cap - 1); and rep, the smallest row index of each group.
// Since the sort is stable, that is the row at the group's boundary; the
// slot cap - 1 takes the minimum over every group clamped into it
// (atomicMin) when n_groups > cap; the caller fills empty slots with
// n - 1 first. It has two entries:
//   * words (tt_group_ids_words), for a sort whose operands fit one 64-bit
//     radix word: K8 has just written that word in sorted order, with the
//     dead flag, the NULL flag and the value code side by side. A
//     boundary is a change of any bit under `cmp_mask` (every field but
//     the dead flag: the JAX function compares the key components only)
//     or a NaN (K9 gives every NaN one code; the JAX `!=` makes each its
//     own group); the live flag is the dead bit, read from the same word.
//     One launch: each block takes its tile id from an atomic counter,
//     ranks its flags with warp ballots and finds its prefix by decoupled
//     look-back over the earlier tiles' status words (a 64-bit word per
//     tile: the count and a flag; zeroed by one memset per call).
//   * gather (tt_group_ids), for sorts of two or more words: the key and
//     its masks gathered through the permutation at each sorted position
//     and its neighbour, in a three-launch scan (block totals, one block
//     scanning them, a re-read that applies the carry).
//
// K11 replaces the searchsorted of tidb_tpu/ops/join.py
// sorted_probe_unique / sorted_probe_multi and of the device IN list
// (tidb_tpu/expression/__init__.py:1333): one thread per probe row runs a
// lower-bound (and for multi an upper-bound) binary search into the
// sorted build codes, then the hit test and the gather of the build row
// id. Unique mode also flags equal non-sentinel neighbours in the sorted
// codes (one write per block that finds any).
//
// What bounds them on an H100: bytes. K10's word entry reads the sorted
// words and the permutation contiguously (12 B a row; each word's
// neighbour is the previous lane's load, in L1) and makes one scattered
// 4 B gids write a row (the 4 B/row gids array fits the 50 MB L2, which
// merges the scattered stores). Its gather entry reads the permutation,
// the key at each sorted position and at its neighbour through it (random
// 8 B and 1 B reads; the neighbour's is usually in L1/L2 already) and the
// live mask, twice (the totals and the apply launch), and writes the gids.
// K11 reads each probe key and mask and writes its outputs; its ~21
// probes per row land in a sorted table that, at 2,097,152 int64 build
// codes (16 MB), stays in the 50 MB L2.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_T = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int WORD_ITEMS = 8;                      // rows per thread
constexpr int WORD_TILE = THREADS * WORD_ITEMS;    // 2048 rows a tile
constexpr long long SENTINEL = 0x7fffffffffffffffLL;
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long PREFIX = 2ull << 32;
typedef unsigned long long u64;

enum { DT_BOOL = 0, DT_I32 = 1, DT_I64 = 2, DT_F64 = 3 };

// ---- K10 -----------------------------------------------------------------

struct GroupIn {
  const int* sidx;
  const void* v;
  int dtype;
  const unsigned char* m;       // null: no NULLs
  const unsigned char* live;    // null: boundaries unmasked (_dense1)

  __device__ bool differs(int a, int b) const {
    if (m) {
      const bool ma = m[a] != 0, mb = m[b] != 0;
      if (ma != mb) return true;
      if (!ma) return false;    // two NULLs: one group
    }
    switch (dtype) {
      case DT_BOOL:
        return static_cast<const unsigned char*>(v)[a] !=
               static_cast<const unsigned char*>(v)[b];
      case DT_I32:
        return static_cast<const int*>(v)[a] != static_cast<const int*>(v)[b];
      case DT_I64:
        return static_cast<const long long*>(v)[a] !=
               static_cast<const long long*>(v)[b];
      default:
        return static_cast<const double*>(v)[a] !=
               static_cast<const double*>(v)[b];
    }
  }

  __device__ int flag(long long i) const {
    const int r = sidx[i];
    const bool b = i == 0 || differs(r, sidx[i - 1]);
    return (b && (live == nullptr || live[r])) ? 1 : 0;
  }
};

__global__ void __launch_bounds__(SCAN_T)
    gid_totals(GroupIn in, long long n, int* __restrict__ totals) {
  typedef cub::BlockReduce<int, SCAN_T> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const long long i = static_cast<long long>(blockIdx.x) * SCAN_T +
                      threadIdx.x;
  const int f = i < n ? in.flag(i) : 0;
  const int s = Reduce(tmp).Sum(f);
  if (threadIdx.x == 0) totals[blockIdx.x] = s;
}

// in place: totals[b] ← the sum of totals[0..b); the grand total →
// *n_groups when given
__global__ void __launch_bounds__(SCAN_T)
    gid_carries(int* __restrict__ totals, long long nblocks,
                int* __restrict__ n_groups) {
  typedef cub::BlockScan<int, SCAN_T> Scan;
  __shared__ typename Scan::TempStorage tmp;
  int carry = 0;
  for (long long base = 0; base < nblocks; base += SCAN_T) {
    const long long i = base + threadIdx.x;
    const int v = i < nblocks ? totals[i] : 0;
    int ex, agg;
    Scan(tmp).ExclusiveSum(v, ex, agg);
    if (i < nblocks) totals[i] = carry + ex;
    carry += agg;
    __syncthreads();
  }
  if (threadIdx.x == 0 && n_groups) *n_groups = carry;
}

__global__ void __launch_bounds__(SCAN_T)
    gid_apply(GroupIn in, long long n, const int* __restrict__ carries,
              int cap, int* __restrict__ gids, int* __restrict__ rep) {
  typedef cub::BlockScan<int, SCAN_T> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long i = static_cast<long long>(blockIdx.x) * SCAN_T +
                      threadIdx.x;
  const int f = i < n ? in.flag(i) : 0;
  int ex;
  Scan(tmp).ExclusiveSum(f, ex);
  if (i >= n) return;
  const int gid_s = carries[blockIdx.x] + ex + f - 1;
  const int r = in.sidx[i];
  if (cap <= 0) {               // _dense1: unclamped dense codes
    gids[r] = gid_s;
    return;
  }
  gids[r] = gid_s < 0 ? 0 : (gid_s >= cap ? cap - 1 : gid_s);
  if (f) {
    if (gid_s < cap - 1)
      rep[gid_s] = r;           // a group's first sorted row is its least
    else
      atomicMin(&rep[cap - 1], r);
  }
}

__device__ __forceinline__ void store_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 load_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

struct WordKey {
  u64 cmp_mask;       // the bits that tell groups apart
  u64 nan_mask;       // the value field (0: a constant one)
  u64 nan_val;        // the NaN code in it
  int has_nan;
  int dead_shift;     // the dead flag's bit, read when cap > 0
};

// the exclusive prefix of tile `tile` by decoupled look-back, one warp
// reading 32 earlier tiles' status words at a time (lane l: tile - 1 - l)
__device__ __forceinline__ int look_back(const u64* status, int tile,
                                         int lane) {
  int excl = 0;
  for (long long t = static_cast<long long>(tile) - 1; t >= 0; t -= 32) {
    const long long idx = t - lane;
    u64 s = idx >= 0 ? load_relaxed(status + idx) : PREFIX;
    while (!__all_sync(0xffffffffu, (s & (AGGREGATE | PREFIX)) != 0ull)) {
      if (!(s & (AGGREGATE | PREFIX))) s = load_relaxed(status + idx);
    }
    const unsigned pre = __ballot_sync(0xffffffffu, (s & PREFIX) != 0ull);
    int c = static_cast<int>(s & 0xffffffffull);
    if (pre) {
      // the newest tile with an inclusive prefix and the aggregates after it
      if (lane > __ffs(pre) - 1) c = 0;
      excl += static_cast<int>(__reduce_add_sync(0xffffffffu,
                                                 static_cast<unsigned>(c)));
      break;
    }
    excl += static_cast<int>(__reduce_add_sync(0xffffffffu,
                                               static_cast<unsigned>(c)));
  }
  return excl;
}

// before gid_words: the scratch (tile counter, status words) zeroed and
// rep (cap > 0) filled with `value`
__global__ void __launch_bounds__(THREADS)
    words_prep(u64* __restrict__ scratch, long long words,
               int* __restrict__ rep, int cap, int value) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  for (long long i = first; i < words; i += step) scratch[i] = 0ull;
  for (long long i = first; i < cap; i += step) rep[i] = value;
}

// one launch: flags, warp-ballot ranks, look-back, scatter
__global__ void __launch_bounds__(THREADS)
    gid_words(const u64* __restrict__ w, const int* __restrict__ sidx,
              long long n, WordKey key, int cap,
              unsigned* __restrict__ tile_counter, u64* status,
              int* __restrict__ gids, int* __restrict__ rep,
              int* __restrict__ n_groups) {
  __shared__ int warp_excl[WARPS];
  __shared__ int s_tile;
  __shared__ int s_excl;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(tile_counter, 1u));
  __syncthreads();
  const int tile = s_tile;
  // warp `warp` owns rows [wbase, wbase + 32 * WORD_ITEMS), walked in
  // rounds of 32: index order is (warp, round, lane). The words and row
  // ids stream through once (evict-first), so the scattered gids stay in
  // L2 until their sectors fill.
  const long long wbase = static_cast<long long>(tile) * WORD_TILE +
                          static_cast<long long>(warp) * (32 * WORD_ITEMS);
  u64 cur[WORD_ITEMS];
  int row[WORD_ITEMS];
#pragma unroll
  for (int j = 0; j < WORD_ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    cur[j] = i < n ? __ldcs(w + i) : 0ull;
    row[j] = i < n ? __ldcs(sidx + i) : 0;
  }
  // the word before the warp's run (lane 0 of round 0)
  const u64 before = (lane == 0 && wbase > 0 && wbase - 1 < n)
                         ? w[wbase - 1] : 0ull;
  const unsigned le = (2u << lane) - 1u;
  unsigned flags = 0u;
  int rank[WORD_ITEMS];
  int run = 0;
#pragma unroll
  for (int j = 0; j < WORD_ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    // the previous row's word: the lane before, or the last lane of the
    // round before
    u64 prev = __shfl_up_sync(0xffffffffu, cur[j], 1);
    if (j > 0) {
      const u64 last = __shfl_sync(0xffffffffu, cur[j - 1], 31);
      if (lane == 0) prev = last;
    } else if (lane == 0) {
      prev = before;
    }
    bool b = i < n &&
             (i == 0 || ((cur[j] ^ prev) & key.cmp_mask) != 0ull ||
              (key.has_nan && (cur[j] & key.nan_mask) == key.nan_val));
    if (cap > 0 && ((cur[j] >> key.dead_shift) & 1ull)) b = false;
    const unsigned bal = __ballot_sync(0xffffffffu, b);
    rank[j] = run + __popc(bal & le);      // inclusive
    run += __popc(bal);
    flags |= (b ? 1u : 0u) << j;
  }
  if (lane == 0) warp_excl[warp] = run;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < WARPS ? warp_excl[lane] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (lane < WARPS) warp_excl[lane] = incl - c;
    u64* mine = status + tile;
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) store_relaxed(mine, PREFIX | static_cast<u64>(total));
    } else {
      if (lane == 0) store_relaxed(mine, AGGREGATE | static_cast<u64>(total));
      excl = look_back(status, tile, lane);
      if (lane == 0)
        store_relaxed(mine, PREFIX | static_cast<u64>(excl + total));
    }
    if (lane == 0) {
      s_excl = excl;
      if (cap > 0 && tile == (n - 1) / WORD_TILE) *n_groups = excl + total;
    }
  }
  __syncthreads();
  const int base = s_excl + warp_excl[warp] - 1;
#pragma unroll
  for (int j = 0; j < WORD_ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    if (i >= n) continue;
    const int gid_s = base + rank[j];
    const int r = row[j];
    if (cap <= 0) {             // _dense1: unclamped dense codes
      gids[r] = gid_s;
      continue;
    }
    gids[r] = gid_s < 0 ? 0 : (gid_s >= cap ? cap - 1 : gid_s);
    if ((flags >> j) & 1u) {
      if (gid_s < cap - 1)
        rep[gid_s] = r;         // a group's first sorted row is its least
      else
        atomicMin(&rep[cap - 1], r);
    }
  }
}

// ---- K11 -----------------------------------------------------------------

__device__ __forceinline__ long long lower_bound(const long long* a,
                                                 long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long upper_bound(const long long* a,
                                                 long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    search_pos(const long long* __restrict__ sorted, long long nb,
               const long long* __restrict__ probe, long long P, int right,
               long long* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < P; i += step)
    out[i] = right ? upper_bound(sorted, nb, probe[i])
                   : lower_bound(sorted, nb, probe[i]);
}

// one thread per index of max(P, nb): probe rows and build neighbours
__global__ void __launch_bounds__(THREADS)
    probe_unique(const long long* __restrict__ sorted,
                 const int* __restrict__ order, long long nb,
                 const long long* __restrict__ probe,
                 const unsigned char* __restrict__ ok, long long P,
                 int* __restrict__ match_idx,
                 unsigned char* __restrict__ matched,
                 unsigned char* __restrict__ unique) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i < P) {
    const long long x = probe[i];
    long long pos = lower_bound(sorted, nb, x);
    pos = pos < nb ? pos : nb - 1;
    const bool hit = ok[i] && sorted[pos] == x;
    matched[i] = hit ? 1 : 0;
    match_idx[i] = hit ? order[pos] : 0;
  }
  const bool dup = i >= 1 && i < nb && sorted[i] == sorted[i - 1] &&
                   sorted[i] != SENTINEL;
  if (__syncthreads_or(dup) && threadIdx.x == 0) *unique = 0;
}

__global__ void __launch_bounds__(THREADS)
    probe_multi(const long long* __restrict__ sorted, long long nb,
                const long long* __restrict__ probe,
                const unsigned char* __restrict__ ok, long long P,
                int* __restrict__ start, int* __restrict__ count) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < P; i += step) {
    const long long x = probe[i];
    const long long lo = lower_bound(sorted, nb, x);
    const long long hi = upper_bound(sorted, nb, x);
    start[i] = static_cast<int>(lo);
    count[i] = ok[i] ? static_cast<int>(hi - lo) : 0;
  }
}

int blocks_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 16) b = 132 * 16;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

extern "C" {

// K10, gather. sidx: int32 (n), the stable sort permutation; v: n values of
// `dtype` (0 bool, 1 int32, 2 int64, 3 float64) in row order; m: bool (n)
// or null; live: bool (n) or null. cap > 0 (factorize): gids int32 (n)
// clamped to [0, cap), rep int32 (cap) pre-filled by the caller with
// max(n - 1, 0), n_groups one int32. cap == 0 (_dense1): gids only,
// unclamped. Scratch: block int32 (ceil(n / 1024)).
int tt_group_ids(const void* sidx, const void* v, int dtype, const void* m,
                 const void* live, long long n, int cap, void* gids,
                 void* rep, void* n_groups, void* block, void* stream) {
  if (n < 0 || n >= (1LL << 31) || cap < 0 || dtype < DT_BOOL ||
      dtype > DT_F64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* blk = static_cast<int*>(block);
  int* ng = static_cast<int*>(n_groups);
  if (n == 0) {
    if (ng) cudaMemsetAsync(ng, 0, sizeof(int), st);
    return static_cast<int>(cudaGetLastError());
  }
  GroupIn in{static_cast<const int*>(sidx), v, dtype,
             static_cast<const unsigned char*>(m),
             static_cast<const unsigned char*>(live)};
  const long long nblocks = (n + SCAN_T - 1) / SCAN_T;
  gid_totals<<<static_cast<unsigned>(nblocks), SCAN_T, 0, st>>>(in, n, blk);
  gid_carries<<<1, SCAN_T, 0, st>>>(blk, nblocks, cap > 0 ? ng : nullptr);
  gid_apply<<<static_cast<unsigned>(nblocks), SCAN_T, 0, st>>>(
      in, n, blk, cap, static_cast<int*>(gids), static_cast<int*>(rep));
  return static_cast<int>(cudaGetLastError());
}

// K10, words: w uint64 (n), the sort's one radix word in sorted order
// (K8's output); sidx int32 (n), its row ids. A boundary is i == 0, a
// change of (w[i] ^ w[i-1]) & cmp_mask, or (has_nan) w[i] & nan_mask ==
// nan_val; cap > 0 masks it by the live flag, bit dead_shift of w clear.
// Outputs as tt_group_ids, but rep (cap > 0) is filled here with
// max(n - 1, 0) first. Scratch: int64 (tt_group_words_scratch(n)), zeroed
// here (one launch does both).
int tt_group_ids_words(const void* w, const void* sidx, long long n,
                       unsigned long long cmp_mask, int has_nan,
                       unsigned long long nan_mask,
                       unsigned long long nan_val, int dead_shift, int cap,
                       void* gids, void* rep, void* n_groups, void* scratch,
                       void* stream) {
  if (n < 0 || n >= (1LL << 31) || cap < 0 || dead_shift < 0 ||
      dead_shift > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ng = static_cast<int*>(n_groups);
  const long long n_tiles = (n + WORD_TILE - 1) / WORD_TILE;
  u64* words = static_cast<u64*>(scratch);
  const long long most = (1 + n_tiles) > cap ? 1 + n_tiles : cap;
  const long long pb = (most + THREADS - 1) / THREADS;
  words_prep<<<static_cast<unsigned>(pb < 264 ? pb : 264), THREADS, 0, st>>>(
      words, 1 + n_tiles, static_cast<int*>(rep), cap,
      n > 0 ? static_cast<int>(n - 1) : 0);
  if (n == 0) {
    if (ng && cap > 0) cudaMemsetAsync(ng, 0, sizeof(int), st);
    return static_cast<int>(cudaGetLastError());
  }
  WordKey key{cmp_mask, nan_mask, nan_val, has_nan, dead_shift};
  gid_words<<<static_cast<unsigned>(n_tiles), THREADS, 0, st>>>(
      static_cast<const u64*>(w), static_cast<const int*>(sidx), n, key, cap,
      reinterpret_cast<unsigned*>(words), words + 1,
      static_cast<int*>(gids), static_cast<int*>(rep), ng);
  return static_cast<int>(cudaGetLastError());
}

// K10 words' scratch for n rows, in 64-bit words
int tt_group_words_scratch(long long n) {
  return 1 + static_cast<int>((n + WORD_TILE - 1) / WORD_TILE);
}

// K11, positions: out int64 (P) = the left (right = 0) or right insertion
// point of each probe value in the ascending int64 table `sorted` (nb).
int tt_sorted_search(const void* sorted, long long nb, const void* probe,
                     long long P, int right, void* out, void* stream) {
  if (nb < 0 || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (P == 0) return 0;
  search_pos<<<blocks_for(P), THREADS, 0, static_cast<cudaStream_t>(
      stream)>>>(static_cast<const long long*>(sorted), nb,
                 static_cast<const long long*>(probe), P, right,
                 static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K11, unique join: sorted int64 build codes (nb >= 1, dead/NULL rows hold
// INT64_MAX) and their build row ids `order` int32 (nb); probe codes
// int64 (P) with ok bool (P). Outputs: match_idx int32 (P), matched bool
// (P), unique one bool pre-set to 1 by the caller.
int tt_sorted_probe_unique(const void* sorted, const void* order,
                           long long nb, const void* probe, const void* ok,
                           long long P, void* match_idx, void* matched,
                           void* unique, void* stream) {
  if (nb < 1 || nb >= (1LL << 31) || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  const long long n = P > nb ? P : nb;
  probe_unique<<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                 THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sorted), static_cast<const int*>(order),
      nb, static_cast<const long long*>(probe),
      static_cast<const unsigned char*>(ok), P,
      static_cast<int*>(match_idx), static_cast<unsigned char*>(matched),
      static_cast<unsigned char*>(unique));
  return static_cast<int>(cudaGetLastError());
}

// K11, multi join: per probe row start = the left insertion point (int32)
// and count = right - left where ok, else 0.
int tt_sorted_probe_multi(const void* sorted, long long nb,
                          const void* probe, const void* ok, long long P,
                          void* start, void* count, void* stream) {
  if (nb < 0 || nb >= (1LL << 31) || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (P == 0) return 0;
  probe_multi<<<blocks_for(P), THREADS, 0, static_cast<cudaStream_t>(
      stream)>>>(static_cast<const long long*>(sorted), nb,
                 static_cast<const long long*>(probe),
                 static_cast<const unsigned char*>(ok), P,
                 static_cast<int*>(start), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
