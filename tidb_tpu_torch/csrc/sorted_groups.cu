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
// (tidb_tpu/expression/__init__.py:1333): per probe row the lower (and for
// multi the upper) bound of its code in the ascending build codes, then
// the hit test and the gather of the build row id; unique mode also flags
// equal non-sentinel neighbours in the sorted codes. A binary search over
// 2,097,152 codes takes ~21 dependent loads a row, of which ~11 leave L1
// as their own L2 sectors. K11 instead builds a bucket directory once a
// call and reads only the probe's bucket:
//   * the codes below INT64_MAX (the sentinel tail is answered without a
//     search), TRIM in from each end so a few outliers widen no bucket,
//     span [lo, hi]; a code's bucket is (x - lo) >> shift (0 at or below
//     lo, the last at or above hi) with the least shift that leaves
//     (hi - lo) >> shift below 2^k, 2^k about nb / 2 rounded up to a power
//     of two (ops/join.directory_log2);
//   * launch 1 (dir_build) finds n_real, the range and the shift on the
//     device and writes dir[b] = (T[b], T[b + 1]), T[b] the codes in
//     buckets below b: one full search per thread, then a doubling search
//     from each bucket's bound to the next;
//   * launch 2 (dir_probe) reads the row's pair (one 8-byte load) and a
//     bucket of at most SCAN_MAX codes whole, in 16-byte pairs with no
//     dependent loads (the lower bound, the upper bound and the hit from
//     one pass); a larger bucket is searched by halving, never more steps
//     than the whole table's search. Four rows a thread, in lockstep.
//
// What bounds them on an H100: bytes. K10's word entry reads the sorted
// words and the permutation contiguously (12 B a row; each word's
// neighbour is the previous lane's load, in L1) and makes one scattered
// 4 B gids write a row (the 4 B/row gids array fits the 50 MB L2, which
// merges the scattered stores). Its gather entry reads the permutation,
// the key at each sorted position and at its neighbour through it (random
// 8 B and 1 B reads; the neighbour's is usually in L1/L2 already) and the
// live mask, twice (the totals and the apply launch), and writes the gids.
// K11 reads each probe key and mask and writes its outputs; its directory
// (8 MB at 2,097,152 codes), the 16 MB of codes and the build row ids stay
// in the 50 MB L2. What limits it is the random loads a row makes (about
// 100 G random loads a second on the card): the directory pair, the
// bucket's one or two 16-byte pairs and, on a hit, the build row id.
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

constexpr int PROBES = 4;              // probe rows a thread takes
constexpr int DIR_MAX_LOG2 = 22;       // at most 2^22 buckets
constexpr int DIR_PARAM_BYTES = 64;    // SearchParams, ahead of the dir
constexpr int TRIM = 32;               // codes left out of the range at each end
constexpr int SCAN_MAX = 6;            // buckets this small are read whole
enum { MODE_UNIQUE = 0, MODE_MULTI = 1, MODE_LEFT = 2, MODE_RIGHT = 3 };

// what the directory launch finds and the probe launch reads (the first
// 64 bytes of the call's directory allocation)
struct SearchParams {
  long long amin;             // the smallest code below INT64_MAX
  long long amax;             // the largest code below INT64_MAX
  long long lo;               // the directory's range: TRIM codes in from
  long long hi;               // each end (all of them for a short table)
  unsigned long long last;    // the last bucket, (hi - lo) >> shift
  int n_real;                 // the codes below INT64_MAX (the rest are it)
  int shift;
  unsigned dup;               // unique mode: equal non-sentinel neighbours
  unsigned blocks_done;       // unique mode: probe blocks finished
};
static_assert(sizeof(SearchParams) <= DIR_PARAM_BYTES, "params");

// a code's bucket: 0 at or below lo, the last at or above hi, else
// (x - lo) >> shift in 64-bit unsigned arithmetic (the difference of two
// int64 codes in [lo, hi] fits); a shift of 64, which C leaves undefined,
// puts every code in bucket 0
__device__ __forceinline__ unsigned bucket_of(long long x,
                                              const SearchParams& p) {
  if (x <= p.lo) return 0u;
  if (x >= p.hi) return static_cast<unsigned>(p.last);
  const u64 d = static_cast<u64>(x) - static_cast<u64>(p.lo);
  return p.shift >= 64 ? 0u : static_cast<unsigned>(d >> p.shift);
}

// the codes below INT64_MAX in the ascending a[0, nb), by one warp (32
// probes a round; the same value on every lane)
__device__ long long warp_count_below_max(const long long* __restrict__ a,
                                          long long nb, int lane) {
  if (nb == 0) return 0;
  if (__ldg(a + nb - 1) != SENTINEL) return nb;
  long long lo = 0, hi = nb - 1;    // a[0, lo) below; a[hi] == INT64_MAX
  while (hi - lo > 32) {
    const long long p = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned below = __ballot_sync(0xffffffffu,
                                         __ldg(a + p) != SENTINEL);
    const int c = __popc(below);    // lanes 0 .. c - 1 lie below
    const long long new_lo = __shfl_sync(0xffffffffu, p, c > 0 ? c - 1 : 0);
    const long long new_hi = __shfl_sync(0xffffffffu, p, c < 32 ? c : 31);
    if (c > 0) lo = new_lo + 1;
    if (c < 32) hi = new_hi;
  }
  const long long i = lo + lane;
  const unsigned below = __ballot_sync(
      0xffffffffu, i < hi && __ldg(a + i) != SENTINEL);
  return lo + __popc(below);
}

// the first index of a[0, n) whose code is >= t (branchless halving)
__device__ __forceinline__ int lower_full(const long long* __restrict__ a,
                                          int n, long long t) {
  if (n == 0) return 0;
  int base = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
    if (__ldg(a + base + half) < t) base += half;
    len -= half;
  }
  return base + (__ldg(a + base) < t ? 1 : 0);
}

// the first index of a[from, n) whose code is >= t, given a[from - 1] < t:
// doubling steps from `from`, then halving inside the last step
__device__ __forceinline__ int gallop(const long long* __restrict__ a,
                                      int from, int n, long long t) {
  int lo = from, hi = n;            // a[0, lo) < t; the answer <= hi
  for (int step = 1;; step <<= 1) {
    const long long i = static_cast<long long>(lo) + step - 1;
    if (i >= n) break;
    if (__ldg(a + i) >= t) {
      hi = static_cast<int>(i);
      break;
    }
    lo = static_cast<int>(i) + 1;
  }
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The directory: T[b] (b in [0, 2^k]) = the codes below INT64_MAX whose
// bucket is below b, so bucket b's codes are a[T[b], T[b + 1]); stored as
// the pairs dir[b] = (T[b], T[b + 1]), one 8-byte load a probe row. T[b]
// for 1 <= b <= last is the lower bound of the bucket's first value
// lo + (b << shift). One thread fills four consecutive pairs: a full
// search for its first bound, then a doubling search from each bound to
// the next (about log2 of the codes between them). Every block first
// finds n_real, the range and the shift with one warp; block 0 writes
// them to `prm` and zeroes the probe launch's unique-mode words.
__global__ void __launch_bounds__(THREADS)
    dir_build(const long long* __restrict__ a, long long nb, int k,
              int2* __restrict__ dir, SearchParams* __restrict__ prm) {
  __shared__ SearchParams sp;
  if (threadIdx.x < 32) {
    const long long n_real = warp_count_below_max(a, nb, threadIdx.x);
    if (threadIdx.x == 0) {
      SearchParams p;
      const long long trim = n_real > 2 * TRIM + 1 ? TRIM : 0;
      p.n_real = static_cast<int>(n_real);
      p.amin = n_real ? __ldg(a) : 0;
      p.amax = n_real ? __ldg(a + n_real - 1) : 0;
      p.lo = n_real ? __ldg(a + trim) : 0;
      p.hi = n_real ? __ldg(a + n_real - 1 - trim) : 0;
      const u64 span = static_cast<u64>(p.hi) - static_cast<u64>(p.lo);
      const int bits = span ? 64 - __clzll(static_cast<long long>(span)) : 0;
      p.shift = bits > k ? bits - k : 0;
      p.last = p.shift >= 64 ? 0ull : span >> p.shift;
      p.dup = 0u;
      p.blocks_done = 0u;
      sp = p;
      if (blockIdx.x == 0) *prm = p;
    }
  }
  __syncthreads();
  const SearchParams p = sp;
  const long long nbk = 1LL << k;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long t = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       t * 4 < nbk; t += step) {
    const long long b0 = t * 4;
    int T[5];
    int prev = 0;
    bool searched = false;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const u64 b = static_cast<u64>(b0 + j);
      int v;
      if (b == 0) {
        v = 0;
      } else if (b > p.last) {
        v = p.n_real;
      } else {
        const long long tg = static_cast<long long>(
            static_cast<u64>(p.lo) + (b << p.shift));
        v = searched ? gallop(a, prev, p.n_real, tg)
                     : lower_full(a, p.n_real, tg);
        searched = true;
      }
      T[j] = v;
      prev = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (b0 + j < nbk) dir[b0 + j] = make_int2(T[j], T[j + 1]);
  }
}

// the lower (UPPER = false) or upper bound of x[j] in a[s[j], s[j] + n[j])
// for PROBES searches in lockstep (branchless halving; n[j] = 0 gives
// s[j]); `on[j]` false skips a row and leaves out[j]
template <bool UPPER>
__device__ __forceinline__ void bounds(const long long* __restrict__ a,
                                       const long long* x, const int* s,
                                       const int* n_in, const bool* on,
                                       int* out) {
  int base[PROBES], n[PROBES];
  bool more = false;
#pragma unroll
  for (int j = 0; j < PROBES; ++j) {
    base[j] = s[j];
    n[j] = on[j] ? n_in[j] : 0;
    more |= n[j] > 1;
  }
  while (more) {
    more = false;
#pragma unroll
    for (int j = 0; j < PROBES; ++j) {
      if (n[j] > 1) {
        const int half = n[j] >> 1;
        const long long v = __ldg(a + base[j] + half);
        if (UPPER ? v <= x[j] : v < x[j]) base[j] += half;
        n[j] -= half;
        more |= n[j] > 1;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PROBES; ++j) {
    if (!on[j]) continue;
    if (n[j] == 0) {
      out[j] = s[j];
    } else {
      const long long v = __ldg(a + base[j]);
      out[j] = base[j] + ((UPPER ? v <= x[j] : v < x[j]) ? 1 : 0);
    }
  }
}

// One launch for every probe row: each thread takes PROBES consecutive
// rows (16-byte key loads where aligned). A row below the smallest code,
// above the largest or equal to INT64_MAX is answered at once; the others
// read their bucket's pair from the directory. A bucket of at most
// SCAN_MAX codes is read whole in 16-byte pairs (no dependent loads): the
// codes below x give the lower bound, those at or below it the upper
// bound, an equal one the hit. A larger bucket is searched by halving,
// the rows' searches in lockstep. Unique mode also flags equal
// non-sentinel neighbours over the build (coalesced, grid-stride) and its
// last block writes the unique flag.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
    dir_probe(const long long* __restrict__ a, const int* __restrict__ order,
              long long nb, const int2* __restrict__ dir,
              SearchParams* __restrict__ prm,
              const long long* __restrict__ probe,
              const unsigned char* __restrict__ ok, long long P, int vec,
              void* __restrict__ out_a, void* __restrict__ out_b,
              unsigned char* __restrict__ unique) {
  const SearchParams p = *prm;
  const bool avec = (vec & 4) != 0;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  const long long quads = (P + PROBES - 1) / PROBES;
  for (long long q = first; q < quads; q += step) {
    const long long s0 = q * PROBES;
    const bool full = s0 + PROBES <= P;
    long long x[PROBES];
    bool okj[PROBES];
    if (full && (vec & 1)) {
      const longlong2* pp = reinterpret_cast<const longlong2*>(probe + s0);
      const longlong2 u = __ldcs(pp), w = __ldcs(pp + 1);
      x[0] = u.x; x[1] = u.y; x[2] = w.x; x[3] = w.y;
    } else {
#pragma unroll
      for (int j = 0; j < PROBES; ++j)
        x[j] = s0 + j < P ? __ldcs(probe + s0 + j) : 0;
    }
    if (MODE == MODE_UNIQUE || MODE == MODE_MULTI) {
      if (full && (vec & 2)) {
        const unsigned w =
            __ldcs(reinterpret_cast<const unsigned*>(ok + s0));
#pragma unroll
        for (int j = 0; j < PROBES; ++j) okj[j] = (w >> (8 * j)) & 0xffu;
      } else {
#pragma unroll
        for (int j = 0; j < PROBES; ++j)
          okj[j] = s0 + j < P && ok[s0 + j] != 0;
      }
    } else {
#pragma unroll
      for (int j = 0; j < PROBES; ++j) okj[j] = s0 + j < P;
    }
    // each row's answer without a search, or its bucket's range
    int lower[PROBES], upper[PROBES], s[PROBES], e[PROBES];
    bool found[PROBES], scan[PROBES], big[PROBES];
    bool any_big = false;
#pragma unroll
    for (int j = 0; j < PROBES; ++j) {
      const long long xv = x[j];
      found[j] = scan[j] = big[j] = false;
      s[j] = e[j] = 0;
      if (s0 + j >= P) {
        lower[j] = upper[j] = 0;
      } else if (xv == SENTINEL) {
        lower[j] = p.n_real;
        upper[j] = static_cast<int>(nb);
        found[j] = p.n_real < nb;
      } else if (p.n_real == 0 || xv < p.amin) {
        lower[j] = upper[j] = 0;
      } else if (xv > p.amax) {
        lower[j] = upper[j] = p.n_real;
      } else {
        const int2 se = __ldg(dir + bucket_of(xv, p));
        s[j] = se.x;
        e[j] = se.y;
        lower[j] = upper[j] = se.x;
        big[j] = se.y - se.x > SCAN_MAX;
        scan[j] = !big[j];
        any_big |= big[j];
      }
    }
    // small buckets: every code read, two to a 16-byte load
#pragma unroll
    for (int j = 0; j < PROBES; ++j) {
      if (!scan[j] || e[j] == s[j]) continue;
      const int c0 = s[j] >> 1, c1 = (e[j] - 1) >> 1;
      int less = 0, leq = 0;
      bool eq = false;
#pragma unroll
      for (int c = 0; c < SCAN_MAX / 2 + 1; ++c) {
        const int cc = c0 + c;
        if (cc > c1) break;
        const long long i0 = 2LL * cc;
        long long v0, v1 = 0;
        if (avec && i0 + 1 < nb) {
          const longlong2 w =
              __ldg(reinterpret_cast<const longlong2*>(a) + cc);
          v0 = w.x;
          v1 = w.y;
        } else {
          v0 = __ldg(a + i0);
          if (i0 + 1 < nb) v1 = __ldg(a + i0 + 1);
        }
        const bool in0 = i0 >= s[j] && i0 < e[j];
        const bool in1 = i0 + 1 >= s[j] && i0 + 1 < e[j];
        less += (in0 && v0 < x[j] ? 1 : 0) + (in1 && v1 < x[j] ? 1 : 0);
        leq += (in0 && v0 <= x[j] ? 1 : 0) + (in1 && v1 <= x[j] ? 1 : 0);
        eq |= (in0 && v0 == x[j]) || (in1 && v1 == x[j]);
      }
      lower[j] = s[j] + less;
      upper[j] = s[j] + leq;
      found[j] = eq;
    }
    // large buckets: halving, in lockstep
    if (any_big) {
      int len[PROBES];
#pragma unroll
      for (int j = 0; j < PROBES; ++j) len[j] = e[j] - s[j];
      if (MODE == MODE_RIGHT) {
        bounds<true>(a, x, s, len, big, upper);
      } else {
        bounds<false>(a, x, s, len, big, lower);
        if (MODE == MODE_UNIQUE) {
#pragma unroll
          for (int j = 0; j < PROBES; ++j)
            if (big[j])
              found[j] = lower[j] < e[j] && __ldg(a + lower[j]) == x[j];
        }
        if (MODE == MODE_MULTI) {
          // every code equal to x shares its bucket: the upper bound lies
          // in [lower, e); a row not ok needs none
          bool on[PROBES];
          int rest[PROBES];
#pragma unroll
          for (int j = 0; j < PROBES; ++j) {
            on[j] = big[j] && okj[j];
            rest[j] = e[j] - lower[j];
          }
          bounds<true>(a, x, lower, rest, on, upper);
        }
      }
    }
    if (MODE == MODE_UNIQUE) {
      int idx[PROBES];
      unsigned hitw = 0u;
#pragma unroll
      for (int j = 0; j < PROBES; ++j) {
        const bool hit = okj[j] && found[j];
        idx[j] = hit ? __ldg(order + lower[j]) : 0;
        hitw |= (hit ? 1u : 0u) << (8 * j);
      }
      int* mi = static_cast<int*>(out_a);
      unsigned char* mt = static_cast<unsigned char*>(out_b);
      if (full) {
        __stcs(reinterpret_cast<int4*>(mi + s0),
               make_int4(idx[0], idx[1], idx[2], idx[3]));
        __stcs(reinterpret_cast<unsigned*>(mt + s0), hitw);
      } else {
        for (int j = 0; j < PROBES && s0 + j < P; ++j) {
          mi[s0 + j] = idx[j];
          mt[s0 + j] = static_cast<unsigned char>((hitw >> (8 * j)) & 1u);
        }
      }
    } else if (MODE == MODE_MULTI) {
      int ct[PROBES];
#pragma unroll
      for (int j = 0; j < PROBES; ++j)
        ct[j] = okj[j] ? upper[j] - lower[j] : 0;
      int* sp = static_cast<int*>(out_a);
      int* cp = static_cast<int*>(out_b);
      if (full) {
        __stcs(reinterpret_cast<int4*>(sp + s0),
               make_int4(lower[0], lower[1], lower[2], lower[3]));
        __stcs(reinterpret_cast<int4*>(cp + s0),
               make_int4(ct[0], ct[1], ct[2], ct[3]));
      } else {
        for (int j = 0; j < PROBES && s0 + j < P; ++j) {
          sp[s0 + j] = lower[j];
          cp[s0 + j] = ct[j];
        }
      }
    } else {
      const int* r = MODE == MODE_RIGHT ? upper : lower;
      long long* op = static_cast<long long*>(out_a);
      if (full) {
        longlong2* pp = reinterpret_cast<longlong2*>(op + s0);
        __stcs(pp, make_longlong2(r[0], r[1]));
        __stcs(pp + 1, make_longlong2(r[2], r[3]));
      } else {
        for (int j = 0; j < PROBES && s0 + j < P; ++j) op[s0 + j] = r[j];
      }
    }
  }
  if (MODE == MODE_UNIQUE) {
    bool dup = false;
    for (long long i = first + 1; i < nb; i += step) {
      const long long v = __ldg(a + i);
      dup |= v == __ldg(a + i - 1) && v != SENTINEL;
    }
    if (__syncthreads_or(dup) && threadIdx.x == 0) atomicOr(&prm->dup, 1u);
    if (threadIdx.x == 0) {
      __threadfence();
      const unsigned done = atomicAdd(&prm->blocks_done, 1u);
      if (done == gridDim.x - 1) {
        __threadfence();
        *unique = atomicOr(&prm->dup, 0u) == 0u ? 1 : 0;
      }
    }
  }
}

// SMs x resident blocks of a kernel, found once per kernel
template <typename K>
int full_grid(K kernel, int* cache) {
  if (*cache == 0) {
    int dev = 0, sms = 132, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS, 0);
    *cache = sms * (per > 0 ? per : 1);
  }
  return *cache;
}

int grid_of(long long threads, int most) {
  const long long b = (threads + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b > most ? most : static_cast<int>(b));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

// the directory launch, then the probe launch in `MODE`
template <int MODE>
int run_search(const void* sorted, const void* order, long long nb,
               const void* probe, const void* ok, long long P, int k,
               void* scratch, void* out_a, void* out_b, void* unique,
               cudaStream_t st) {
  static int most_dir = 0, most_probe = 0;
  const long long* a = static_cast<const long long*>(sorted);
  SearchParams* prm = static_cast<SearchParams*>(scratch);
  int2* dir = reinterpret_cast<int2*>(static_cast<char*>(scratch) +
                                      DIR_PARAM_BYTES);
  const long long nbk = 1LL << k;
  dir_build<<<grid_of((nbk + 3) / 4, full_grid(dir_build, &most_dir)),
              THREADS, 0, st>>>(a, nb, k, dir, prm);
  const long long quads = (P + PROBES - 1) / PROBES;
  const long long work = MODE == MODE_UNIQUE && nb > quads ? nb : quads;
  const int vec = (aligned16(probe) ? 1 : 0) |
                  ((reinterpret_cast<uintptr_t>(ok) & 3u) == 0u ? 2 : 0) |
                  (aligned16(sorted) ? 4 : 0);
  dir_probe<MODE><<<grid_of(work, full_grid(dir_probe<MODE>, &most_probe)),
                    THREADS, 0, st>>>(
      a, static_cast<const int*>(order), nb, dir, prm,
      static_cast<const long long*>(probe),
      static_cast<const unsigned char*>(ok), P, vec, out_a, out_b,
      static_cast<unsigned char*>(unique));
  return static_cast<int>(cudaGetLastError());
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

// K11's directory scratch for 2^k buckets, in bytes: the search's
// parameters, then 2^k pairs of int32 bucket bounds
long long tt_sorted_dir_bytes(int k) {
  return DIR_PARAM_BYTES + 8LL * (1LL << k);
}

// K11, positions: out int64 (P) = the left (right = 0) or right insertion
// point of each probe value in the ascending int64 table `sorted` (nb).
// k: the directory's log2 bucket count (ops/join.directory_log2);
// scratch: tt_sorted_dir_bytes(k) bytes, 16-byte aligned, overwritten.
int tt_sorted_search(const void* sorted, long long nb, const void* probe,
                     long long P, int right, int k, void* scratch, void* out,
                     void* stream) {
  if (nb < 0 || nb >= (1LL << 31) || P < 0 || k < 0 ||
      k > DIR_MAX_LOG2 || !aligned16(scratch) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (P == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return right ? run_search<MODE_RIGHT>(sorted, nullptr, nb, probe, nullptr,
                                        P, k, scratch, out, nullptr, nullptr,
                                        st)
               : run_search<MODE_LEFT>(sorted, nullptr, nb, probe, nullptr,
                                       P, k, scratch, out, nullptr, nullptr,
                                       st);
}

// K11, unique join: sorted int64 build codes (nb >= 1, dead/NULL rows hold
// INT64_MAX) and their build row ids `order` int32 (nb); probe codes
// int64 (P) with ok bool (P). Outputs: match_idx int32 (P), matched bool
// (P), unique one bool (written here). k, scratch: as tt_sorted_search.
int tt_sorted_probe_unique(const void* sorted, const void* order,
                           long long nb, const void* probe, const void* ok,
                           long long P, int k, void* scratch,
                           void* match_idx, void* matched, void* unique,
                           void* stream) {
  if (nb < 1 || nb >= (1LL << 31) || P < 0 || k < 0 ||
      k > DIR_MAX_LOG2 || !aligned16(scratch) || !aligned16(match_idx) ||
      (reinterpret_cast<uintptr_t>(matched) & 3u) != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  return run_search<MODE_UNIQUE>(sorted, order, nb, probe, ok, P, k, scratch,
                                 match_idx, matched, unique,
                                 static_cast<cudaStream_t>(stream));
}

// K11, multi join: per probe row start = the left insertion point (int32)
// and count = right - left where ok, else 0. k, scratch: as
// tt_sorted_search.
int tt_sorted_probe_multi(const void* sorted, long long nb,
                          const void* probe, const void* ok, long long P,
                          int k, void* scratch, void* start, void* count,
                          void* stream) {
  if (nb < 0 || nb >= (1LL << 31) || P < 0 || k < 0 ||
      k > DIR_MAX_LOG2 || !aligned16(scratch) || !aligned16(start) ||
      !aligned16(count))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (P == 0) return 0;
  return run_search<MODE_MULTI>(sorted, nullptr, nb, probe, ok, P, k,
                                scratch, start, count, nullptr,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
