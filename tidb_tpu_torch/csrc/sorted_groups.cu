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
// (atomicMin) when n_groups > cap; empty slots hold n - 1. Each entry is
// one C call of two launches: a prep launch (rep filled, the scratch
// zeroed) and one pass. It has two entries:
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
//     tile: the count and a flag; zeroed by the prep launch). For
//     the DISTINCT pair factorize (cap >= n, K16's word) the same pass
//     also writes the first-occurrence mask `rep[gids] == iota` of
//     tidb_tpu/ops/factorize.py:219 (a byte set at each group's first
//     sorted row, in row order), and may then leave the ids out: their
//     scattered 4-byte store is most of the pass.
//   * gather (tt_group_ids), for sorts of two or more words. The value
//     fills the first word (a full-range BIGINT or a DOUBLE; a 63-bit
//     value shares it with its NULL flag), so the boundaries need the
//     value itself: it is gathered through the permutation once a row.
//     K8's sorted last word comes in beside the permutation and is read in
//     order: it always holds the dead flag, and the NULL flag (set: valid)
//     when the value fills the whole first word, so those are not
//     gathered; a mask that shares the value's word is gathered beside
//     the value. Each row takes its sorted neighbour's (flag, value) from
//     the previous lane by shuffle (lane 0 reads the row before its
//     warp's run), and the pass is the word entry's: tile ids from a
//     counter, warp-ballot ranks, look-back, the scattered ids and rep.
//     Without the word (tests and tools call it so) the same kernel
//     gathers the NULL mask and the live flag too.
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
// merges the scattered stores). Its gather entry reads the same 12 B in
// order and gathers the 8 B value a row through the permutation beside
// the same scattered store: one random load a row from an array L2 cannot
// hold (67 MB at 8,388,608 int64 rows), about 42 G such loads a second
// (~200 µs) on an H100 80GB HBM3 at 700 W.
// K11 reads each probe key and mask and writes its outputs; its directory
// (8 MB at 2,097,152 codes), the 16 MB of codes and the build row ids stay
// in the 50 MB L2. What limits it is the random loads a row makes (about
// 100 G random loads a second on the card): the directory pair, the
// bucket's one or two 16-byte pairs and, on a hit, the build row id.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WORD_ITEMS = 8;                      // rows per thread
constexpr int WORD_TILE = THREADS * WORD_ITEMS;    // 2048 rows a tile
constexpr long long SENTINEL = 0x7fffffffffffffffLL;
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long PREFIX = 2ull << 32;
typedef unsigned long long u64;

enum { DT_BOOL = 0, DT_I32 = 1, DT_I64 = 2, DT_F64 = 3 };

// ---- K10 -----------------------------------------------------------------

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

// before gid_words: the scratch (tile counter, status words) zeroed, rep
// (cap > 0) filled with `value` and, with FIRST, the first mask (n_first
// bytes from an 8-byte aligned address) zeroed
template <bool FIRST>
__global__ void __launch_bounds__(THREADS)
    words_prep(u64* __restrict__ scratch, long long words,
               int* __restrict__ rep, int cap, int value,
               unsigned char* __restrict__ first, long long n_first) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  const long long lo = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
  for (long long i = lo; i < words; i += step) scratch[i] = 0ull;
  for (long long i = lo; i < cap; i += step) rep[i] = value;
  if (FIRST) {
    const long long w8 = n_first >> 3;
    for (long long i = lo; i < w8; i += step)
      reinterpret_cast<u64*>(first)[i] = 0ull;
    if (lo < (n_first & 7)) first[(w8 << 3) + lo] = 0;
  }
}

// warp 0, once every warp's flag count is in warp_excl: the warps'
// exclusive offsets within the tile (left in warp_excl), the tile's status
// published and its exclusive prefix found by look-back (into *s_excl, by
// lane 0); the last tile writes n_groups (cap > 0). → the groups up to the
// end of this tile, on every lane
__device__ __forceinline__ int tile_prefix(int tile, int lane, long long n,
                                           int cap, int* warp_excl,
                                           int* s_excl, u64* status,
                                           int* __restrict__ n_groups) {
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
    *s_excl = excl;
    if (cap > 0 && tile == (n - 1) / WORD_TILE) *n_groups = excl + total;
  }
  return excl + total;
}

// row r's id from its sorted rank gid_s (unclamped for cap == 0, and no
// rep); a flagged row, its group's first sorted row and so its least,
// writes rep, the last slot by atomicMin over every group clamped into it
template <bool IDS>
__device__ __forceinline__ void scatter_row(int gid_s, int r, bool flag,
                                            int cap, int* __restrict__ gids,
                                            int* __restrict__ rep) {
  if (cap <= 0) {               // _dense1: unclamped dense codes
    gids[r] = gid_s;
    return;
  }
  if (IDS) gids[r] = gid_s < 0 ? 0 : (gid_s >= cap ? cap - 1 : gid_s);
  if (flag) {
    if (gid_s < cap - 1)
      rep[gid_s] = r;
    else
      atomicMin(&rep[cap - 1], r);
  }
}

// one launch: flags, warp-ballot ranks, look-back, scatter; with FIRST
// (cap >= n) also the first mask, and then IDS false leaves the ids out
template <bool FIRST, bool IDS>
__global__ void __launch_bounds__(THREADS)
    gid_words(const u64* __restrict__ w, const int* __restrict__ sidx,
              long long n, WordKey key, int cap,
              unsigned* __restrict__ tile_counter, u64* status,
              int* __restrict__ gids, int* __restrict__ rep,
              int* __restrict__ n_groups, unsigned char* __restrict__ first) {
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
    const int upto = tile_prefix(tile, lane, n, cap, warp_excl, &s_excl,
                                 status, n_groups);
    // no live row: every row's id clamps to slot 0, whose rep is n - 1,
    // so rep[pg] == iota holds at row n - 1 alone
    if (FIRST && lane == 0 && tile == (n - 1) / WORD_TILE && upto == 0)
      first[n - 1] = 1;
  }
  __syncthreads();
  const int base = s_excl + warp_excl[warp] - 1;
#pragma unroll
  for (int j = 0; j < WORD_ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    if (i >= n) continue;
    const bool flag = (flags >> j) & 1u;
    scatter_row<IDS>(base + rank[j], row[j], flag, cap, gids, rep);
    // cap >= n: no slot is shared, so rep[pg[r]] == r exactly here
    if (FIRST && flag) first[row[j]] = 1;
  }
}

struct GatherKey {
  const u64* w;                 // K8's sorted last word, or null
  const void* v;                // the values, in row order
  const unsigned char* m;       // the NULL mask (gathered), or null
  const unsigned char* live;    // gathered when w is null and cap > 0
  int dtype;
  int dead_shift;               // with w: the dead flag's bit
  int null_shift;               // with w: the NULL flag's bit (set: valid),
                                // -1 when the flag is not in w
};

// a row's value bits (a float64's as its int64 pattern), loaded
// evict-first: the values (67 MB at 8,388,608 int64 rows) are read once
// in a random order and would otherwise push the scattered ids' lines
// out of L2 before their sectors fill
__device__ __forceinline__ long long value_at(const void* v, int dtype,
                                              int r) {
  switch (dtype) {
    case DT_BOOL:
      return __ldcs(static_cast<const unsigned char*>(v) + r);
    case DT_I32:
      return __ldcs(static_cast<const int*>(v) + r);
    default:
      return __ldcs(static_cast<const long long*>(v) + r);
  }
}

// the dtype's own `!=` of two valid values: -0.0 meets +0.0, a NaN meets
// nothing
__device__ __forceinline__ bool values_differ(long long a, long long b,
                                              int dtype) {
  if (dtype == DT_F64)
    return __longlong_as_double(a) != __longlong_as_double(b);
  return a != b;
}

// the key of the row at sorted position i, row id r, word wd (WORD): its
// NULL flag (true: valid), dead flag and value (0 for a NULL, not loaded)
template <bool WORD>
__device__ __forceinline__ long long row_key(const GatherKey& key, int cap,
                                             int r, u64 wd, bool* valid,
                                             bool* dead) {
  bool ok = true, dd = false;
  if (WORD) {
    dd = ((wd >> key.dead_shift) & 1ull) != 0ull;
    if (key.null_shift >= 0)
      ok = ((wd >> key.null_shift) & 1ull) != 0ull;
    else if (key.m)
      ok = __ldg(key.m + r) != 0;
  } else {
    if (key.m) ok = __ldg(key.m + r) != 0;
    if (cap > 0 && key.live) dd = __ldg(key.live + r) == 0;
  }
  *valid = ok;
  *dead = dd;
  return ok ? value_at(key.v, key.dtype, r) : 0;
}

// the gather entry's one launch, in the word entry's form: row ids (and
// with WORD the sorted last word) read in order, the value (and what the
// word lacks) gathered once a row, the neighbour's key from the previous
// lane, warp-ballot ranks, look-back, scatter
template <bool WORD>
__global__ void __launch_bounds__(THREADS)
    gid_gather(const int* __restrict__ sidx, GatherKey key, long long n,
               int cap, unsigned* __restrict__ tile_counter, u64* status,
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
  const long long wbase = static_cast<long long>(tile) * WORD_TILE +
                          static_cast<long long>(warp) * (32 * WORD_ITEMS);
  int row[WORD_ITEMS];
  u64 wd[WORD_ITEMS];
#pragma unroll
  for (int j = 0; j < WORD_ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    row[j] = i < n ? __ldcs(sidx + i) : 0;
    wd[j] = WORD && i < n ? __ldcs(key.w + i) : 0ull;
  }
  long long val[WORD_ITEMS];
  unsigned valid = 0u, dead = 0u;       // bit j: round j's row
#pragma unroll
  for (int j = 0; j < WORD_ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    bool ok = false, dd = false;
    val[j] = i < n ? row_key<WORD>(key, cap, row[j], wd[j], &ok, &dd) : 0;
    valid |= (ok ? 1u : 0u) << j;
    dead |= (dd ? 1u : 0u) << j;
  }
  // the row before the warp's run (lane 0 of round 0)
  long long before = 0;
  bool before_ok = false;
  if (lane == 0 && wbase > 0 && wbase - 1 < n) {
    const int r = __ldg(sidx + wbase - 1);
    bool dd;
    before = row_key<WORD>(key, cap, r, WORD ? __ldg(key.w + wbase - 1)
                                             : 0ull, &before_ok, &dd);
  }
  const unsigned le = (2u << lane) - 1u;
  unsigned flags = 0u;
  int rank[WORD_ITEMS];
  int run = 0;
#pragma unroll
  for (int j = 0; j < WORD_ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    const bool ok = (valid >> j) & 1u;
    // the previous row's key: the lane before, or the last lane of the
    // round before
    long long pv = __shfl_up_sync(0xffffffffu, val[j], 1);
    bool pok = __shfl_up_sync(0xffffffffu, ok ? 1 : 0, 1) != 0;
    if (j > 0) {
      const long long lv = __shfl_sync(0xffffffffu, val[j - 1], 31);
      const int lo = __shfl_sync(0xffffffffu,
                                 static_cast<int>((valid >> (j - 1)) & 1u),
                                 31);
      if (lane == 0) {
        pv = lv;
        pok = lo != 0;
      }
    } else if (lane == 0) {
      pv = before;
      pok = before_ok;
    }
    bool b = i < n && (i == 0 || ok != pok ||
                       (ok && values_differ(val[j], pv, key.dtype)));
    if (cap > 0 && ((dead >> j) & 1u)) b = false;
    const unsigned bal = __ballot_sync(0xffffffffu, b);
    rank[j] = run + __popc(bal & le);      // inclusive
    run += __popc(bal);
    flags |= (b ? 1u : 0u) << j;
  }
  if (lane == 0) warp_excl[warp] = run;
  __syncthreads();
  if (warp == 0)
    tile_prefix(tile, lane, n, cap, warp_excl, &s_excl, status, n_groups);
  __syncthreads();
  const int base = s_excl + warp_excl[warp] - 1;
#pragma unroll
  for (int j = 0; j < WORD_ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    if (i < n)
      scatter_row<true>(base + rank[j], row[j], (flags >> j) & 1u, cap,
                        gids, rep);
  }
}

// the prep launch of both K10 entries: the scratch (tile counter and
// status words) zeroed, rep (cap > 0) filled with max(n - 1, 0) and, with
// `first`, the first mask zeroed
void launch_prep(u64* words, long long n_tiles, int* rep, int cap,
                 long long n, unsigned char* first, cudaStream_t st) {
  long long most = (1 + n_tiles) > cap ? 1 + n_tiles : cap;
  if (first && (n >> 3) + 8 > most) most = (n >> 3) + 8;
  const long long pb = (most + THREADS - 1) / THREADS;
  const unsigned blocks = static_cast<unsigned>(pb < 264 ? pb : 264);
  const int value = n > 0 ? static_cast<int>(n - 1) : 0;
  if (first)
    words_prep<true><<<blocks, THREADS, 0, st>>>(words, 1 + n_tiles, rep,
                                                 cap, value, first, n);
  else
    words_prep<false><<<blocks, THREADS, 0, st>>>(words, 1 + n_tiles, rep,
                                                  cap, value, nullptr, 0);
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

// K10, gather. sidx: int32 (n), the stable sort permutation of
// _key_operands([(v, m)], live) (ops/factorize.py); w: uint64 (n), that
// sort's last radix word in sorted order (K8's output), or null;
// dead_shift: the dead flag's bit in w; null_shift: the NULL flag's bit in
// w (set: valid), or -1 when w does not hold it. v: n values of `dtype` (0
// bool, 1 int32, 2 int64, 3 float64) in row order; m: bool (n) or null (no
// NULLs), read unless w holds the NULL flag; live: bool (n) or null (every
// row live), read when cap > 0 and w is null. cap > 0 (factorize): gids
// int32 (n) clamped to [0, cap), rep int32 (cap), filled here with
// max(n - 1, 0) first, n_groups one int32. cap == 0 (_dense1): gids only,
// unclamped. Scratch: int64 (tt_group_words_scratch(n)), zeroed here (the
// prep launch does both).
int tt_group_ids(const void* sidx, const void* w, int dead_shift,
                 int null_shift, const void* v, int dtype, const void* m,
                 const void* live, long long n, int cap, void* gids,
                 void* rep, void* n_groups, void* scratch, void* stream) {
  if (n < 0 || n >= (1LL << 31) || cap < 0 || dtype < DT_BOOL ||
      dtype > DT_F64 ||
      (w && (dead_shift < 0 || dead_shift > 63 || null_shift < -1 ||
             null_shift > 63)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ng = static_cast<int*>(n_groups);
  const long long n_tiles = (n + WORD_TILE - 1) / WORD_TILE;
  u64* words = static_cast<u64*>(scratch);
  launch_prep(words, n_tiles, static_cast<int*>(rep), cap, n, nullptr, st);
  if (n == 0) {
    if (ng && cap > 0) cudaMemsetAsync(ng, 0, sizeof(int), st);
    return static_cast<int>(cudaGetLastError());
  }
  GatherKey key{static_cast<const u64*>(w), v,
                static_cast<const unsigned char*>(m),
                static_cast<const unsigned char*>(live), dtype, dead_shift,
                null_shift};
  auto kernel = w ? gid_gather<true> : gid_gather<false>;
  kernel<<<static_cast<unsigned>(n_tiles), THREADS, 0, st>>>(
      static_cast<const int*>(sidx), key, n, cap,
      reinterpret_cast<unsigned*>(words), words + 1, static_cast<int*>(gids),
      static_cast<int*>(rep), ng);
  return static_cast<int>(cudaGetLastError());
}

// K10, words: w uint64 (n), the sort's one radix word in sorted order
// (K8's output); sidx int32 (n), its row ids. A boundary is i == 0, a
// change of (w[i] ^ w[i-1]) & cmp_mask, or (has_nan) w[i] & nan_mask ==
// nan_val; cap > 0 masks it by the live flag, bit dead_shift of w clear.
// Outputs and scratch as tt_group_ids (rep filled and the scratch zeroed
// here by the one prep launch). With cap >= n, `first` (null: not asked
// for; n bool, 8-byte aligned) is the first-occurrence mask
// rep[gids] == iota of every row, zeroed here and set where a group's
// first sorted row is (row n - 1 when no row is live); with `first`,
// gids may be null (not written).
int tt_group_ids_words(const void* w, const void* sidx, long long n,
                       unsigned long long cmp_mask, int has_nan,
                       unsigned long long nan_mask,
                       unsigned long long nan_val, int dead_shift, int cap,
                       void* gids, void* rep, void* n_groups, void* first,
                       void* scratch, void* stream) {
  if (n < 0 || n >= (1LL << 31) || cap < 0 || dead_shift < 0 ||
      dead_shift > 63 ||
      (first && (cap < n || cap == 0 ||
                 (reinterpret_cast<uintptr_t>(first) & 7))) ||
      (!gids && !first))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ng = static_cast<int*>(n_groups);
  const long long n_tiles = (n + WORD_TILE - 1) / WORD_TILE;
  u64* words = static_cast<u64*>(scratch);
  unsigned char* fm = static_cast<unsigned char*>(first);
  launch_prep(words, n_tiles, static_cast<int*>(rep), cap, n, fm, st);
  if (n == 0) {
    if (ng && cap > 0) cudaMemsetAsync(ng, 0, sizeof(int), st);
    return static_cast<int>(cudaGetLastError());
  }
  WordKey key{cmp_mask, nan_mask, nan_val, has_nan, dead_shift};
  auto kernel = !fm ? gid_words<false, true>
                    : (gids ? gid_words<true, true> : gid_words<true, false>);
  kernel<<<static_cast<unsigned>(n_tiles), THREADS, 0, st>>>(
      static_cast<const u64*>(w), static_cast<const int*>(sidx), n, key, cap,
      reinterpret_cast<unsigned*>(words), words + 1, static_cast<int*>(gids),
      static_cast<int*>(rep), ng, fm);
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
