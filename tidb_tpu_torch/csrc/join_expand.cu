// K6 lut_order and K7 join_expand — the expand half of the LUT join.
//
// K6 replaces the build-side sort of tidb_tpu/ops/join.py
// lut_probe_multi (`lax.sort((code, iota), num_keys=1)`, a stable sort of
// the build row ids by their packed code) and its exclusive `starts`
// cumsum. Its result equals the stable sort's element for element: row
// ids grouped by ascending code, ascending within a code, and the rows of
// the sentinel code `domain` (NULL, out-of-domain or dead) last, in
// ascending order.
//
// K7 replaces tidb_tpu/ops/join.py expand: per-probe output counts
// (max(count, 1) for outer joins, 0 for dead probe rows), their inclusive
// scan and the true total, then for every output slot its probe row p,
// k, b_idx = order[clip(start[p] + k)], matched and out_live. This takes
// the place of JAX's scatter-max plus cummax. Live slots and the total
// equal the JAX function's; dead slots carry p_idx 0, k 0, b_idx 0.
// What bounds them on an H100: bytes. K6 reads the build codes and the
// count table and writes the order and the starts; K7 reads start, count
// and the live mask once per probe row and writes 14 B per output slot
// plus the order gathers. At the main path's shapes (262,144 probe rows,
// 65,536 slots: ~3 MB) both are far below a launch's own cost, so what K7
// pays is launches and host work, and its design cuts those.
//
// K6's scans are three passes: block totals (cub::BlockReduce), one
// block scanning the totals with a running carry, and a pass that
// re-reads each block, scans it (cub::BlockScan) and applies the carry.
// K6: (1) exclusive scan of the counts gives the starts; (2) the sentinel
// rows, usually most of a filtered build, are placed by a scan of their
// flags, so they land in ascending order without atomics on one slot;
// (3) every row of a short run takes a slot of its code through an
// atomicAdd cursor, then one thread per code insertion-sorts its run
// (primary-key runs have length 1 and cost nothing); (4) a run longer
// than `long_run` is placed by one block that scans all build rows for
// its code in row order, so its rows arrive sorted and no thread sorts a
// long run. Heavily skewed builds pay O(nb) per long code: right, and
// slow, which a sort kernel of a later change can fix.
//
// K7 is one launch, `expand_onepass`, whose blocks take tile ids from an
// atomic counter in the per-stream scratch (zeroed with the look-back
// flags and the marks by one memset a call):
//   * ids [0, Tp) are probe tiles of 2,048 rows: each computes its rows'
//     output counts, scans them (warp scans, then the 8 warp totals),
//     takes its prefix by decoupled look-back (lookback.cuh), and for
//     every row with slots writes a mark, row + 1, at its first slot,
//     and names the row first row of each slot tile whose first slot it
//     holds (with that row's first slot); then it adds one to a
//     completion count. The last probe tile writes the total first;
//   * ids [Tp, Tp + Ts) are slot tiles of 2,048 output slots. Every probe
//     tile took its id before any slot tile, and no probe tile waits on a
//     slot tile, so a slot tile may wait for the completion count to reach
//     Tp. Then each slot's row is the last mark at or before it (a
//     max-scan of (row, slot) keys over the tile's marks in slot order:
//     rows and their first slots rise together), or the tile's first row
//     where no mark precedes it. No slot searches `cum`: the marks are
//     read once, 8 KB a tile, whatever the counts of the rows between.
//     Slots at or past the total are written dead in the same pass.
// Threads are assigned to output slots, never to probe rows, so one probe
// row with a million matches is spread over ~500 slot tiles (its thread
// writes ~500 first-row entries, one a tile). A slot tile's stores are
// coalesced: slot q·256 + t of a tile is thread t's q-th.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_T = 1024;     // one element per thread per scan tile

// ---- inputs and outputs of the three-pass scan ---------------------------

struct CntIn {                   // K6 (1): the count table
  const int* cnt;
  __device__ int operator()(long long i) const { return cnt[i]; }
};

struct SentIn {                  // K6 (2): 1 for a sentinel row
  const int* codes;
  int domain;
  __device__ int operator()(long long i) const {
    return codes[i] == domain ? 1 : 0;
  }
};

struct StartsOut {
  int* starts;
  __device__ void operator()(long long i, int ex, int) const {
    starts[i] = ex;
  }
};

struct SentOut {
  int* order;
  const int* starts;
  int domain;
  __device__ void operator()(long long i, int ex, int flag) const {
    if (flag) order[starts[domain] + ex] = static_cast<int>(i);
  }
};

template <class In, typename T>
__global__ void __launch_bounds__(SCAN_T)
    scan_totals(In in, long long n, T* __restrict__ totals) {
  typedef cub::BlockReduce<T, SCAN_T> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const long long i = static_cast<long long>(blockIdx.x) * SCAN_T +
                      threadIdx.x;
  const T v = i < n ? in(i) : T(0);
  const T s = Reduce(tmp).Sum(v);
  if (threadIdx.x == 0) totals[blockIdx.x] = s;
}

// in place: totals[b] ← the sum of totals[0..b)
template <typename T>
__global__ void __launch_bounds__(SCAN_T)
    scan_carries(T* __restrict__ totals, long long nblocks) {
  typedef cub::BlockScan<T, SCAN_T> Scan;
  __shared__ typename Scan::TempStorage tmp;
  T carry = 0;
  for (long long base = 0; base < nblocks; base += SCAN_T) {
    const long long i = base + threadIdx.x;
    const T v = i < nblocks ? totals[i] : T(0);
    T ex, agg;
    Scan(tmp).ExclusiveSum(v, ex, agg);
    if (i < nblocks) totals[i] = carry + ex;
    carry += agg;
    __syncthreads();
  }
}

template <class In, class Out, typename T>
__global__ void __launch_bounds__(SCAN_T)
    scan_apply(In in, Out out, long long n, const T* __restrict__ carries) {
  typedef cub::BlockScan<T, SCAN_T> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long i = static_cast<long long>(blockIdx.x) * SCAN_T +
                      threadIdx.x;
  const T v = i < n ? in(i) : T(0);
  T ex;
  Scan(tmp).ExclusiveSum(v, ex);
  if (i < n) out(i, carries[blockIdx.x] + ex, v);
}

template <class In, class Out, typename T>
void scan3(In in, Out out, long long n, T* scratch, cudaStream_t st) {
  if (n <= 0) return;
  const long long nblocks = (n + SCAN_T - 1) / SCAN_T;
  scan_totals<In, T><<<static_cast<unsigned>(nblocks), SCAN_T, 0, st>>>(
      in, n, scratch);
  scan_carries<T><<<1, SCAN_T, 0, st>>>(scratch, nblocks);
  scan_apply<In, Out, T><<<static_cast<unsigned>(nblocks), SCAN_T, 0, st>>>(
      in, out, n, scratch);
}

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 16) b = 132 * 16;
  return b < 1 ? 1 : static_cast<int>(b);
}

// ---- K6 ------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    place_rows(const int* __restrict__ codes, long long nb, int domain,
               const int* __restrict__ cnt, const int* __restrict__ starts,
               int* __restrict__ cursor, int* __restrict__ order,
               int long_run) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < nb; i += step) {
    const int c = codes[i];
    if (c >= domain || cnt[c] > long_run) continue;
    order[starts[c] + atomicAdd(&cursor[c], 1)] = static_cast<int>(i);
  }
}

__global__ void __launch_bounds__(THREADS)
    sort_runs(const int* __restrict__ cnt, const int* __restrict__ starts,
              int domain, int long_run, int* __restrict__ order,
              int* __restrict__ long_list) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < domain; c += step) {
    const int len = cnt[c];
    if (len < 2) continue;
    if (len > long_run) {
      // long_list[0] is the count of long codes, the codes follow
      long_list[1 + atomicAdd(&long_list[0], 1)] = static_cast<int>(c);
      continue;
    }
    int* run = order + starts[c];
    for (int a = 1; a < len; ++a) {
      const int v = run[a];
      int b = a - 1;
      while (b >= 0 && run[b] > v) {
        run[b + 1] = run[b];
        --b;
      }
      run[b + 1] = v;
    }
  }
}

__global__ void __launch_bounds__(SCAN_T)
    place_long_runs(const int* __restrict__ codes, long long nb,
                    const int* __restrict__ starts,
                    const int* __restrict__ long_list,
                    int* __restrict__ order) {
  if (static_cast<int>(blockIdx.x) >= long_list[0]) return;
  typedef cub::BlockScan<int, SCAN_T> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const int c = long_list[1 + blockIdx.x];
  const int base = starts[c];
  int carry = 0;
  for (long long t = 0; t < nb; t += SCAN_T) {
    const long long i = t + threadIdx.x;
    const int flag = (i < nb && codes[i] == c) ? 1 : 0;
    int ex, agg;
    Scan(tmp).ExclusiveSum(flag, ex, agg);
    if (flag) order[base + carry + ex] = static_cast<int>(i);
    carry += agg;
    __syncthreads();
  }
}

// ---- K7 ------------------------------------------------------------------

constexpr int EX_THREADS = 256;
constexpr int EX_WARPS = EX_THREADS / 32;
constexpr int EX_IPT = 8;                          // rows or slots a thread
constexpr int EX_TILE = EX_THREADS * EX_IPT;       // 2,048 a tile

struct ExpandArgs {
  const int* start;
  const int* count;
  const int* order;
  const unsigned char* live;
  long long P, nb, out_cap;
  int outer, probe_tiles;
  int* p_idx;
  int* b_idx;
  int* k;
  unsigned char* matched;
  unsigned char* out_live;
  long long* total;
  unsigned* counter;       // tile ids
  unsigned* done;          // probe tiles whose marks are out
  lookback::Status st;
  int* marks;              // p + 1 at the first slot of row p, else 0
  int* first_row;          // the row holding slot tile s's first slot
  long long* first_begin;  // that row's first slot
};

// Scratch layout for P probe rows and out_cap slots (ops/join.py
// expand_scratch_bytes mirrors it): the zeroed part, 16 bytes (counter,
// done), a look-back flag a probe tile and a mark a slot, each rounded
// up to 16 bytes; then the probe tiles' aggregates and inclusive
// prefixes and each slot tile's first row's first slot, 8 bytes each,
// and its first row, 4 bytes.
long long expand_tiles(long long P) {
  const long long t = (P + EX_TILE - 1) / EX_TILE;
  return t < 1 ? 1 : t;
}

long long slot_tiles(long long out_cap) {
  return (out_cap + EX_TILE - 1) / EX_TILE;
}

long long round16(long long b) { return (b + 15) / 16 * 16; }

long long expand_zeroed(long long P, long long out_cap) {
  return 16 + round16(4 * expand_tiles(P)) + round16(4 * out_cap);
}

long long expand_scratch(long long P, long long out_cap) {
  return expand_zeroed(P, out_cap) + 16 * expand_tiles(P) +
         12 * slot_tiles(out_cap);
}

__device__ void expand_probe_tile(const ExpandArgs& a, int tile,
                                  long long* s_warp, long long* s_pre) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wbase = static_cast<long long>(tile) * EX_TILE +
                          warp * (32 * EX_IPT) + lane;
  int oc[EX_IPT];
  long long it[EX_IPT];
#pragma unroll
  for (int q = 0; q < EX_IPT; ++q) {
    const long long p = wbase + q * 32;
    oc[q] = 0;
    if (p < a.P && a.live[p]) {
      const int c = a.count[p];
      oc[q] = a.outer && c < 1 ? 1 : c;
    }
    it[q] = oc[q];
  }
  // the 32 rows of every load scanned at once, then chained in row order
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int q = 0; q < EX_IPT; ++q) {
      const long long y = __shfl_up_sync(lookback::FULL, it[q], d);
      if (lane >= d) it[q] += y;
    }
  }
  long long carry = 0;
#pragma unroll
  for (int q = 0; q < EX_IPT; ++q) {
    const long long tot = __shfl_sync(lookback::FULL, it[q], 31);
    it[q] += carry;
    carry += tot;
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    long long v = lane < EX_WARPS ? s_warp[lane] : 0;
    v = lookback::warp_inclusive(v, lane);
    const long long agg = __shfl_sync(lookback::FULL, v, EX_WARPS - 1);
    const long long ex = v - (lane < EX_WARPS ? s_warp[lane] : 0);
    __syncwarp();
    if (lane < EX_WARPS) s_warp[lane] = ex;
    const long long pre = lookback::tile_prefix(a.st, 0, tile, agg, lane);
    if (lane == 0) {
      *s_pre = pre;
      if (tile == a.probe_tiles - 1) *a.total = pre + agg;
    }
  }
  __syncthreads();
  const long long pre = *s_pre + s_warp[warp];
  // a row with slots marks its first slot, and names itself the first
  // row of every slot tile whose first slot it holds
#pragma unroll
  for (int q = 0; q < EX_IPT; ++q) {
    if (oc[q] == 0) continue;
    const long long p = wbase + q * 32;
    const long long end = pre + it[q];
    const long long begin = end - oc[q];
    if (begin >= a.out_cap) continue;
    a.marks[begin] = static_cast<int>(p) + 1;
    const long long last = end < a.out_cap ? end : a.out_cap;
    for (long long b = (begin + EX_TILE - 1) / EX_TILE * EX_TILE; b < last;
         b += EX_TILE) {
      a.first_row[b / EX_TILE] = static_cast<int>(p);
      a.first_begin[b / EX_TILE] = begin;
    }
  }
  // every mark (and the total) out before the count
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(a.done, 1u);
}

// slot j of slot tile s is s·2048 + q·256 + warp·32 + lane (q < 8): a
// warp's store covers 32 consecutive slots
__device__ void expand_slot_tile(const ExpandArgs& a, long long s,
                                 unsigned long long* s_tot,
                                 long long* s_misc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s0 = s * EX_TILE;
  if (threadIdx.x == 0) {
    while (lookback::load_acquire(a.done) <
           static_cast<unsigned>(a.probe_tiles))
      __nanosleep(64);
    s_misc[0] = lookback::load_relaxed(a.total);
  }
  __syncthreads();
  const long long total = s_misc[0];
  const long long s1 = s0 + EX_TILE < a.out_cap ? s0 + EX_TILE : a.out_cap;
  const long long lend = s1 < total ? s1 : total;    // live slots [s0, lend)
  if (s0 >= lend) {                                  // a dead tile
#pragma unroll
    for (int q = 0; q < EX_IPT; ++q) {
      const long long j = s0 + q * EX_THREADS + threadIdx.x;
      if (j >= s1) continue;
      a.p_idx[j] = 0;
      a.k[j] = 0;
      a.b_idx[j] = 0;
      a.matched[j] = 0;
      a.out_live[j] = 0;
    }
    return;
  }
  // each slot's (row + 1, offset in the tile) of the last mark at or
  // before it: a max-scan in slot order (rows and their first slots rise
  // together); 0 where the tile's first row continues
  unsigned long long key[EX_IPT];
#pragma unroll
  for (int q = 0; q < EX_IPT; ++q) {
    const long long j = s0 + q * EX_THREADS + threadIdx.x;
    const int m = j < lend ? __ldcg(a.marks + j) : 0;
    key[q] = m ? (static_cast<unsigned long long>(m) << 32) |
                     static_cast<unsigned>(j - s0)
               : 0ull;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int q = 0; q < EX_IPT; ++q) {
      const unsigned long long y = __shfl_up_sync(lookback::FULL, key[q], d);
      if (lane >= d && y > key[q]) key[q] = y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < EX_IPT; ++q) s_tot[q * EX_WARPS + warp] = key[q];
  }
  __syncthreads();
  if (warp == 0) {
    // the 64 warp maxima in slot order, two a lane: exclusive max-scan
    const unsigned long long t0 = s_tot[2 * lane], t1 = s_tot[2 * lane + 1];
    unsigned long long v = t0 > t1 ? t0 : t1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(lookback::FULL, v, d);
      if (lane >= d && y > v) v = y;
    }
    unsigned long long ex = __shfl_up_sync(lookback::FULL, v, 1);
    if (lane == 0) ex = 0;
    s_tot[2 * lane] = ex;
    s_tot[2 * lane + 1] = ex > t0 ? ex : t0;
    if (lane == 0) {
      s_misc[1] = __ldcg(a.first_row + s);
      s_misc[2] = __ldcg(a.first_begin + s);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < EX_IPT; ++q) {
    const long long j = s0 + q * EX_THREADS + threadIdx.x;
    if (j >= s1) continue;
    if (j >= lend) {
      a.p_idx[j] = 0;
      a.k[j] = 0;
      a.b_idx[j] = 0;
      a.matched[j] = 0;
      a.out_live[j] = 0;
      continue;
    }
    const unsigned long long before = s_tot[q * EX_WARPS + warp];
    const unsigned long long kq = key[q] > before ? key[q] : before;
    const long long p = kq ? static_cast<long long>(kq >> 32) - 1
                           : s_misc[1];
    const long long begin = kq ? s0 + static_cast<long long>(kq & 0xffffffffu)
                               : s_misc[2];
    const long long kk = j - begin;
    long long pos = static_cast<long long>(a.start[p]) + kk;
    pos = pos < 0 ? 0 : (pos >= a.nb ? a.nb - 1 : pos);
    a.p_idx[j] = static_cast<int>(p);
    a.k[j] = static_cast<int>(kk);
    a.b_idx[j] = a.order[pos];
    a.matched[j] = kk < a.count[p] ? 1 : 0;
    a.out_live[j] = 1;
  }
}

__global__ void __launch_bounds__(EX_THREADS)
    expand_onepass(const __grid_constant__ ExpandArgs a) {
  __shared__ unsigned long long s_tot[EX_IPT * EX_WARPS];
  __shared__ long long s_misc[3];
  __shared__ unsigned s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(a.counter, 1u);
  __syncthreads();
  const unsigned tile = s_tile;
  if (tile < static_cast<unsigned>(a.probe_tiles))
    expand_probe_tile(a, static_cast<int>(tile),
                      reinterpret_cast<long long*>(s_tot), s_misc);
  else
    expand_slot_tile(a, tile - static_cast<unsigned>(a.probe_tiles), s_tot,
                     s_misc);
}

}  // namespace

extern "C" {

// K6. codes: int32 (nb), a code in [0, domain] per build row (domain =
// sentinel); cnt: int32 (domain + 1) from K4. Outputs: starts int32
// (domain + 1), order int32 (nb). Scratch from the caller: cursor int32
// (domain + 1) zeroed; long_list int32 (1 + nb / (long_run + 1)) with
// long_list[0] zeroed; block int32 (ceil(max(domain + 1, nb) / 1024)).
int tt_lut_order(const void* codes, const void* cnt, long long nb,
                 long long domain, int long_run, void* starts, void* order,
                 void* cursor, void* long_list, void* block, void* stream) {
  if (domain < 1 || domain >= (1LL << 31) - 1 || nb < 0 || long_run < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cd = static_cast<const int*>(codes);
  const int* ct = static_cast<const int*>(cnt);
  int* sts = static_cast<int*>(starts);
  int* ord = static_cast<int*>(order);
  int* blk = static_cast<int*>(block);
  const int dom = static_cast<int>(domain);
  scan3<CntIn, StartsOut, int>(CntIn{ct}, StartsOut{sts}, domain + 1, blk,
                               st);
  if (nb > 0) {
    scan3<SentIn, SentOut, int>(SentIn{cd, dom}, SentOut{ord, sts, dom}, nb,
                                blk, st);
    place_rows<<<grid_for(nb), THREADS, 0, st>>>(
        cd, nb, dom, ct, sts, static_cast<int*>(cursor), ord, long_run);
    sort_runs<<<grid_for(domain), THREADS, 0, st>>>(
        ct, sts, dom, long_run, ord, static_cast<int*>(long_list));
    const long long max_long = nb / (static_cast<long long>(long_run) + 1) + 1;
    place_long_runs<<<static_cast<unsigned>(max_long), SCAN_T, 0, st>>>(
        cd, nb, sts, static_cast<const int*>(long_list), ord);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7. start, count: int32 (P); order: int32 (nb, nb >= 1); live: bool
// (P). Outputs of out_cap slots: p_idx, b_idx, k int32, matched, out_live
// bool; total: one int64. scratch: `scratch_bytes` bytes of the stream's
// scratch (at least tt_join_expand_scratch_bytes(P, out_cap)). One
// memset of its zeroed part and one launch.
int tt_join_expand(const void* start, const void* count, const void* order,
                   const void* live, long long P, long long nb, int outer,
                   long long out_cap, void* p_idx, void* b_idx, void* k,
                   void* matched, void* out_live, void* total, void* scratch,
                   long long scratch_bytes, void* stream) {
  if (P < 0 || P >= (1LL << 31) || nb < 1 || out_cap < 0 ||
      out_cap >= (1LL << 31) || scratch_bytes < expand_scratch(P, out_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tp = expand_tiles(P);
  const long long ts = slot_tiles(out_cap);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const long long z = expand_zeroed(P, out_cap);
  ExpandArgs a;
  a.start = static_cast<const int*>(start);
  a.count = static_cast<const int*>(count);
  a.order = static_cast<const int*>(order);
  a.live = static_cast<const unsigned char*>(live);
  a.P = P;
  a.nb = nb;
  a.out_cap = out_cap;
  a.outer = outer;
  a.probe_tiles = static_cast<int>(tp);
  a.p_idx = static_cast<int*>(p_idx);
  a.b_idx = static_cast<int*>(b_idx);
  a.k = static_cast<int*>(k);
  a.matched = static_cast<unsigned char*>(matched);
  a.out_live = static_cast<unsigned char*>(out_live);
  a.total = static_cast<long long*>(total);
  a.counter = reinterpret_cast<unsigned*>(sc);
  a.done = reinterpret_cast<unsigned*>(sc + 4);
  a.st.flags = reinterpret_cast<unsigned*>(sc + 16);
  a.marks = reinterpret_cast<int*>(sc + 16 + round16(4 * tp));
  a.st.agg = reinterpret_cast<long long*>(sc + z);
  a.st.incl = a.st.agg + tp;
  a.first_begin = a.st.incl + tp;
  a.first_row = reinterpret_cast<int*>(a.first_begin + ts);
  cudaMemsetAsync(sc, 0, z, st);
  expand_onepass<<<static_cast<unsigned>(tp + ts), EX_THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

long long tt_join_expand_scratch_bytes(long long P, long long out_cap) {
  return expand_scratch(P, out_cap);
}

}  // extern "C"
