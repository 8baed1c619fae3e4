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
// n - 1 first.
//
// K11 replaces the searchsorted of tidb_tpu/ops/join.py
// sorted_probe_unique / sorted_probe_multi and of the device IN list
// (tidb_tpu/expression/__init__.py:1333): one thread per probe row runs a
// lower-bound (and for multi an upper-bound) binary search into the
// sorted build codes, then the hit test and the gather of the build row
// id. Unique mode also flags equal non-sentinel neighbours in the sorted
// codes (one write per block that finds any).
//
// What bounds them on an H100: bytes. K10 reads the permutation, the
// key at each sorted position and at its neighbour (both gathers through
// the permutation; the neighbour's is usually in L1/L2 already) and the
// live mask, and writes the gids, in a three-pass scan (as K2/K6: block
// totals, one block scanning them, a re-read that applies the carry).
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
constexpr long long SENTINEL = 0x7fffffffffffffffLL;

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

// K10. sidx: int32 (n), the stable sort permutation; v: n values of
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
