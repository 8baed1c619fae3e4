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
// scan and the true total, then one thread per output slot that finds its
// probe row by binary search in the scan and writes p_idx, k, b_idx =
// order[clip(start[p] + k)], matched and out_live. This takes the place
// of JAX's scatter-max plus cummax. Live slots and the total equal the
// JAX function's; on dead slots the indices are 0.
//
// What bounds them on an H100: bytes. K6 reads the build codes and the
// count table and writes the order and the starts; K7 reads start, count
// and the live mask once per probe row and writes 14 B per output slot
// plus the order gathers.
//
// Design. Scans are three passes as in K2: block totals (cub::BlockReduce),
// one block scanning the totals with a running carry, and a pass that
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
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

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

struct OcIn {                    // K7: output slots per probe row
  const int* count;
  const unsigned char* live;
  int outer;
  __device__ long long operator()(long long p) const {
    if (!live[p]) return 0;
    const int c = count[p];
    return static_cast<long long>(outer && c < 1 ? 1 : c);
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

struct CumOut {
  long long* cum;
  __device__ void operator()(long long i, long long ex, long long v) const {
    cum[i] = ex + v;
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

__global__ void write_total(const long long* __restrict__ cum, long long P,
                            long long* __restrict__ total) {
  *total = P > 0 ? cum[P - 1] : 0;
}

__global__ void __launch_bounds__(THREADS)
    expand_slots(const long long* __restrict__ cum,
                 const int* __restrict__ start,
                 const int* __restrict__ count,
                 const int* __restrict__ order, long long P, long long nb,
                 long long out_cap, int* __restrict__ p_idx,
                 int* __restrict__ b_idx, int* __restrict__ k_out,
                 unsigned char* __restrict__ matched,
                 unsigned char* __restrict__ out_live) {
  const long long total = P > 0 ? cum[P - 1] : 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < out_cap; j += step) {
    if (j >= total) {
      p_idx[j] = 0;
      k_out[j] = 0;
      b_idx[j] = order[0];
      matched[j] = 0;
      out_live[j] = 0;
      continue;
    }
    // the first probe row whose inclusive end passes slot j
    long long lo = 0, hi = P - 1;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (cum[mid] > j)
        hi = mid;
      else
        lo = mid + 1;
    }
    const long long p = lo;
    const int c = count[p];
    const long long k = j - (p > 0 ? cum[p - 1] : 0);
    long long pos = static_cast<long long>(start[p]) + k;
    pos = pos < 0 ? 0 : (pos >= nb ? nb - 1 : pos);
    p_idx[j] = static_cast<int>(p);
    k_out[j] = static_cast<int>(k);
    b_idx[j] = order[pos];
    matched[j] = k < c ? 1 : 0;
    out_live[j] = 1;
  }
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
// bool; total: one int64. Scratch from the caller: cum int64 (P), block
// int64 (ceil(P / 1024)).
int tt_join_expand(const void* start, const void* count, const void* order,
                   const void* live, long long P, long long nb, int outer,
                   long long out_cap, void* cum, void* block, void* p_idx,
                   void* b_idx, void* k, void* matched, void* out_live,
                   void* total, void* stream) {
  if (P < 0 || nb < 1 || out_cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* cm = static_cast<long long*>(cum);
  scan3<OcIn, CumOut, long long>(
      OcIn{static_cast<const int*>(count),
           static_cast<const unsigned char*>(live), outer},
      CumOut{cm}, P, static_cast<long long*>(block), st);
  write_total<<<1, 1, 0, st>>>(cm, P, static_cast<long long*>(total));
  if (out_cap > 0)
    expand_slots<<<grid_for(out_cap), THREADS, 0, st>>>(
        cm, static_cast<const int*>(start), static_cast<const int*>(count),
        static_cast<const int*>(order), P, nb, out_cap,
        static_cast<int*>(p_idx), static_cast<int*>(b_idx),
        static_cast<int*>(k), static_cast<unsigned char*>(matched),
        static_cast<unsigned char*>(out_live));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
