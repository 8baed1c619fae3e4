// K12 window_bounds and K13 window_scan — the row-scale scans of the
// window functions, after the sort.
//
// K12 replaces the boundary flags of tidb_tpu/executor/device_emit.py
// emit_window_cols (the `flags` closure) and the position helpers of
// tidb_tpu/ops/window.py: _cummax/_pstart_pos (a lax.associative_scan of
// max), partition_ids, and _partition_last / _next_peerstart_pos /
// _partition_rows, which the JAX package computes with segment_max /
// segment_count over n segments and a gather back. Entry `flags`
// compares each sorted row with its sorted neighbour (both read through
// the permutation) key by key in the key's own type, as the reference's
// `!=` does: -0.0 equals +0.0, a NaN starts a new peer group, NULL slots
// are neutralized, and a change of `live` starts a partition (the dead
// tail of a filtered slab is a partition of its own). Entry `positions`
// is two scans: a forward one of (max start index, max peer start index,
// count of peer starts) gives ppos, peer_lo and the dense-rank count; a
// backward one of (min partition end, min peer end) gives plast and
// peer_hi. Positions are exact integers: they equal the reference's.
//
// K13 replaces the whole-column cumsums of running_agg, rows_frame_agg and
// range_frame_agg (masked value and valid count, int64 or float64) and
// _segmented_scan, the reference's Hillis-Steele min/max scan of log2(n)
// passes of gathers (23 at 8,388,608 rows), forward, or backward for the
// [lo, partition end] suffix frames.
//
// What bounds them on an H100: bytes. Each scan here is one three-pass
// tile scan (as K2/K6/K10: tile aggregates, one block scanning them, a
// re-read that applies the carry), so a row is read twice and written
// once; K12's flags read the permutation, and each key and mask at the
// row and at its neighbour through it (gathers; the neighbour's line is
// usually in L1/L2 already). The tile scan keeps the reference's
// prefix-difference formulation: an int64 prefix wraps as numpy's does,
// so window sums over it stay exact. A float64 prefix adds in tile-tree
// order, not numpy's sequential order: its last bits differ, within
// (n-1)·eps·Σ|x| of the sequential sum.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int THREADS = 256;
constexpr int IPT = 8;
constexpr int TILE = THREADS * IPT;
constexpr int CARRY_T = 1024;
constexpr int MAX_KEYS = 8;
constexpr long long NONE = 0x7fffffffffffffffLL;

enum { DT_BOOL = 0, DT_I32 = 1, DT_I64 = 2, DT_F64 = 3 };

// ---- the three-pass tile scan --------------------------------------------
//
// A policy P supplies T, identity(), op(a, b) (a precedes b; associative,
// not necessarily commutative), load(j) and store(j, inclusive) over the
// logical index j in [0, n).

template <class P>
struct OpF {
  __device__ __forceinline__ typename P::T operator()(
      const typename P::T& a, const typename P::T& b) const {
    return P::op(a, b);
  }
};

template <class P>
__global__ void __launch_bounds__(THREADS)
    scan_tiles(P p, long long n, typename P::T* __restrict__ aggs) {
  typedef typename P::T T;
  typedef cub::BlockScan<T, THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long base = static_cast<long long>(blockIdx.x) * TILE +
                         static_cast<long long>(threadIdx.x) * IPT;
  T acc = P::identity();
#pragma unroll
  for (int k = 0; k < IPT; ++k)
    if (base + k < n) acc = P::op(acc, p.load(base + k));
  T incl, total;
  Scan(tmp).InclusiveScan(acc, incl, OpF<P>(), total);
  if (threadIdx.x == 0) aggs[blockIdx.x] = total;
}

// in place: aggs[b] <- op over aggs[0..b) (identity for b = 0)
template <class P>
__global__ void __launch_bounds__(CARRY_T)
    scan_carries(typename P::T* __restrict__ aggs, long long nb) {
  typedef typename P::T T;
  typedef cub::BlockScan<T, CARRY_T> Scan;
  __shared__ typename Scan::TempStorage tmp;
  T carry = P::identity();
  for (long long b0 = 0; b0 < nb; b0 += CARRY_T) {
    const long long i = b0 + threadIdx.x;
    const T v = i < nb ? aggs[i] : P::identity();
    T ex, total;
    Scan(tmp).ExclusiveScan(v, ex, P::identity(), OpF<P>(), total);
    if (i < nb) aggs[i] = P::op(carry, ex);
    carry = P::op(carry, total);
    __syncthreads();
  }
}

template <class P>
__global__ void __launch_bounds__(THREADS)
    scan_apply(P p, long long n, const typename P::T* __restrict__ carries) {
  typedef typename P::T T;
  typedef cub::BlockScan<T, THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long base = static_cast<long long>(blockIdx.x) * TILE +
                         static_cast<long long>(threadIdx.x) * IPT;
  T items[IPT];
  T acc = P::identity();
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    items[k] = base + k < n ? p.load(base + k) : P::identity();
    acc = P::op(acc, items[k]);
  }
  T ex;
  Scan(tmp).ExclusiveScan(acc, ex, P::identity(), OpF<P>());
  T run = P::op(carries[blockIdx.x], ex);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    run = P::op(run, items[k]);
    if (base + k < n) p.store(base + k, run);
  }
}

template <class P>
void run_scan(const P& p, long long n, void* scratch, cudaStream_t st) {
  if (n <= 0) return;
  typedef typename P::T T;
  const long long nb = (n + TILE - 1) / TILE;
  T* aggs = static_cast<T*>(scratch);
  scan_tiles<P><<<static_cast<unsigned>(nb), THREADS, 0, st>>>(p, n, aggs);
  scan_carries<P><<<1, CARRY_T, 0, st>>>(aggs, nb);
  scan_apply<P><<<static_cast<unsigned>(nb), THREADS, 0, st>>>(p, n, aggs);
}

// ---- K12 -----------------------------------------------------------------

struct KeyCols {
  const void* v[MAX_KEYS];
  const unsigned char* m[MAX_KEYS];   // null: no NULLs
  int dt[MAX_KEYS];
  int nk;                             // keys in this launch
  int np;                             // the first np are partition keys
};

__device__ __forceinline__ bool key_differs(const KeyCols& k, int j,
                                            long long a, long long b) {
  bool ma = true, mb = true;
  if (k.m[j]) {
    ma = k.m[j][a] != 0;
    mb = k.m[j][b] != 0;
    if (ma != mb) return true;
    if (!ma) return false;    // two NULLs: one group (neutralized slots)
  }
  switch (k.dt[j]) {
    case DT_BOOL:
      return static_cast<const unsigned char*>(k.v[j])[a] !=
             static_cast<const unsigned char*>(k.v[j])[b];
    case DT_I32:
      return static_cast<const int*>(k.v[j])[a] !=
             static_cast<const int*>(k.v[j])[b];
    case DT_I64:
      return static_cast<const long long*>(k.v[j])[a] !=
             static_cast<const long long*>(k.v[j])[b];
    default:
      return static_cast<const double*>(k.v[j])[a] !=
             static_cast<const double*>(k.v[j])[b];
  }
}

__global__ void __launch_bounds__(THREADS)
    window_flags(const void* __restrict__ perm, int perm64,
                 const unsigned char* __restrict__ live, KeyCols keys,
                 long long n, int accumulate,
                 unsigned char* __restrict__ pstart,
                 unsigned char* __restrict__ peerstart) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= n) return;
  bool ps = i == 0, qs = ps;
  if (i > 0) {
    const long long r = perm64 ? static_cast<const long long*>(perm)[i]
                               : static_cast<const int*>(perm)[i];
    const long long q = perm64 ? static_cast<const long long*>(perm)[i - 1]
                               : static_cast<const int*>(perm)[i - 1];
    if (live && live[r] != live[q]) ps = true;
    for (int j = 0; j < keys.np && !ps; ++j) ps = key_differs(keys, j, r, q);
    qs = ps;
    for (int j = keys.np; j < keys.nk && !qs; ++j)
      qs = key_differs(keys, j, r, q);
  }
  if (accumulate) {
    ps = ps || pstart[i];
    qs = qs || peerstart[i];
  }
  pstart[i] = ps;
  peerstart[i] = qs;
}

struct Pos3 {
  long long a, b, c;
};

// forward: (max partition start, max peer start, count of peer starts)
struct PosFwd {
  typedef Pos3 T;
  const unsigned char* pstart;
  const unsigned char* peerstart;
  long long* ppos;
  long long* peer_lo;
  long long* dense;
  __device__ static T identity() { return T{0, 0, 0}; }
  __device__ static T op(const T& x, const T& y) {
    return T{x.a > y.a ? x.a : y.a, x.b > y.b ? x.b : y.b, x.c + y.c};
  }
  __device__ T load(long long j) const {
    const bool q = peerstart[j] != 0;
    return T{pstart[j] ? j : 0, q ? j : 0, q ? 1 : 0};
  }
  __device__ void store(long long j, const T& t) const {
    ppos[j] = t.a;
    peer_lo[j] = t.b;
    dense[j] = t.c;
  }
};

struct Pos2 {
  long long a, b;
};

// backward: (min partition end, min peer end) at or after the row
struct PosBwd {
  typedef Pos2 T;
  const unsigned char* pstart;
  const unsigned char* peerstart;
  long long n;
  long long* plast;
  long long* peer_hi;
  __device__ static T identity() { return T{NONE, NONE}; }
  __device__ static T op(const T& x, const T& y) {
    return T{x.a < y.a ? x.a : y.a, x.b < y.b ? x.b : y.b};
  }
  __device__ T load(long long j) const {
    const long long i = n - 1 - j;
    const bool last = i == n - 1;
    return T{(last || pstart[i + 1]) ? i : NONE,
             (last || peerstart[i + 1]) ? i : NONE};
  }
  __device__ void store(long long j, const T& t) const {
    const long long i = n - 1 - j;
    plast[i] = t.a;
    peer_hi[i] = t.b;
  }
};

// ---- K13 -----------------------------------------------------------------

template <class A>
struct Acc {
  A s;
  long long c;
};

// int64 sums wrap (two's complement, as numpy's cumsum): add as unsigned
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ double wrap_add(double a, double b) {
  return a + b;
}

template <class V, class A>
struct Prefix {
  typedef Acc<A> T;
  const V* vals;                // null: count only
  const unsigned char* valid;   // null: every row valid
  A* cum;
  long long* ccnt;
  __device__ static T identity() { return T{A(0), 0}; }
  __device__ static T op(const T& x, const T& y) {
    return T{wrap_add(x.s, y.s), x.c + y.c};
  }
  __device__ T load(long long j) const {
    const bool ok = valid == nullptr || valid[j] != 0;
    return T{(ok && vals) ? static_cast<A>(vals[j]) : A(0), ok ? 1 : 0};
  }
  __device__ void store(long long j, const T& t) const {
    if (cum) cum[j] = t.s;
    if (ccnt) ccnt[j] = t.c;
  }
};

// NaN-propagating min/max (np.minimum / lax.min)
template <class V>
__device__ __forceinline__ V vmin(V a, V b) { return b < a ? b : a; }
template <class V>
__device__ __forceinline__ V vmax(V a, V b) { return b > a ? b : a; }
template <>
__device__ __forceinline__ double vmin(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}
template <>
__device__ __forceinline__ double vmax(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

// f: 0 no segment start inside, 1 a start inside (everything before it is
// discarded), 2 the empty element (the scan's identity)
template <class V>
struct Seg {
  int f;
  V v;
};

template <class V, bool MAX>
struct SegScan {
  typedef Seg<V> T;
  const V* vals;
  const unsigned char* valid;   // null: every row valid
  const unsigned char* pstart;
  V ident;
  int reverse;
  long long n;
  V* out;
  __device__ static T identity() { return T{2, V(0)}; }
  __device__ static T op(const T& x, const T& y) {
    if (y.f == 2) return x;
    if (x.f == 2 || y.f == 1) return y;
    return T{x.f, MAX ? vmax(x.v, y.v) : vmin(x.v, y.v)};
  }
  __device__ T load(long long j) const {
    const long long i = reverse ? n - 1 - j : j;
    const bool start = reverse ? (i == n - 1 || pstart[i + 1] != 0)
                               : pstart[i] != 0;
    const bool ok = valid == nullptr || valid[i] != 0;
    return T{start ? 1 : 0, ok ? vals[i] : ident};
  }
  __device__ void store(long long j, const T& t) const {
    out[reverse ? n - 1 - j : j] = t.v;
  }
};

}  // namespace

extern "C" {

int tt_window_tile() { return TILE; }

// K12, flags: pstart / peerstart bool (n) over the sorted layout given by
// `perm` (int32, or int64 with perm64) from the keys' values v[j] (dtype
// dt[j]: 0 bool, 1 int32, 2 int64, 3 float64) and masks m[j] (null: no
// NULLs), row-indexed; the first np keys are partition keys. `live`
// (bool, row-indexed; null: all live) starts a partition where it changes.
// With accumulate the flags are OR-ed into the outputs (keys beyond
// MAX_KEYS run as further launches).
int tt_window_flags(const void* perm, int perm64, const void* live,
                    const void* const* v, const void* const* m,
                    const int* dt, int nk, int np, long long n,
                    int accumulate, void* pstart, void* peerstart,
                    void* stream) {
  if (n < 0 || nk < 0 || nk > MAX_KEYS || np < 0 || np > nk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  KeyCols keys;
  for (int j = 0; j < MAX_KEYS; ++j) {
    keys.v[j] = j < nk ? v[j] : nullptr;
    keys.m[j] = j < nk ? static_cast<const unsigned char*>(m[j]) : nullptr;
    keys.dt[j] = j < nk ? dt[j] : 0;
    if (j < nk && (dt[j] < DT_BOOL || dt[j] > DT_F64))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  keys.nk = nk;
  keys.np = np;
  window_flags<<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                 THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      perm, perm64, static_cast<const unsigned char*>(live), keys, n,
      accumulate, static_cast<unsigned char*>(pstart),
      static_cast<unsigned char*>(peerstart));
  return static_cast<int>(cudaGetLastError());
}

// K12, positions: from pstart / peerstart bool (n; pstart[0] and
// peerstart[0] set, pstart a subset of peerstart) → int64 (n) ppos,
// plast, peer_lo, peer_hi and dense (inclusive count of peer starts).
// Scratch: 32 bytes per tile of tt_window_tile() rows.
int tt_window_positions(const void* pstart, const void* peerstart,
                        long long n, void* ppos, void* plast, void* peer_lo,
                        void* peer_hi, void* dense, void* scratch,
                        void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* ps = static_cast<const unsigned char*>(pstart);
  const unsigned char* qs = static_cast<const unsigned char*>(peerstart);
  PosFwd f{ps, qs, static_cast<long long*>(ppos),
           static_cast<long long*>(peer_lo), static_cast<long long*>(dense)};
  run_scan(f, n, scratch, st);
  PosBwd b{ps, qs, n, static_cast<long long*>(plast),
           static_cast<long long*>(peer_hi)};
  run_scan(b, n, scratch, st);
  return static_cast<int>(cudaGetLastError());
}

// K13, prefix: inclusive prefix of the masked values (vdt 1 int32, 2
// int64 → int64 cum, wrapping; 3 float64 → float64 cum; vals null: no
// cum) and of the valid count (ccnt int64; null: none). valid null: all.
int tt_window_prefix(const void* vals, int vdt, const void* valid,
                     long long n, void* cum, void* ccnt, void* scratch,
                     void* stream) {
  if (n < 0 || (vals && (vdt < DT_I32 || vdt > DT_F64)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* ok = static_cast<const unsigned char*>(valid);
  long long* cc = static_cast<long long*>(ccnt);
  if (vals && vdt == DT_F64) {
    Prefix<double, double> p{static_cast<const double*>(vals), ok,
                             static_cast<double*>(cum), cc};
    run_scan(p, n, scratch, st);
  } else if (vals && vdt == DT_I32) {
    Prefix<int, long long> p{static_cast<const int*>(vals), ok,
                             static_cast<long long*>(cum), cc};
    run_scan(p, n, scratch, st);
  } else {
    Prefix<long long, long long> p{static_cast<const long long*>(vals), ok,
                                   vals ? static_cast<long long*>(cum)
                                        : nullptr, cc};
    run_scan(p, n, scratch, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13, segmented min/max: out (n, the values' dtype vdt 1 int32, 2 int64,
// 3 float64) = the inclusive scan of valid ? vals : ident within the
// partitions pstart marks; reverse scans from each partition's end
// backwards (the suffix of [row, partition end]). ident_i / ident_f: the
// identity as an integer / a double.
int tt_window_segscan(const void* vals, int vdt, const void* valid,
                      const void* pstart, long long n, int is_max,
                      int reverse, long long ident_i, double ident_f,
                      void* out, void* scratch, void* stream) {
  if (n < 0 || vdt < DT_I32 || vdt > DT_F64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* ok = static_cast<const unsigned char*>(valid);
  const unsigned char* ps = static_cast<const unsigned char*>(pstart);
#define TT_SEG(V, ID)                                                     \
  if (is_max) {                                                           \
    SegScan<V, true> p{static_cast<const V*>(vals), ok, ps,               \
                       static_cast<V>(ID), reverse, n, static_cast<V*>(out)}; \
    run_scan(p, n, scratch, st);                                          \
  } else {                                                                \
    SegScan<V, false> p{static_cast<const V*>(vals), ok, ps,              \
                        static_cast<V>(ID), reverse, n, static_cast<V*>(out)}; \
    run_scan(p, n, scratch, st);                                          \
  }
  if (vdt == DT_F64) {
    TT_SEG(double, ident_f)
  } else if (vdt == DT_I32) {
    TT_SEG(int, ident_i)
  } else {
    TT_SEG(long long, ident_i)
  }
#undef TT_SEG
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
