// K14 frame_bounds and K15 frame_eval — the per-row frame work of the
// window functions, over K12's positions and K13's prefixes.
//
// K14 replaces tidb_tpu/ops/window.py _frame_bounds (ROWS offsets clamped
// to [ppos, plast + 1]) and range_frame_bounds: a RANGE frame is a binary
// search inside [ppos, plast + 1] over the ORDER BY key in m-space (DESC
// negated; a NULL key placed where the sort put it, at -/+(INT64_MAX // 2)
// or -/+inf; integer keys widened to int64 first, so a DATE key's
// sentinel and offsets fit), run for exactly the reference's
// bit_length(n - 1) rounds of its own update rule — NULL rows take their
// peer block. The reference runs those rounds as log2(n) whole-column
// passes of gathers; here each thread runs its own row's rounds.
//
// K15 replaces the per-row evaluation: the rank family (row_number, rank,
// dense_rank, percent_rank, cume_dist, ntile: elementwise over K12's
// positions, float64 where the reference is), COUNT/SUM/AVG by prefix
// differences cum[hi] - cum[lo - 1] (running_agg, rows_frame_agg,
// range_frame_agg, full_frame_agg: integer results exact, wraparound
// included), FIRST/LAST/NTH_VALUE and LAG/LEAD as one gather with a
// bounds test and an optional fill (frame_value, nth_value, shifted), and
// bounded MIN/MAX over [lo, hi] for explicit ROWS frames bounded on both
// sides (the reference's doubling sparse table): frames of at most
// DIRECT_WIDTH rows loop over their rows directly; wider ones build the
// sparse-table levels (one launch per level) and take the reference's two
// overlapping lookups.
//
// What bounds them on an H100: bytes — each entry reads a few int64
// position arrays and writes one or two columns; the gathers land inside
// the row's own partition (cache lines already near). K14's RANGE search
// adds ~23 dependent reads per row at 8,388,608 rows, mostly inside one
// partition's lines.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int DIRECT_WIDTH = 64;
constexpr long long HALF = 0x7fffffffffffffffLL / 2;

enum { DT_BOOL = 0, DT_I32 = 1, DT_I64 = 2, DT_F64 = 3 };
enum { R_ROW_NUMBER = 0, R_RANK, R_DENSE_RANK, R_PERCENT_RANK, R_CUME_DIST,
       R_NTILE };
enum { A_COUNT = 0, A_SUM, A_AVG, A_NONEMPTY };

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

__device__ __forceinline__ long long row_id() {
  return static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
}

__device__ __forceinline__ long long clip(long long x, long long lo,
                                          long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// two's-complement wrapping arithmetic, as numpy's int64 arrays
__device__ __forceinline__ long long wadd(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

// ---- K14 -----------------------------------------------------------------

struct Pos {
  const long long* ppos;
  const long long* plast;
  const long long* peer_lo;
  const long long* peer_hi;
};

__global__ void __launch_bounds__(THREADS)
    rows_bounds(Pos p, long long n, int has_pre, long long pre, int has_post,
                long long post, long long* __restrict__ lo,
                long long* __restrict__ hi) {
  const long long i = row_id();
  if (i >= n) return;
  const long long pp = p.ppos[i], pl = p.plast[i];
  lo[i] = has_pre ? clip(wsub(i, pre), pp, pl + 1) : pp;
  if (has_post) {
    const long long h = wadd(i, post);
    hi[i] = h < pl ? h : pl;
  } else {
    hi[i] = pl;
  }
}

// the key in m-space: widened, DESC negated, NULL at the sort's place.
// A probe issues the validity byte's and the key's loads together.
template <class KT>
struct MKey {
  using M = typename std::conditional<std::is_same<KT, double>::value,
                                      double, long long>::type;
  const KT* key;
  const unsigned char* valid;
  int desc;
  __device__ __forceinline__ M at(unsigned k) const {
    const unsigned char ok = valid[k];
    const KT v = key[k];
    if constexpr (std::is_same<KT, double>::value) {
      const double inf = __longlong_as_double(0x7ff0000000000000LL);
      return ok ? (desc ? -v : v) : (desc ? inf : -inf);
    } else {
      const long long w = static_cast<long long>(v);
      return ok ? (desc ? wsub(0, w) : w) : (desc ? HALF : -HALF);
    }
  }
};

__device__ __forceinline__ long long kadd(long long a, long long b) {
  return wadd(a, b);
}
__device__ __forceinline__ long long ksub(long long a, long long b) {
  return wsub(a, b);
}
__device__ __forceinline__ double kadd(double a, double b) { return a + b; }
__device__ __forceinline__ double ksub(double a, double b) { return a - b; }

template <class M>
__device__ __forceinline__ bool hit_of(M v, M t, bool strict) {
  return strict ? v > t : v >= t;
}

// The reference's two searches of one row in [pp, pl + 1], in one loop:
// two independent chains in flight, each under the reference's update
// rule and its cap of `rounds` rounds. A chain whose interval is empty
// (a == b) probes no more: that state is a fixed point of the rule (b
// only ever holds pl + 1, where a hit is forced, or a probe that hit, so
// its probe would hit again). A live chain's midpoint lies in [pp, pl]:
// no clip and no forced hit. Positions fit 32 bits (n < 2^31).
template <class KT, class M>
__device__ __forceinline__ void search_both(const MKey<KT>& m, unsigned pl,
                                            M t_lo, M t_hi, int rounds,
                                            unsigned* a_lo,
                                            unsigned* a_hi) {
  unsigned a0 = *a_lo, b0 = pl + 1, a1 = *a_hi, b1 = pl + 1;
  for (int r = 0; r < rounds; ++r) {
    const bool s0 = a0 < b0, s1 = a1 < b1;
    if (!s0 && !s1) break;
    const unsigned m0 = (a0 + b0) >> 1, m1 = (a1 + b1) >> 1;
    M v0 = M(0), v1 = M(0);
    if (s0) v0 = m.at(m0);
    if (s1) v1 = m.at(m1);
    if (s0) {
      if (v0 >= t_lo) b0 = m0; else a0 = m0 + 1;
    }
    if (s1) {
      if (v1 > t_hi) b1 = m1; else a1 = m1 + 1;
    }
  }
  *a_lo = a0;
  *a_hi = a1;
}

// floor(k * len / 33) for k <= 32: in 32 bits while the product fits
__device__ __forceinline__ unsigned part33(unsigned k, unsigned len) {
  return len < (1u << 26)
             ? k * len / 33u
             : static_cast<unsigned>(static_cast<unsigned long long>(k) *
                                     len / 33ull);
}

// The first hit in [pp, pl + 1] of every lane that wants one, over a key
// that does not decrease within the partition (so the first hit is
// unique, and is the reference's answer whenever its rounds suffice): the
// lanes with one (partition, target) pair share one search, which the
// whole warp runs as a 33-ary search (32 probes a round, one ballot), then
// a last round over at most 32 positions. → the answer, or `dflt` for a
// lane that wants none. Every lane of the warp calls it.
__device__ __forceinline__ unsigned warp_first(const MKey<int>& m,
                                               unsigned pp, unsigned pl,
                                               long long t, bool strict,
                                               bool want, unsigned dflt) {
  constexpr unsigned FULL = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  unsigned res = dflt;
  unsigned pending = __ballot_sync(FULL, want);
  while (pending) {
    const int src = __ffs(pending) - 1;
    const unsigned gpp = __shfl_sync(FULL, pp, src);
    const unsigned gpl = __shfl_sync(FULL, pl, src);
    const long long gt = __shfl_sync(FULL, t, src);
    const unsigned group =
        __ballot_sync(FULL, want && pp == gpp && t == gt) & pending;
    unsigned a = gpp, b = gpl + 1;  // below a no hit; b hits or is pl + 1
    while (b - a > 32) {
      const unsigned len = b - a;
      const unsigned hits = __ballot_sync(
          FULL, hit_of(m.at(a + part33(lane + 1, len)), gt, strict));
      if (hits) {
        const unsigned f = __ffs(hits) - 1;
        b = a + part33(f + 1, len);
        a = f ? a + part33(f, len) + 1 : a;
      } else {
        a = a + part33(32, len) + 1;
      }
    }
    const unsigned q = a + lane;
    const unsigned hits =
        __ballot_sync(FULL, q < b && hit_of(m.at(q), gt, strict));
    const unsigned ans = hits ? a + __ffs(hits) - 1 : b;
    if ((group >> lane) & 1) res = ans;
    pending &= ~group;
  }
  return res;
}

// One row a thread. NULL rows take their peer block on a bounded side.
// Valid rows: with `sorted` (the caller's promise that the key does not
// decrease within a partition in m-space and that the peers are its runs
// of equal keys, as the window layout gives) and an int32 key (whose
// m-space values lie strictly between the NULL sentinels, so NULLs keep
// the order), a 0 offset is the peer edge and any other offset takes
// warp_first. Every other row, and every row of a partition that spans
// all n = 2^k rows (where the reference's bit_length(n - 1) rounds may
// stop one round short of its answer), runs search_both.
template <class KT>
__global__ void __launch_bounds__(THREADS)
    range_bounds(Pos p, long long n, MKey<KT> m, int has_pre,
                 typename MKey<KT>::M pre, int has_post,
                 typename MKey<KT>::M post, int rounds, int sorted,
                 long long* __restrict__ lo, long long* __restrict__ hi) {
  using M = typename MKey<KT>::M;
  const long long i = row_id();
  const bool in = i < n;
  const long long ic = in ? i : n - 1;
  const unsigned pp = static_cast<unsigned>(p.ppos[ic]);
  const unsigned pl = static_cast<unsigned>(p.plast[ic]);
  const M mi = m.at(static_cast<unsigned>(ic));
  const bool ok = in && m.valid[ic] != 0;
  long long l = has_pre && !ok ? p.peer_lo[ic] : pp;
  long long h = has_post && !ok ? p.peer_hi[ic] : pl;
  bool need_lo = ok && has_pre, need_hi = ok && has_post;
  const M t_lo = ksub(mi, pre), t_hi = kadd(mi, post);
  if constexpr (std::is_same<KT, int>::value) {
    const bool whole_pow2 = pp == 0 && pl == n - 1 && (n & (n - 1)) == 0;
    const bool fast = sorted && !whole_pow2;
    if (fast && need_lo && pre == 0) {
      l = p.peer_lo[ic];
      need_lo = false;
    }
    if (fast && need_hi && post == 0) {
      h = p.peer_hi[ic];
      need_hi = false;
    }
    if (sorted) {  // warp-uniform: every lane calls warp_first
      l = warp_first(m, pp, pl, t_lo, false, fast && need_lo,
                     static_cast<unsigned>(l));
      h = static_cast<long long>(warp_first(m, pp, pl, t_hi, true,
                                            fast && need_hi,
                                            static_cast<unsigned>(h + 1))) -
          1;
      if (fast) need_lo = need_hi = false;
    }
  }
  if (need_lo || need_hi) {
    unsigned a_lo = need_lo ? pp : pl + 1, a_hi = need_hi ? pp : pl + 1;
    search_both(m, pl, t_lo, t_hi, rounds, &a_lo, &a_hi);
    if (need_lo) l = a_lo;
    if (need_hi) h = static_cast<long long>(a_hi) - 1;
  }
  if (in) {
    lo[i] = l;
    hi[i] = h;
  }
}

// ---- K15 -----------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    frame_rank(Pos p, const long long* __restrict__ dense, long long n,
               int which, long long buckets, void* __restrict__ out) {
  const long long i = row_id();
  if (i >= n) return;
  const long long pp = p.ppos[i];
  const long long rows = p.plast[i] - pp + 1;
  long long* oi = static_cast<long long*>(out);
  double* of = static_cast<double*>(out);
  switch (which) {
    case R_ROW_NUMBER:
      oi[i] = i - pp + 1;
      break;
    case R_RANK:
      oi[i] = p.peer_lo[i] - pp + 1;
      break;
    case R_DENSE_RANK:
      oi[i] = dense[i] - dense[pp] + 1;
      break;
    case R_PERCENT_RANK: {
      const double r = static_cast<double>(p.peer_lo[i] - pp + 1);
      const double denom = static_cast<double>(rows - 1 > 1 ? rows - 1 : 1);
      of[i] = rows > 1 ? (r - 1.0) / denom : 0.0;
      break;
    }
    case R_CUME_DIST:
      of[i] = static_cast<double>(p.peer_hi[i] - pp + 1) /
              static_cast<double>(rows);
      break;
    default: {   // R_NTILE: earlier buckets absorb the remainder
      const long long k = i - pp;
      const long long q = rows / buckets, r = rows % buckets;
      const long long big = r * (q + 1);
      const long long b =
          k < big ? k / (q + 1 > 1 ? q + 1 : 1) + 1
                  : r + (k - big) / (q > 1 ? q : 1) + 1;
      oi[i] = q > 0 ? b : k + 1;
    }
  }
}

template <class A>
__device__ __forceinline__ A adiff(A a, A b);
template <>
__device__ __forceinline__ long long adiff(long long a, long long b) {
  return wsub(a, b);
}
template <>
__device__ __forceinline__ double adiff(double a, double b) {
  return a - b;
}

// count / sum / avg / nonempty over [lo, hi] by prefix differences
template <class A>
__global__ void __launch_bounds__(THREADS)
    frame_agg(const A* __restrict__ cum, const long long* __restrict__ ccnt,
              const long long* __restrict__ lo,
              const long long* __restrict__ hi, long long n, int what,
              void* __restrict__ out, unsigned char* __restrict__ ok) {
  const long long i = row_id();
  if (i >= n) return;
  const long long l = lo[i], h = hi[i];
  const bool empty = h < l;
  const long long hc = clip(h, 0, n - 1), lc = clip(l - 1, 0, n - 1);
  const long long c = empty ? 0 : ccnt[hc] - (l > 0 ? ccnt[lc] : 0);
  if (what == A_COUNT) {
    static_cast<long long*>(out)[i] = c;
    ok[i] = 1;
    return;
  }
  ok[i] = c > 0 && !empty;
  if (what == A_NONEMPTY) return;
  const A s = empty ? A(0) : adiff(cum[hc], l > 0 ? cum[lc] : A(0));
  if (what == A_SUM)
    static_cast<A*>(out)[i] = s;
  else
    static_cast<double*>(out)[i] =
        static_cast<double>(s) / static_cast<double>(c > 0 ? c : 1);
}

__device__ __forceinline__ void copy_elem(const void* src, long long s,
                                          void* dst, long long d, int es) {
  switch (es) {
    case 1:
      static_cast<unsigned char*>(dst)[d] =
          static_cast<const unsigned char*>(src)[s];
      break;
    case 2:
      static_cast<unsigned short*>(dst)[d] =
          static_cast<const unsigned short*>(src)[s];
      break;
    case 4:
      static_cast<unsigned*>(dst)[d] = static_cast<const unsigned*>(src)[s];
      break;
    default:
      static_cast<unsigned long long*>(dst)[d] =
          static_cast<const unsigned long long*>(src)[s];
  }
}

// pos = (base ? base[i] : i) + d; ok = lo_lim[i] <= pos <= hi_lim[i] (a
// null limit: no test). With a fill: out = ok ? vals[pos] : fill; without:
// out = vals[clip(pos)], its mask valid[clip(pos)] & ok.
__global__ void __launch_bounds__(THREADS)
    frame_gather(const void* __restrict__ vals, int es,
                 const unsigned char* __restrict__ valid,
                 const long long* __restrict__ base, long long d,
                 const long long* __restrict__ lo_lim,
                 const long long* __restrict__ hi_lim, long long n,
                 const void* __restrict__ fill_v, long long fill_vs,
                 const unsigned char* __restrict__ fill_m, long long fill_ms,
                 void* __restrict__ out_v, unsigned char* __restrict__ out_m) {
  const long long i = row_id();
  if (i >= n) return;
  const long long pos = wadd(base ? base[i] : i, d);
  const bool ok = (lo_lim == nullptr || pos >= lo_lim[i]) &&
                  (hi_lim == nullptr || pos <= hi_lim[i]);
  const long long pc = clip(pos, 0, n - 1);
  const bool vm = valid == nullptr || valid[pc] != 0;
  if (fill_v != nullptr && !ok) {
    copy_elem(fill_v, i * fill_vs, out_v, i, es);
    out_m[i] = fill_m[i * fill_ms];
    return;
  }
  copy_elem(vals, pc, out_v, i, es);
  out_m[i] = vm && (ok || fill_v != nullptr);
}

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

template <class V, bool MAX>
__device__ __forceinline__ V vop(V a, V b) {
  return MAX ? vmax(a, b) : vmin(a, b);
}

// bounded MIN/MAX, direct: op over valid ? vals : ident in [lo, hi];
// ident for an empty frame
template <class V, bool MAX>
__global__ void __launch_bounds__(THREADS)
    minmax_direct(const V* __restrict__ vals,
                  const unsigned char* __restrict__ valid, V ident,
                  const long long* __restrict__ lo,
                  const long long* __restrict__ hi, long long n,
                  V* __restrict__ out) {
  const long long i = row_id();
  if (i >= n) return;
  V acc = ident;
  const long long h = hi[i];
  for (long long k = lo[i]; k <= h; ++k)
    acc = vop<V, MAX>(acc, valid[k] ? vals[k] : ident);
  out[i] = acc;
}

// sparse-table level 0: the masked values
template <class V>
__global__ void __launch_bounds__(THREADS)
    minmax_level0(const V* __restrict__ vals,
                  const unsigned char* __restrict__ valid, V ident,
                  long long n, V* __restrict__ t0) {
  const long long i = row_id();
  if (i >= n) return;
  t0[i] = valid[i] ? vals[i] : ident;
}

// level k over [i, i + 2^k): op(level k-1 at i, at i + 2^(k-1) or ident)
template <class V, bool MAX>
__global__ void __launch_bounds__(THREADS)
    minmax_level(const V* __restrict__ prev, long long step, V ident,
                 long long n, V* __restrict__ next) {
  const long long i = row_id();
  if (i >= n) return;
  next[i] = vop<V, MAX>(prev[i], i + step < n ? prev[i + step] : ident);
}

// the reference's two overlapping lookups at level floor(log2 w)
template <class V, bool MAX>
__global__ void __launch_bounds__(THREADS)
    minmax_query(const V* __restrict__ table, int levels, V ident,
                 const long long* __restrict__ lo,
                 const long long* __restrict__ hi, long long n,
                 V* __restrict__ out) {
  const long long i = row_id();
  if (i >= n) return;
  const long long l = lo[i], h = hi[i];
  if (h < l) {
    out[i] = ident;
    return;
  }
  const long long w = h - l + 1;
  int kk = 0;
  for (int k = 1; k < levels; ++k)
    if (w >= (1LL << k)) kk = k;
  const V* t = table + static_cast<long long>(kk) * n;
  out[i] = vop<V, MAX>(t[clip(l, 0, n - 1)],
                       t[clip(h - (1LL << kk) + 1, 0, n - 1)]);
}

template <class V, bool MAX>
void minmax(const void* vals, const void* valid, V ident, const void* lo,
            const void* hi, long long n, long long width, void* table,
            void* out, cudaStream_t st) {
  const V* v = static_cast<const V*>(vals);
  const unsigned char* ok = static_cast<const unsigned char*>(valid);
  const long long* l = static_cast<const long long*>(lo);
  const long long* h = static_cast<const long long*>(hi);
  V* o = static_cast<V*>(out);
  if (width <= DIRECT_WIDTH) {
    minmax_direct<V, MAX><<<blocks_for(n), THREADS, 0, st>>>(v, ok, ident, l,
                                                             h, n, o);
    return;
  }
  int levels = 1;
  while ((2LL << (levels - 1)) <= width) ++levels;   // floor(log2 w) + 1
  V* t = static_cast<V*>(table);
  minmax_level0<V><<<blocks_for(n), THREADS, 0, st>>>(v, ok, ident, n, t);
  for (int k = 1; k < levels; ++k)
    minmax_level<V, MAX><<<blocks_for(n), THREADS, 0, st>>>(
        t + static_cast<long long>(k - 1) * n, 1LL << (k - 1), ident, n,
        t + static_cast<long long>(k) * n);
  minmax_query<V, MAX><<<blocks_for(n), THREADS, 0, st>>>(t, levels, ident,
                                                          l, h, n, o);
}

}  // namespace

extern "C" {

int tt_frame_direct_width() { return DIRECT_WIDTH; }

// K14: lo, hi int64 (n) of a ROWS frame (range_key null) or a RANGE frame
// over the sorted key (kdt 1 int32, 2 int64, 3 float64) and its validity
// `kvalid`; has_pre / has_post 0 = unbounded side; integer offsets in
// pre_i / post_i, float offsets (a float64 key) in pre_f / post_f;
// `rounds` the reference's bit_length(n - 1); `sorted` the caller's
// promise that an int32 key does not decrease within a partition in
// m-space and that the peers are its runs of equal keys (read only for
// an int32 key).
int tt_frame_bounds(const void* ppos, const void* plast, const void* peer_lo,
                    const void* peer_hi, long long n, const void* key,
                    int kdt, const void* kvalid, int desc, int has_pre,
                    long long pre_i, double pre_f, int has_post,
                    long long post_i, double post_f, int rounds,
                    int sorted, void* lo, void* hi, void* stream) {
  if (n < 0 || (key && (kdt < DT_I32 || kdt > DT_F64)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Pos p{static_cast<const long long*>(ppos),
        static_cast<const long long*>(plast),
        static_cast<const long long*>(peer_lo),
        static_cast<const long long*>(peer_hi)};
  long long* l = static_cast<long long*>(lo);
  long long* h = static_cast<long long*>(hi);
  const unsigned char* kv = static_cast<const unsigned char*>(kvalid);
  if (key == nullptr) {
    rows_bounds<<<blocks_for(n), THREADS, 0, st>>>(p, n, has_pre, pre_i,
                                                   has_post, post_i, l, h);
  } else if (kdt == DT_F64) {
    MKey<double> m{static_cast<const double*>(key), kv, desc};
    range_bounds<double><<<blocks_for(n), THREADS, 0, st>>>(
        p, n, m, has_pre, pre_f, has_post, post_f, rounds, 0, l, h);
  } else if (kdt == DT_I32) {
    MKey<int> m{static_cast<const int*>(key), kv, desc};
    range_bounds<int><<<blocks_for(n), THREADS, 0, st>>>(
        p, n, m, has_pre, pre_i, has_post, post_i, rounds, sorted != 0, l,
        h);
  } else {
    MKey<long long> m{static_cast<const long long*>(key), kv, desc};
    range_bounds<long long><<<blocks_for(n), THREADS, 0, st>>>(
        p, n, m, has_pre, pre_i, has_post, post_i, rounds, 0, l, h);
  }
  return static_cast<int>(cudaGetLastError());
}

// K15, rank family: out int64 (row_number, rank, dense_rank, ntile) or
// float64 (percent_rank, cume_dist) from K12's positions.
int tt_frame_rank(const void* ppos, const void* plast, const void* peer_lo,
                  const void* peer_hi, const void* dense, long long n,
                  int which, long long buckets, void* out, void* stream) {
  if (n < 0 || which < R_ROW_NUMBER || which > R_NTILE ||
      (which == R_NTILE && buckets <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  Pos p{static_cast<const long long*>(ppos),
        static_cast<const long long*>(plast),
        static_cast<const long long*>(peer_lo),
        static_cast<const long long*>(peer_hi)};
  frame_rank<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(
      stream)>>>(p, static_cast<const long long*>(dense), n, which, buckets,
                 out);
  return static_cast<int>(cudaGetLastError());
}

// K15, COUNT / SUM / AVG / non-empty test over [lo, hi] from K13's
// prefixes: cum int64 (float64 with cum_f64; null for count / nonempty),
// ccnt int64. out: count int64, sum the cum's type, avg float64, nonempty
// nothing (null); ok bool.
int tt_frame_agg(const void* cum, int cum_f64, const void* ccnt,
                 const void* lo, const void* hi, long long n, int what,
                 void* out, void* ok, void* stream) {
  if (n < 0 || what < A_COUNT || what > A_NONEMPTY ||
      ((what == A_SUM || what == A_AVG) && cum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* cc = static_cast<const long long*>(ccnt);
  const long long* l = static_cast<const long long*>(lo);
  const long long* h = static_cast<const long long*>(hi);
  unsigned char* o = static_cast<unsigned char*>(ok);
  if (cum_f64)
    frame_agg<double><<<blocks_for(n), THREADS, 0, st>>>(
        static_cast<const double*>(cum), cc, l, h, n, what, out, o);
  else
    frame_agg<long long><<<blocks_for(n), THREADS, 0, st>>>(
        static_cast<const long long*>(cum), cc, l, h, n, what, out, o);
  return static_cast<int>(cudaGetLastError());
}

// K15, gather with a bounds test (FIRST/LAST/NTH_VALUE, LAG/LEAD): element
// size es 1/2/4/8; base / lo_lim / hi_lim int64 or null; valid null = all
// valid; fill_v / fill_m with strides 0 (a scalar) or 1 (a column), or
// fill_v null for no fill.
int tt_frame_gather(const void* vals, int es, const void* valid,
                    const void* base, long long d, const void* lo_lim,
                    const void* hi_lim, long long n, const void* fill_v,
                    long long fill_vs, const void* fill_m, long long fill_ms,
                    void* out_v, void* out_m, void* stream) {
  if (n < 0 || (es != 1 && es != 2 && es != 4 && es != 8) ||
      (fill_v != nullptr && fill_m == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  frame_gather<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(
      stream)>>>(vals, es, static_cast<const unsigned char*>(valid),
                 static_cast<const long long*>(base), d,
                 static_cast<const long long*>(lo_lim),
                 static_cast<const long long*>(hi_lim), n, fill_v, fill_vs,
                 static_cast<const unsigned char*>(fill_m), fill_ms, out_v,
                 static_cast<unsigned char*>(out_m));
  return static_cast<int>(cudaGetLastError());
}

// K15, bounded MIN/MAX over [lo, hi] (vdt 1 int32, 2 int64, 3 float64):
// out = op over valid ? vals : ident, ident for an empty frame. `width`
// is the frame's static width (pre + post + 1); above
// tt_frame_direct_width() the sparse table needs `table` of
// (floor(log2 width) + 1) * n values.
int tt_frame_minmax(const void* vals, int vdt, const void* valid,
                    int is_max, long long ident_i, double ident_f,
                    const void* lo, const void* hi, long long n,
                    long long width, void* table, void* out, void* stream) {
  if (n < 0 || vdt < DT_I32 || vdt > DT_F64 ||
      (width > DIRECT_WIDTH && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TT_MM(V, ID)                                                        \
  if (is_max)                                                               \
    minmax<V, true>(vals, valid, static_cast<V>(ID), lo, hi, n, width,      \
                    table, out, st);                                        \
  else                                                                      \
    minmax<V, false>(vals, valid, static_cast<V>(ID), lo, hi, n, width,     \
                     table, out, st);
  if (vdt == DT_F64) {
    TT_MM(double, ident_f)
  } else if (vdt == DT_I32) {
    TT_MM(int, ident_i)
  } else {
    TT_MM(long long, ident_i)
  }
#undef TT_MM
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
