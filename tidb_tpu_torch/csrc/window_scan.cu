// K12 window_bounds and K13 window_scan — the row-scale scans of the
// window functions, after the sort.
//
// K12 replaces the boundary flags of tidb_tpu/executor/device_emit.py
// emit_window_cols (the `flags` closure) and the position helpers of
// tidb_tpu/ops/window.py: _cummax/_pstart_pos (a lax.associative_scan of
// max), partition_ids, and _partition_last / _next_peerstart_pos /
// _partition_rows, which the JAX package computes with segment_max /
// segment_count over n segments and a gather back. The flags compare
// each sorted row with its sorted neighbour, key by key in the key's own
// type, as the reference's `!=` does: -0.0 equals +0.0, a NaN starts a
// new peer group, NULL slots are neutralized, and a change of `live`
// starts a partition (the dead tail of a filtered slab is a partition of
// its own). Entry `positions` is two scans: a forward one of (max start
// index, max peer start index, count of peer starts) gives ppos, peer_lo
// and the dense-rank count; a backward one of (min partition end, min
// peer end) gives plast and peer_hi. Positions are exact integers: they
// equal the reference's.
//
// The flags are bound by the card's rate of random loads (~100 G a
// second, cached or not): a row gathers `live` and each key it still
// compares (value and mask) through the permutation, 4-7 random loads
// over W1's and W2's layouts. Measured on an H100 (tools/scan_timing.py,
// NVIDIA H100 80GB HBM3 at 700 W): L2 prefetches of the partition keys
// slowed the flags by 25-35% (more requests); flags computed in the
// forward scan's tile load (one launch fewer) took 577-587 us over W1
// against 524-540 for flags and forward scan apart, a tile's gathers
// then waiting on the look-back chain. So `bounds_flags`, the flags
// launch of window_bounds, runs alone and issues fewer loads:
//   * with sort_perm's count of live rows (which it lists first) the
//     live flag is `i == n_live`: no gather of `live` at all (without
//     the count, `live` is compared as a first key);
//   * a warp takes 32 FLAG_ROWS consecutive sorted rows (lane l of load
//     k: row w0 + 32 k + l); a row gathers a key once and takes its
//     predecessor's by shuffle (the warp's first row loads its own);
//   * a key is skipped by the rows already flagged, and gathered only for
//     the rows still comparing and their predecessors; its type is
//     dispatched once a warp;
//   * the flags leave as one FLAG_ROWS-byte store a lane, cut from the
//     loads' ballots.
// Two rows a lane measured best (W1 flags 333-336 us, one row 339-342,
// four 362-367, eight 367). The `window_flags` entry launches the same
// kernel over more than 8 keys a chunk of 8 at a time, each chunk
// starting from the flags the earlier ones wrote (`accumulate`).
//
// K13 replaces the whole-column cumsums of running_agg, rows_frame_agg and
// range_frame_agg (masked value and valid count, int64 or float64) and
// _segmented_scan, the reference's Hillis-Steele min/max scan of log2(n)
// passes of gathers (23 at 8,388,608 rows), forward, or backward for the
// [lo, partition end] suffix frames.
//
// What bounds them on an H100: bytes. Every scan here (K13's prefix and
// segmented scans, K12's two position scans) is one launch of one
// single-pass scan engine, `scan_onepass`, with decoupled look-back
// (Merrill and Garland, 2016), so a row is read once and written once:
//   1. each block takes its tile id from an atomic counter (tile order is
//      launch order, so a tile waits only on tiles already running);
//   2. each warp loads its 256 consecutive rows warp-striped (load k of a
//      lane reads row k * 32 + lane: a warp's load covers 32 consecutive
//      elements of every input) and scans them in index order: a
//      shuffle-based warp scan of every load at once, then each load
//      after the totals of the earlier ones;
//   3. one warp scans the 8 warp totals, publishes the tile's aggregate,
//      looks back over the earlier tiles' status 32 tiles a step (each
//      lane one tile; the nearest inclusive prefix ends it), and
//      publishes the tile's inclusive prefix;
//   4. every row is stored warp-striped, as it was loaded.
// A scan state is wider than a status word (Prefix 12-16 B, Pos3 12 B,
// Seg 8-16 B), so a status is a flag word and two payload slots (the
// aggregate and the inclusive prefix, never overwritten): the payload is
// written first, the flag with st.release.gpu after it; a reader takes
// the flag with ld.acquire.gpu, then the payload with ld.relaxed.gpu.
// The flags and the tile counter are zeroed by one cudaMemsetAsync a
// call (K12's positions: both scans' in one). Positions and counts are
// 32-bit inside a state (n < 2^31, which the wrappers enforce) and int64
// outside. The prefix keeps the reference's
// prefix-difference formulation: an int64 prefix wraps as numpy's does,
// so window sums over it stay exact. A float64 prefix adds in scan-tree
// order, not numpy's sequential order: its last bits differ, within
// (n-1)·eps·Σ|x| of the sequential sum.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int IPT = 8;                   // rows a lane (loads a warp)
constexpr int TILE = THREADS * IPT;      // 2,048 rows a tile
constexpr int STATE_BYTES = 32;          // a payload slot of the status
constexpr int MAX_KEYS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ST_AGG = 1u;          // the tile's aggregate is out
constexpr unsigned ST_INCL = 2u;         // its inclusive prefix is out
constexpr int NONE32 = 0x7fffffff;

enum { DT_BOOL = 0, DT_I32 = 1, DT_I64 = 2, DT_F64 = 3 };

// ---- the single-pass scan -------------------------------------------------
//
// A policy P supplies T, identity(), op(a, b) (a precedes b; associative,
// not necessarily commutative), load(j) and store(j, inclusive) over the
// logical index j in [0, n). T::each(f) applies f to every field of a
// state (what a shuffle moves); T::WORDS is the count of leading 32-bit
// words that carry its value (what the status moves).

template <class T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  v.each([d](auto& x) { x = __shfl_up_sync(FULL, x, d); });
  return v;
}

template <class T>
__device__ __forceinline__ T shfl_down(T v, int d) {
  v.each([d](auto& x) { x = __shfl_down_sync(FULL, x, d); });
  return v;
}

template <class T>
__device__ __forceinline__ T shfl_idx(T v, int src) {
  v.each([src](auto& x) { x = __shfl_sync(FULL, x, src); });
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// one scan's status in the scratch: the tile counter, a flag word a tile
// (both zeroed by the entry's memset), and two payload slots a tile
struct Status {
  unsigned* counter;
  unsigned* flags;
  unsigned* agg;
  unsigned* incl;
};

// Scratch layout for `scans` scans over n rows (nb = max(1, ceil(n /
// TILE)) tiles; ops/window.py scan_scratch_bytes mirrors it): first the
// zeroed part of every scan, Z = 16 + round_up(4 nb, 16) bytes each (the
// counter in the first 16 bytes, then the flags), then every scan's two
// payload arrays of nb * STATE_BYTES bytes.
long long tiles_of(long long n) {
  const long long nb = (n + TILE - 1) / TILE;
  return nb < 1 ? 1 : nb;
}

long long zeroed_bytes(long long nb) { return 16 + (4 * nb + 15) / 16 * 16; }

long long scratch_bytes(long long n, int scans) {
  const long long nb = tiles_of(n);
  return scans * (zeroed_bytes(nb) + 2 * nb * STATE_BYTES);
}

Status status_of(void* scratch, long long n, int s, int scans) {
  const long long nb = tiles_of(n);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  unsigned char* z = base + s * zeroed_bytes(nb);
  unsigned char* pay = base + scans * zeroed_bytes(nb) +
                       2 * s * nb * STATE_BYTES;
  return Status{reinterpret_cast<unsigned*>(z),
                reinterpret_cast<unsigned*>(z + 16),
                reinterpret_cast<unsigned*>(pay),
                reinterpret_cast<unsigned*>(pay + nb * STATE_BYTES)};
}

template <class T>
__device__ __forceinline__ void publish(const Status& st, int tile,
                                        const T& v, unsigned flag) {
  unsigned w[T::WORDS];
  memcpy(w, &v, sizeof(w));
  unsigned* slot = (flag == ST_INCL ? st.incl : st.agg) +
                   static_cast<long long>(tile) * (STATE_BYTES / 4);
#pragma unroll
  for (int i = 0; i < T::WORDS; ++i) slot[i] = w[i];
  store_release(st.flags + tile, flag);
}

template <class T>
__device__ __forceinline__ T read_state(const unsigned* slots, int tile,
                                        const T& like) {
  unsigned w[T::WORDS];
  const unsigned* slot = slots + static_cast<long long>(tile) *
                                     (STATE_BYTES / 4);
#pragma unroll
  for (int i = 0; i < T::WORDS; ++i) w[i] = load_relaxed(slot + i);
  T r = like;
  memcpy(&r, w, sizeof(w));
  return r;
}

// the exclusive prefix of `tile` (> 0), by warp 0: lane l reads tile
// t0 - l, waits for its flag, and the window's values up to the nearest
// inclusive prefix fold into one (the earlier tile on the left)
template <class P>
__device__ typename P::T look_back(const Status& st, int tile, int lane) {
  typedef typename P::T T;
  T excl = P::identity();
  for (int t0 = tile - 1;; t0 -= 32) {
    const int t = t0 - lane;
    unsigned f = ST_INCL;                 // before tile 0: an empty prefix
    if (t >= 0) {
      do {
        f = load_acquire(st.flags + t);
      } while (f == 0u);
    }
    T v = P::identity();
    if (t >= 0) v = read_state(f == ST_INCL ? st.incl : st.agg, t, v);
    const unsigned incl = __ballot_sync(FULL, f == ST_INCL);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    if (lane > stop) v = P::identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = shfl_down(v, d);
      if (lane + d < 32) v = P::op(y, v);
    }
    excl = P::op(shfl_idx(v, 0), excl);
    if (incl) break;
  }
  return excl;
}

template <class P>
__global__ void __launch_bounds__(THREADS)
    scan_onepass(P p, long long n, Status st) {
  typedef typename P::T T;
  __shared__ T s_warp[WARPS];
  __shared__ T s_pre;
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(st.counter, 1u));
  __syncthreads();
  const int tile = s_tile;
  const long long wbase = static_cast<long long>(tile) * TILE +
                          static_cast<long long>(warp) * (32 * IPT) + lane;
  T it[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const long long j = wbase + k * 32;
    it[k] = j < n ? p.load(j) : P::identity();
  }
  // the 32 rows of every load scanned at once (IPT independent warp
  // scans, so their shuffles overlap), then chained in index order: load
  // k's rows after the totals of loads 0..k-1
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const T y = shfl_up(it[k], d);
      if (lane >= d) it[k] = P::op(y, it[k]);
    }
  }
  T carry = P::identity();
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const T total = shfl_idx(it[k], 31);
    it[k] = P::op(carry, it[k]);
    carry = P::op(carry, total);
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    T v = lane < WARPS ? s_warp[lane] : P::identity();
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      const T y = shfl_up(v, d);
      if (lane >= d) v = P::op(y, v);
    }
    const T agg = shfl_idx(v, WARPS - 1);
    T ex = shfl_up(v, 1);
    if (lane == 0) ex = P::identity();
    if (lane < WARPS) s_warp[lane] = ex;
    T pre = P::identity();
    if (tile == 0) {
      if (lane == 0) publish(st, 0, agg, ST_INCL);
    } else {
      if (lane == 0) publish(st, tile, agg, ST_AGG);
      pre = look_back<P>(st, tile, lane);
      if (lane == 0) publish(st, tile, P::op(pre, agg), ST_INCL);
    }
    if (lane == 0) s_pre = pre;
  }
  __syncthreads();
  const T pre = P::op(s_pre, s_warp[warp]);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const long long j = wbase + k * 32;
    if (j < n) p.store(j, P::op(pre, it[k]));
  }
}

// one launch; the caller has zeroed the status (`zero_status`)
template <class P>
void run_scan(const P& p, long long n, const Status& st, cudaStream_t s) {
  if (n <= 0) return;
  static_assert(sizeof(typename P::T) <= STATE_BYTES,
                "a scan state fits a payload slot");
  scan_onepass<P><<<static_cast<unsigned>(tiles_of(n)), THREADS, 0, s>>>(
      p, n, st);
}

void zero_status(void* scratch, long long n, int scans, cudaStream_t s) {
  cudaMemsetAsync(scratch, 0, scans * zeroed_bytes(tiles_of(n)), s);
}

// ---- K12 -----------------------------------------------------------------

struct KeyCols {
  const void* v[MAX_KEYS];
  const unsigned char* m[MAX_KEYS];   // null: no NULLs
  int dt[MAX_KEYS];
  int nk;                             // keys in this launch
  int np;                             // the first np are partition keys
};

struct Pos3 {
  int a, b, c;
  static constexpr int WORDS = 3;
  template <class F>
  __device__ __forceinline__ void each(F f) {
    f(a);
    f(b);
    f(c);
  }
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
    const int i = static_cast<int>(j);
    return T{pstart[j] ? i : 0, q ? i : 0, q ? 1 : 0};
  }
  __device__ void store(long long j, const T& t) const {
    ppos[j] = t.a;
    peer_lo[j] = t.b;
    dense[j] = t.c;
  }
};

struct Pos2 {
  int a, b;
  static constexpr int WORDS = 2;
  template <class F>
  __device__ __forceinline__ void each(F f) {
    f(a);
    f(b);
  }
};

// backward: (min partition end, min peer end) at or after the row
struct PosBwd {
  typedef Pos2 T;
  const unsigned char* pstart;
  const unsigned char* peerstart;
  long long n;
  long long* plast;
  long long* peer_hi;
  __device__ static T identity() { return T{NONE32, NONE32}; }
  __device__ static T op(const T& x, const T& y) {
    return T{x.a < y.a ? x.a : y.a, x.b < y.b ? x.b : y.b};
  }
  __device__ T load(long long j) const {
    const long long i = n - 1 - j;
    const bool last = i == n - 1;
    const int r = static_cast<int>(i);
    return T{(last || pstart[i + 1]) ? r : NONE32,
             (last || peerstart[i + 1]) ? r : NONE32};
  }
  __device__ void store(long long j, const T& t) const {
    const long long i = n - 1 - j;
    plast[i] = t.a;
    peer_hi[i] = t.b;
  }
};

// ---- K12 flags: a warp a run of sorted rows ---------------------------------

constexpr int FLAG_ROWS = 2;     // rows a lane in bounds_flags (R below)

// pred[k] = the value of the row before row wbase + k * 32: the previous
// lane's; for lane 0 the previous load's lane 31, and for load 0's lane 0
// `first` (the warp's first row loads its predecessor itself)
template <int R, typename V>
__device__ __forceinline__ void predecessors(const V (&cur)[R], V first,
                                             int lane, V (&pred)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const V up = __shfl_up_sync(FULL, cur[k], 1);
    if (k == 0) {
      pred[k] = lane ? up : first;
    } else {
      const V last = __shfl_sync(FULL, cur[k - 1], 31);
      pred[k] = lane ? up : last;
    }
  }
}

// Bit k of `flag` |= row k's key (stored as S, compared as V; `mask`
// null: no NULLs) differs from its predecessor's, for the rows whose bit
// is still clear (`need`: a row reads no key past its first difference).
// Compared as the reference's `!=`: NULL slots are neutralized to 0
// (every NULL one group) and a change of the NULL flag is a change; -0.0
// equals +0.0, a NaN differs from all. A row gathers its value and mask
// once, through its row id r[k], when it or its successor needs them (the
// successor takes them from the lane before it); the warp's first row
// loads its predecessor's itself.
template <int R, typename S, typename V>
__device__ __forceinline__ void key_changes(
    const S* __restrict__ vals, const unsigned char* __restrict__ mask,
    const int (&r)[R], unsigned inb, int r_first, bool has_first,
    int lane, unsigned& flag) {
  const unsigned need = inb & ~flag;
  if (!__any_sync(FULL, need)) return;
  unsigned own = need;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const unsigned down = __shfl_down_sync(FULL, (need >> k) & 1u, 1);
    const unsigned next0 =
        k + 1 < R ? __shfl_sync(FULL, (need >> (k + 1)) & 1u, 0) : 0u;
    if (lane < 31 ? down : next0) own |= 1u << k;
  }
  V cur[R];
  int mk[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const bool o = (own >> k) & 1u;
    cur[k] = o ? static_cast<V>(vals[r[k]]) : V(0);
    mk[k] = mask == nullptr || (o && mask[r[k]] != 0);
  }
  const bool fo = has_first && (need & 1u);
  V f = fo ? static_cast<V>(vals[r_first]) : V(0);
  const int fm = mask == nullptr || (fo && mask[r_first] != 0);
  if (mask) {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (!mk[k]) cur[k] = V(0);
    if (!fm) f = V(0);
  }
  int pm[R];
  V pv[R];
  predecessors<R>(mk, fm, lane, pm);
  predecessors<R>(cur, f, lane, pv);
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (((need >> k) & 1u) && (pm[k] != mk[k] || cur[k] != pv[k]))
      flag |= 1u << k;
}

// R flag bits → R bool bytes (bit b → byte b, little-endian)
template <int R>
__device__ __forceinline__ unsigned long long spread(unsigned x) {
  unsigned long long r = 0;
#pragma unroll
  for (int b = 0; b < R; ++b)
    r |= static_cast<unsigned long long>((x >> b) & 1u) << (8 * b);
  return r;
}

// lane l stores the flags of the warp's rows w0 + R l .. w0 + R l + R - 1
// (bits R l % 32 .. of load R l / 32's ballot) as one R-byte store
template <int R>
__device__ __forceinline__ void store_flags(unsigned char* out,
                                            const unsigned (&bal)[R],
                                            long long w0, int lane,
                                            long long n) {
  constexpr int PER = 32 / R;               // lanes a ballot word feeds
  unsigned w = 0;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (lane / PER == k) w = bal[k];
  w >>= R * (lane % PER);
  const long long r0 = w0 + static_cast<long long>(R) * lane;
  if (r0 + R <= n) {
    const unsigned long long b = spread<R>(w);
    if (R == 8)
      *reinterpret_cast<unsigned long long*>(out + r0) = b;
    else if (R == 4)
      *reinterpret_cast<unsigned*>(out + r0) = static_cast<unsigned>(b);
    else if (R == 2)
      *reinterpret_cast<unsigned short*>(out + r0) =
          static_cast<unsigned short>(b);
    else
      out[r0] = static_cast<unsigned char>(b);
  } else {
    for (int b = 0; b < R && r0 + b < n; ++b)
      out[r0 + b] = static_cast<unsigned char>((w >> b) & 1u);
  }
}

// the inputs of K12's flags launch
struct FlagArgs {
  const void* perm;
  int perm64;
  const unsigned char* live;    // null: all live (or n_live given)
  const int* n_live;            // null, or the count of live rows that
                                // perm lists first: live is then i < n_live
  KeyCols keys;
  int accumulate;               // start from the flags already in the
                                // outputs (an earlier chunk of keys)
  unsigned char* pstart;        // 8-byte aligned
  unsigned char* peerstart;     // 8-byte aligned
  __device__ int row(long long j) const {
    return perm64 ? static_cast<int>(static_cast<const long long*>(perm)[j])
                  : static_cast<const int*>(perm)[j];
  }
};

// the key's type is dispatched once a key a warp's rows, not a row
template <int R>
__device__ __forceinline__ void key_dispatch(const KeyCols& k, int j,
                                             const int (&r)[R],
                                             unsigned inb, int rf, bool hf,
                                             int lane, unsigned& flag) {
  switch (k.dt[j]) {
    case DT_BOOL:
      key_changes<R, unsigned char, int>(
          static_cast<const unsigned char*>(k.v[j]), k.m[j], r, inb, rf, hf,
          lane, flag);
      break;
    case DT_I32:
      key_changes<R, int, int>(static_cast<const int*>(k.v[j]), k.m[j], r,
                               inb, rf, hf, lane, flag);
      break;
    case DT_I64:
      key_changes<R, long long, long long>(
          static_cast<const long long*>(k.v[j]), k.m[j], r, inb, rf, hf,
          lane, flag);
      break;
    default:
      key_changes<R, double, double>(static_cast<const double*>(k.v[j]),
                                     k.m[j], r, inb, rf, hf, lane, flag);
  }
}

// K12's flags, one warp a run of 32 R sorted rows (lane l of load k: row
// w0 + 32 k + l; bit k of a lane's flag words), no scan coupled to it:
// with accumulate, the flags already in the outputs first; then `live`
// (with n_live, the comparison i == n_live, nothing gathered), the
// partition keys into pstart, then the order keys into peerstart (which
// starts as pstart), each key skipped by the rows already flagged; the
// flags leave as packed R-byte stores.
template <int R>
__global__ void __launch_bounds__(THREADS)
    bounds_flags(FlagArgs p, long long n) {
  const int lane = threadIdx.x & 31;
  const long long w0 = (static_cast<long long>(blockIdx.x) * WARPS +
                        (threadIdx.x >> 5)) * (32 * R);
  if (w0 >= n) return;                      // the whole warp
  const long long wbase = w0 + lane;
  int r[R];
  unsigned inb = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long j = wbase + k * 32;
    const bool in = j < n;
    inb |= static_cast<unsigned>(in) << k;
    r[k] = in ? p.row(j) : 0;
  }
  const bool hf = lane == 0 && w0 > 0;
  const int rf = hf ? p.row(w0 - 1) : 0;
  unsigned ps = 0, qs = 0;
  if (p.accumulate) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long j = wbase + k * 32;
      if (j < n) {
        ps |= static_cast<unsigned>(p.pstart[j] != 0) << k;
        qs |= static_cast<unsigned>(p.peerstart[j] != 0) << k;
      }
    }
  }
  if (p.n_live) {
    const long long nl = *p.n_live;
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (wbase + k * 32 == nl && nl > 0) ps |= 1u << k;
    ps &= inb;
  } else if (p.live) {
    key_changes<R, unsigned char, int>(p.live, nullptr, r, inb, rf, hf,
                                       lane, ps);
  }
  for (int j = 0; j < p.keys.np; ++j)
    key_dispatch<R>(p.keys, j, r, inb, rf, hf, lane, ps);
  qs |= ps;
  for (int j = p.keys.np; j < p.keys.nk; ++j)
    key_dispatch<R>(p.keys, j, r, inb, rf, hf, lane, qs);
  if (wbase == 0) {            // row 0 starts both
    ps |= 1u;
    qs |= 1u;
  }
  unsigned bp[R], bq[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    bp[k] = __ballot_sync(FULL, (ps >> k) & 1u);
    bq[k] = __ballot_sync(FULL, (qs >> k) & 1u);
  }
  store_flags<R>(p.pstart, bp, w0, lane, n);
  store_flags<R>(p.peerstart, bq, w0, lane, n);
}

// ---- K13 -----------------------------------------------------------------

template <class A>
struct Acc {
  A s;
  int c;
  static constexpr int WORDS = sizeof(A) / 4 + 1;
  template <class F>
  __device__ __forceinline__ void each(F f) {
    f(s);
    f(c);
  }
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
  V v;
  int f;
  static constexpr int WORDS = sizeof(V) / 4 + 1;
  template <class F>
  __device__ __forceinline__ void each(F g) {
    g(v);
    g(f);
  }
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
  __device__ static T identity() { return T{V(0), 2}; }
  __device__ static T op(const T& x, const T& y) {
    if (y.f == 2) return x;
    if (x.f == 2 || y.f == 1) return y;
    return T{MAX ? vmax(x.v, y.v) : vmin(x.v, y.v), x.f};
  }
  __device__ T load(long long j) const {
    const long long i = reverse ? n - 1 - j : j;
    const bool start = reverse ? (i == n - 1 || pstart[i + 1] != 0)
                               : pstart[i] != 0;
    const bool ok = valid == nullptr || valid[i] != 0;
    return T{ok ? vals[i] : ident, start ? 1 : 0};
  }
  __device__ void store(long long j, const T& t) const {
    out[reverse ? n - 1 - j : j] = t.v;
  }
};

// the key columns of one launch; false on a type code out of range
bool key_cols(const void* const* v, const void* const* m, const int* dt,
              int nk, int np, KeyCols* keys) {
  for (int j = 0; j < MAX_KEYS; ++j) {
    keys->v[j] = j < nk ? v[j] : nullptr;
    keys->m[j] = j < nk ? static_cast<const unsigned char*>(m[j]) : nullptr;
    keys->dt[j] = j < nk ? dt[j] : 0;
    if (j < nk && (dt[j] < DT_BOOL || dt[j] > DT_F64)) return false;
  }
  keys->nk = nk;
  keys->np = np;
  return true;
}

}  // namespace

extern "C" {

int tt_window_tile() { return TILE; }

// bytes of scratch `scans` scans over n rows take (the wrappers size it
// the same way: ops/window.py scan_scratch_bytes)
int tt_window_scratch_bytes(long long n, int scans) {
  if (n < 0 || n >= (1LL << 31) || scans < 1 || scans > 2) return -1;
  return static_cast<int>(scratch_bytes(n, scans));
}

// K12, flags: pstart / peerstart bool (n < 2^31; 8-byte aligned) over
// the sorted layout given by `perm` (int32, or int64 with perm64) from
// the keys' values v[j] (dtype dt[j]: 0 bool, 1 int32, 2 int64, 3
// float64) and masks m[j] (null: no NULLs), row-indexed; the first np
// keys are partition keys. `live` (bool, row-indexed; null: all live)
// starts a partition where it changes. n_live (a device int32, or null):
// the count of live rows, when perm lists every live row first; `live`
// is then not read. With accumulate the flags already in the outputs are
// kept (keys beyond MAX_KEYS run as further launches). One warp a run of
// 32 FLAG_ROWS sorted rows. window_bounds runs tt_window_positions over
// the flags next.
int tt_window_bounds_flags(const void* perm, int perm64, const void* live,
                           const void* n_live, const void* const* v,
                           const void* const* m, const int* dt, int nk,
                           int np, long long n, int accumulate,
                           void* pstart, void* peerstart, void* stream) {
  if (n < 0 || n >= (1LL << 31) || nk < 0 || nk > MAX_KEYS || np < 0 ||
      np > nk ||
      ((reinterpret_cast<uintptr_t>(pstart) |
        reinterpret_cast<uintptr_t>(peerstart)) & 7u) != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  KeyCols keys;
  if (!key_cols(v, m, dt, nk, np, &keys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  FlagArgs f{perm, perm64, static_cast<const unsigned char*>(live),
             static_cast<const int*>(n_live), keys, accumulate,
             static_cast<unsigned char*>(pstart),
             static_cast<unsigned char*>(peerstart)};
  constexpr long long rows = 32LL * FLAG_ROWS * WARPS;    // a block's
  bounds_flags<FLAG_ROWS><<<static_cast<unsigned>((n + rows - 1) / rows),
                            THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      f, n);
  return static_cast<int>(cudaGetLastError());
}

// K12, positions: from pstart / peerstart bool (n < 2^31; pstart[0] and
// peerstart[0] set, pstart a subset of peerstart) → int64 (n) ppos,
// plast, peer_lo, peer_hi and dense (inclusive count of peer starts).
// Scratch: tt_window_scratch_bytes(n, 2) bytes.
int tt_window_positions(const void* pstart, const void* peerstart,
                        long long n, void* ppos, void* plast, void* peer_lo,
                        void* peer_hi, void* dense, void* scratch,
                        void* stream) {
  if (n < 0 || n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* ps = static_cast<const unsigned char*>(pstart);
  const unsigned char* qs = static_cast<const unsigned char*>(peerstart);
  zero_status(scratch, n, 2, st);
  PosFwd f{ps, qs, static_cast<long long*>(ppos),
           static_cast<long long*>(peer_lo), static_cast<long long*>(dense)};
  run_scan(f, n, status_of(scratch, n, 0, 2), st);
  PosBwd b{ps, qs, n, static_cast<long long*>(plast),
           static_cast<long long*>(peer_hi)};
  run_scan(b, n, status_of(scratch, n, 1, 2), st);
  return static_cast<int>(cudaGetLastError());
}

// K13, prefix: inclusive prefix of the masked values (vdt 1 int32, 2
// int64 → int64 cum, wrapping; 3 float64 → float64 cum; vals null: no
// cum) and of the valid count (ccnt int64; null: none). valid null: all.
// n < 2^31; scratch: tt_window_scratch_bytes(n, 1) bytes.
int tt_window_prefix(const void* vals, int vdt, const void* valid,
                     long long n, void* cum, void* ccnt, void* scratch,
                     void* stream) {
  if (n < 0 || n >= (1LL << 31) ||
      (vals && (vdt < DT_I32 || vdt > DT_F64)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* ok = static_cast<const unsigned char*>(valid);
  long long* cc = static_cast<long long*>(ccnt);
  zero_status(scratch, n, 1, st);
  const Status status = status_of(scratch, n, 0, 1);
  if (vals && vdt == DT_F64) {
    Prefix<double, double> p{static_cast<const double*>(vals), ok,
                             static_cast<double*>(cum), cc};
    run_scan(p, n, status, st);
  } else if (vals && vdt == DT_I32) {
    Prefix<int, long long> p{static_cast<const int*>(vals), ok,
                             static_cast<long long*>(cum), cc};
    run_scan(p, n, status, st);
  } else {
    Prefix<long long, long long> p{static_cast<const long long*>(vals), ok,
                                   vals ? static_cast<long long*>(cum)
                                        : nullptr, cc};
    run_scan(p, n, status, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13, segmented min/max: out (n, the values' dtype vdt 1 int32, 2 int64,
// 3 float64) = the inclusive scan of valid ? vals : ident within the
// partitions pstart marks; reverse scans from each partition's end
// backwards (the suffix of [row, partition end]). ident_i / ident_f: the
// identity as an integer / a double. n < 2^31; scratch:
// tt_window_scratch_bytes(n, 1) bytes.
int tt_window_segscan(const void* vals, int vdt, const void* valid,
                      const void* pstart, long long n, int is_max,
                      int reverse, long long ident_i, double ident_f,
                      void* out, void* scratch, void* stream) {
  if (n < 0 || n >= (1LL << 31) || vdt < DT_I32 || vdt > DT_F64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* ok = static_cast<const unsigned char*>(valid);
  const unsigned char* ps = static_cast<const unsigned char*>(pstart);
  zero_status(scratch, n, 1, st);
  const Status status = status_of(scratch, n, 0, 1);
#define TT_SEG(V, ID)                                                     \
  if (is_max) {                                                           \
    SegScan<V, true> p{static_cast<const V*>(vals), ok, ps,               \
                       static_cast<V>(ID), reverse, n, static_cast<V*>(out)}; \
    run_scan(p, n, status, st);                                           \
  } else {                                                                \
    SegScan<V, false> p{static_cast<const V*>(vals), ok, ps,              \
                        static_cast<V>(ID), reverse, n, static_cast<V*>(out)}; \
    run_scan(p, n, status, st);                                           \
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
