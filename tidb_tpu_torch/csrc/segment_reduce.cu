// K1 segment_reduce — grouped SUM / MIN / MAX of one value column by
// int32 group ids into `cap` slots.
//
// Replaces: tidb_tpu/ops/segment.py segment_sum / segment_min /
// segment_max (and, through them, segment_count / segment_any /
// segment_first and the f64 branch of segment_sum_accurate). On the TPU
// those lower to a masked broadcast-reduce (scatter is slow there); on
// Hopper each cap range gets the accumulator that keeps its rows off a
// serializing atomic.
//
// What bounds it on an H100: bytes. Each row is read once (8 B value +
// 4 B gid for int64/f64, 1 B + 4 B for a bool mask); at a Q1 slab of
// 8,388,608 rows that is ~100 MB, ~30 us at 3.35 TB/s. The first design
// (one shared-memory atomic a row into a block-private accumulator) ran
// at about 700 GB/s at Q1's cap of 12: 256 threads a block serialized on
// 13 addresses.
//
// Design, by cap:
//  * cap <= SMALL_CAP (32; Q1's 12, Q6's 1): no atomics. Every thread
//    owns a column of a [cap][THREADS] shared accumulator (lane-private,
//    bank-conflict free: a warp's 32 threads touch 32 consecutive words)
//    and folds its rows into it in row order. A block takes one
//    contiguous range of row quads; thread t reads quads t, t + THREADS,
//    ... of it with 128-bit loads (4 gids, and 2 int64/f64, 4 int32 or 4
//    bool values a load), four quads in flight. Each slot then folds over
//    the warp's lanes by a fixed xor-shuffle tree, over the block's warps
//    in warp order, and the block partials (slot-major in the scratch)
//    fold in block order inside the last block to finish, which a
//    completion counter finds and which resets the counter for the next
//    call. One launch; every order is fixed by (n, cap, grid), and the
//    grid by the card, so f64 sums are bit-reproducible from call to
//    call and integer sums exact.
//  * SMALL_CAP < cap <= MID_CAP (4096): a block-private shared
//    accumulator updated by warp-aggregated shared atomics: the lanes of
//    a warp that hold one gid (__match_any_sync) reduce their values by
//    a shuffle tree over their ranks and the group's first lane issues
//    one atomic, so a skewed gid column costs one atomic a warp, not 32
//    serialized ones. The main path's calls here are skewed: a scalar
//    aggregate puts every row in slot 0 of its 1,024-slot hash capacity
//    (Q6), ROLLUP a third of them in one of ~30 (measured on an H100 at
//    8,388,608 rows: 0.13 ms against 0.62 for one shared atomic a row,
//    0.12 against 0.28; over uniform gids, which no main-path call has,
//    the two are within 8%). The block partials fold slot by slot in
//    block order in a second launch.
//  * cap > MID_CAP (factorize caps): the same warp aggregation on global
//    atomics into the output, set to the identity first (a memset for
//    SUM, a fill launch for MIN/MAX). f64 sums there follow the order the
//    atomics land in.
//  * Rows whose gid is < 0 or >= cap contribute nothing (the dead-row
//    padding convention of the JAX package's segment ops).
//  * Input types: int64, int32, float64 reduce in their own type; a bool
//    mask (1 byte a row) reduces natively as int32 or int64 (COUNT,
//    ANY), so no conversion pass runs before the kernel.
//  * The grid is the card's SMs times the blocks resident on each (at
//    most MAX_RESIDENT for the small and mid caps: more blocks add block
//    partials to fold, and four 256-thread blocks an SM keep enough
//    128-bit loads in flight). `tt_segment_plan` gives it with the
//    scratch it needs, once per shape; the wrapper caches both, and the
//    shape's parameter block with them.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMALL_CAP = 32;
constexpr int MID_CAP = 4096;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_RESIDENT = 4;
constexpr int UNROLL = 4;                    // quads in flight a thread
constexpr long long MID_FOLD = 1LL << 20;   // block partials a mid fold reads
constexpr unsigned FULL = 0xffffffffu;
constexpr int COUNTER_BYTES = 16;            // the small path's counter

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };
enum { DT_I64 = 0, DT_I32 = 1, DT_F64 = 2, DT_BOOL = 3 };
enum { PATH_SMALL = 0, PATH_MID = 1, PATH_LARGE = 2 };

template <int OP>
__device__ __forceinline__ long long combine(long long a, long long b) {
  if (OP == OP_SUM)
    return static_cast<long long>(static_cast<unsigned long long>(a) +
                                  static_cast<unsigned long long>(b));
  if (OP == OP_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <int OP>
__device__ __forceinline__ int combine(int a, int b) {
  if (OP == OP_SUM)
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  if (OP == OP_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <int OP>
__device__ __forceinline__ double combine(double a, double b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <int OP>
__device__ __forceinline__ void atomic_op(long long* p, long long v) {
  if (OP == OP_SUM)
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(v));
  else if (OP == OP_MIN)
    atomicMin(p, v);
  else
    atomicMax(p, v);
}

template <int OP>
__device__ __forceinline__ void atomic_op(int* p, int v) {
  if (OP == OP_SUM)
    atomicAdd(reinterpret_cast<unsigned*>(p), static_cast<unsigned>(v));
  else if (OP == OP_MIN)
    atomicMin(p, v);
  else
    atomicMax(p, v);
}

template <int OP>
__device__ __forceinline__ void atomic_op(double* p, double v) {
  if (OP == OP_SUM) {
    atomicAdd(p, v);
    return;
  }
  unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *a;
  unsigned long long assumed;
  do {
    assumed = old;
    const double cur = __longlong_as_double(assumed);
    const bool better = (OP == OP_MIN) ? (v < cur) : (v > cur);
    if (!better) return;
    old = atomicCAS(a, assumed, __double_as_longlong(v));
  } while (assumed != old);
}

// ---- row quads ------------------------------------------------------------

// the four values of a quad from a 16-byte aligned source (two 16-byte
// loads for 8-byte values; one 4-byte load of a bool quad), streaming
__device__ __forceinline__ void vload4(const long long* p, long long (&v)[4]) {
  const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void vload4(const double* p, double (&v)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void vload4(const int* p, int (&v)[4]) {
  const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void vload4(const unsigned char* p,
                                       unsigned char (&v)[4]) {
  const uchar4 a = __ldcs(reinterpret_cast<const uchar4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// quad q: rows 4q .. 4q+3 (a row past n reads as gid -1, so it drops);
// `vec`: the sources are aligned for the vector loads
template <typename In>
__device__ __forceinline__ void load_quad(const In* __restrict__ data,
                                          const int* __restrict__ gids,
                                          long long q, long long n, bool vec,
                                          int (&g)[4], In (&v)[4]) {
  const long long r0 = q * 4;
  if (vec && r0 + 4 <= n) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(gids + r0));
    g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
    vload4(data + r0, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = r0 + j < n;
    g[j] = in ? gids[r0 + j] : -1;
    v[j] = in ? data[r0 + j] : In(0);
  }
}

// a row's value in the accumulator's type (a bool counts as 0 / 1)
template <typename T, typename In>
__device__ __forceinline__ T as_acc(In v) { return static_cast<T>(v); }
template <>
__device__ __forceinline__ int as_acc<int, unsigned char>(unsigned char v) {
  return v != 0 ? 1 : 0;
}
template <>
__device__ __forceinline__ long long as_acc<long long, unsigned char>(
    unsigned char v) {
  return v != 0 ? 1 : 0;
}

// the block's contiguous range of quads [q0, q1)
__device__ __forceinline__ void block_range(long long n, long long* q0,
                                            long long* q1) {
  const long long nq = (n + 3) >> 2;
  const long long per = (nq + gridDim.x - 1) / gridDim.x;
  *q0 = static_cast<long long>(blockIdx.x) * per;
  const long long e = *q0 + per;
  *q1 = e < nq ? e : nq;
}

template <typename T, int OP>
__device__ __forceinline__ T warp_fold(T x) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1)
    x = combine<OP>(x, __shfl_xor_sync(FULL, x, d));
  return x;
}

// ---- cap <= SMALL_CAP ------------------------------------------------------

template <typename T, typename In, int OP>
__device__ __forceinline__ void add_quad(T* __restrict__ mine, int cap,
                                         const int (&g)[4],
                                         const In (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (static_cast<unsigned>(g[j]) < static_cast<unsigned>(cap)) {
      T* a = mine + g[j] * THREADS;
      *a = combine<OP>(*a, as_acc<T>(v[j]));
    }
  }
}

template <typename In, typename T, int OP>
__global__ void __launch_bounds__(THREADS)
    small_cap(const In* __restrict__ data, const int* __restrict__ gids,
              long long n, int cap, T ident, int vec,
              T* __restrict__ partials, unsigned* __restrict__ done,
              T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_warp[WARPS][SMALL_CAP];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* mine = reinterpret_cast<T*>(smem_raw) + tid;   // column tid of [cap][T]
  for (int c = 0; c < cap; ++c) mine[c * THREADS] = ident;
  long long q0, q1;
  block_range(n, &q0, &q1);
  long long q = q0 + tid;
  for (; q + (UNROLL - 1) * THREADS < q1; q += UNROLL * THREADS) {
    int g[UNROLL][4];
    In v[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_quad(data, gids, q + u * THREADS, n, vec, g[u], v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      add_quad<T, In, OP>(mine, cap, g[u], v[u]);
  }
  for (; q < q1; q += THREADS) {
    int g0[4];
    In v0[4];
    load_quad(data, gids, q, n, vec, g0, v0);
    add_quad<T, In, OP>(mine, cap, g0, v0);
  }
  for (int c = 0; c < cap; ++c) {
    const T x = warp_fold<T, OP>(mine[c * THREADS]);
    if (lane == 0) s_warp[warp][c] = x;
  }
  __syncthreads();
  if (tid < cap) {
    T x = s_warp[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) x = combine<OP>(x, s_warp[w][tid]);
    partials[static_cast<long long>(tid) * gridDim.x + blockIdx.x] = x;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: each slot over the block partials, lane l taking
  // blocks l, l + 32, ... in order, then the xor tree
  for (int c = warp; c < cap; c += WARPS) {
    const T* p = partials + static_cast<long long>(c) * gridDim.x;
    T x = ident;
    for (unsigned b = lane; b < gridDim.x; b += 32)
      x = combine<OP>(x, __ldcg(p + b));
    x = warp_fold<T, OP>(x);
    if (lane == 0) out[c] = x;
  }
  if (tid == 0) *done = 0u;    // ready for the next call on this scratch
}

// ---- warp aggregation (mid and large caps) ---------------------------------

// Every lane of the warp calls this with its row (ok: the gid is in
// range). Lanes that share a gid fold their values by a shuffle tree
// over their ranks in the group; the group's first lane gets the total.
// → true on the lanes that must issue the group's update (with *x the
// group's total).
template <typename T, int OP>
__device__ __forceinline__ bool aggregate(int g, bool ok, T* x, int lane) {
  const unsigned peers = __match_any_sync(FULL, ok ? g : -1);
  const unsigned size = __popc(peers);
  const unsigned most = __reduce_max_sync(FULL, ok ? size : 0u);
  if (most <= 1u) return ok;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);    // the group's later lanes
  T s = *x;
  int removed = 0;
  for (int d = 1; d < static_cast<int>(most); d <<= 1) {
    for (; removed < d - 1; ++removed) above &= above - 1u;
    const int partner = above ? __ffs(above) - 1 : lane;
    const T y = __shfl_sync(FULL, s, partner);
    if ((rank & (2 * d - 1)) == 0 && above) s = combine<OP>(s, y);
  }
  *x = s;
  return ok && rank == 0;
}

template <typename In, typename T, int OP>
__global__ void __launch_bounds__(THREADS)
    mid_cap(const In* __restrict__ data, const int* __restrict__ gids,
            long long n, int cap, T ident, int vec,
            T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < cap; c += THREADS) acc[c] = ident;
  __syncthreads();
  long long q0, q1;
  block_range(n, &q0, &q1);
  // every thread runs the same trip count (the warp votes need all 32)
  for (long long base = q0; base < q1; base += THREADS) {
    const long long q = base + threadIdx.x;
    int g[4] = {-1, -1, -1, -1};
    In v[4] = {In(0), In(0), In(0), In(0)};
    if (q < q1) load_quad(data, gids, q, n, vec, g, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T x = as_acc<T>(v[j]);
      const bool ok = static_cast<unsigned>(g[j]) < static_cast<unsigned>(cap);
      if (aggregate<T, OP>(g[j], ok, &x, lane)) atomic_op<OP>(&acc[g[j]], x);
    }
  }
  __syncthreads();
  T* part = partials + static_cast<long long>(blockIdx.x) * cap;
  for (int c = threadIdx.x; c < cap; c += THREADS) part[c] = acc[c];
}

template <typename T, int OP>
__global__ void fold_partials(const T* __restrict__ partials, int nblocks,
                              int cap, T ident, T* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cap) return;
  T a = ident;
  for (int b = 0; b < nblocks; ++b)
    a = combine<OP>(a, partials[static_cast<long long>(b) * cap + c]);
  out[c] = a;
}

// ---- cap > MID_CAP --------------------------------------------------------

template <typename T>
__global__ void fill(T* __restrict__ out, int cap, T v) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < cap) out[c] = v;
}

template <typename In, typename T, int OP>
__global__ void __launch_bounds__(THREADS)
    large_cap(const In* __restrict__ data, const int* __restrict__ gids,
              long long n, int cap, int vec, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long nq = (n + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS;
       base < nq; base += stride) {
    const long long q = base + threadIdx.x;
    int g[4] = {-1, -1, -1, -1};
    In v[4] = {In(0), In(0), In(0), In(0)};
    if (q < nq) load_quad(data, gids, q, n, vec, g, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T x = as_acc<T>(v[j]);
      const bool ok = static_cast<unsigned>(g[j]) < static_cast<unsigned>(cap);
      if (aggregate<T, OP>(g[j], ok, &x, lane)) atomic_op<OP>(&out[g[j]], x);
    }
  }
}

// ---- host side ------------------------------------------------------------

template <typename T>
T identity(int op);

template <>
long long identity<long long>(int op) {
  if (op == OP_SUM) return 0;
  return op == OP_MIN ? INT64_MAX : INT64_MIN;
}

template <>
int identity<int>(int op) {
  if (op == OP_SUM) return 0;
  return op == OP_MIN ? INT32_MAX : INT32_MIN;
}

template <>
double identity<double>(int op) {
  if (op == OP_SUM) return 0.0;
  return op == OP_MIN ? __builtin_huge_val() : -__builtin_huge_val();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

long long min_ll(long long a, long long b) { return a < b ? a : b; }

// one shape's plan: the path, the grid and the scratch bytes
struct Plan {
  long long path, grid, scratch;
};

template <typename In, typename T, int OP>
int plan(long long n, int cap, Plan* p) {
  const long long quad_blocks = ceil_div((n + 3) / 4, THREADS);
  const long long need = quad_blocks < 1 ? 1 : quad_blocks;
  int per = 0;
  if (cap <= SMALL_CAP) {
    const size_t smem = static_cast<size_t>(cap) * THREADS * sizeof(T);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(small_cap<In, T, OP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, small_cap<In, T, OP>, THREADS, smem);
    per = per < 1 ? 1 : (per > MAX_RESIDENT ? MAX_RESIDENT : per);
    p->path = PATH_SMALL;
    p->grid = min_ll(need, static_cast<long long>(sm_count()) * per);
    p->scratch = COUNTER_BYTES + p->grid * cap * sizeof(T);
  } else if (cap <= MID_CAP) {
    const size_t smem = static_cast<size_t>(cap) * sizeof(T);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, mid_cap<In, T, OP>, THREADS, smem);
    per = per < 1 ? 1 : (per > MAX_RESIDENT ? MAX_RESIDENT : per);
    long long most = static_cast<long long>(sm_count()) * per;
    const long long fold = MID_FOLD / cap;
    most = min_ll(most, fold > sm_count() ? fold : sm_count());
    p->path = PATH_MID;
    p->grid = min_ll(need, most);
    p->scratch = COUNTER_BYTES + p->grid * cap * sizeof(T);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, large_cap<In, T, OP>, THREADS, 0);
    p->path = PATH_LARGE;
    p->grid = min_ll(need, static_cast<long long>(sm_count()) *
                               (per < 1 ? 1 : per));
    p->scratch = COUNTER_BYTES;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename T, int OP>
void launch(const void* data, const int* gids, long long n, int cap,
            void* out, void* scratch, const Plan& p, cudaStream_t st) {
  const In* d = static_cast<const In*>(data);
  T* o = static_cast<T*>(out);
  const T ident = identity<T>(OP);
  const int vec =
      ((reinterpret_cast<uintptr_t>(gids) & 15u) == 0u) &&
      ((reinterpret_cast<uintptr_t>(data) &
        (sizeof(In) >= 4 ? 15u : 4u * sizeof(In) - 1u)) == 0u);
  const unsigned grid = static_cast<unsigned>(p.grid);
  if (p.path == PATH_SMALL) {
    unsigned char* s = static_cast<unsigned char*>(scratch);
    const size_t smem = static_cast<size_t>(cap) * THREADS * sizeof(T);
    small_cap<In, T, OP><<<grid, THREADS, smem, st>>>(
        d, gids, n, cap, ident, vec,
        reinterpret_cast<T*>(s + COUNTER_BYTES),
        reinterpret_cast<unsigned*>(s), o);
  } else if (p.path == PATH_MID) {
    T* part = reinterpret_cast<T*>(static_cast<unsigned char*>(scratch) +
                                   COUNTER_BYTES);
    const size_t smem = static_cast<size_t>(cap) * sizeof(T);
    mid_cap<In, T, OP><<<grid, THREADS, smem, st>>>(d, gids, n, cap, ident,
                                                    vec, part);
    fold_partials<T, OP><<<static_cast<unsigned>(ceil_div(cap, THREADS)),
                           THREADS, 0, st>>>(part, static_cast<int>(grid),
                                             cap, ident, o);
  } else {
    if (OP == OP_SUM)
      cudaMemsetAsync(o, 0, static_cast<size_t>(cap) * sizeof(T), st);
    else
      fill<T><<<static_cast<unsigned>(ceil_div(cap, THREADS)), THREADS, 0,
                st>>>(o, cap, ident);
    if (n > 0)
      large_cap<In, T, OP><<<grid, THREADS, 0, st>>>(d, gids, n, cap, vec,
                                                     o);
  }
}

// the (input type, accumulator type, op) instantiation of one call:
// mode 0 plans, mode 1 launches
template <typename In, typename T>
int by_op(int op, int mode, const void* data, const int* gids, long long n,
          int cap, void* out, void* scratch, Plan* p, cudaStream_t st) {
  if (op == OP_SUM) {
    if (mode == 0) return plan<In, T, OP_SUM>(n, cap, p);
    launch<In, T, OP_SUM>(data, gids, n, cap, out, scratch, *p, st);
  } else if (op == OP_MIN) {
    if (mode == 0) return plan<In, T, OP_MIN>(n, cap, p);
    launch<In, T, OP_MIN>(data, gids, n, cap, out, scratch, *p, st);
  } else {
    if (mode == 0) return plan<In, T, OP_MAX>(n, cap, p);
    launch<In, T, OP_MAX>(data, gids, n, cap, out, scratch, *p, st);
  }
  return 0;
}

int route(int in_dt, int out_dt, int op, int mode, const void* data,
          const int* gids, long long n, int cap, void* out, void* scratch,
          Plan* p, cudaStream_t st) {
  if (op < OP_SUM || op > OP_MAX || cap <= 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dt == DT_I64 && out_dt == DT_I64)
    return by_op<long long, long long>(op, mode, data, gids, n, cap, out,
                                       scratch, p, st);
  if (in_dt == DT_I32 && out_dt == DT_I32)
    return by_op<int, int>(op, mode, data, gids, n, cap, out, scratch, p,
                           st);
  if (in_dt == DT_F64 && out_dt == DT_F64)
    return by_op<double, double>(op, mode, data, gids, n, cap, out, scratch,
                                 p, st);
  if (in_dt == DT_BOOL && out_dt == DT_I64)
    return by_op<unsigned char, long long>(op, mode, data, gids, n, cap, out,
                                           scratch, p, st);
  if (in_dt == DT_BOOL && out_dt == DT_I32)
    return by_op<unsigned char, int>(op, mode, data, gids, n, cap, out,
                                     scratch, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// in_dt: 0 int64, 1 int32, 2 float64, 3 bool; out_dt: 0 int64, 1 int32,
// 2 float64 (the input's own type, or int32/int64 for bool). op: 0 sum,
// 1 min, 2 max. plan (3 long longs) ← path (0 small, 1 mid, 2 large),
// grid, scratch bytes. Pure in (n, cap, types, op) on one card.
int tt_segment_plan(int in_dt, int out_dt, int op, long long n, int cap,
                    long long* plan) {
  cudaGetLastError();
  Plan p{0, 0, 0};
  const int rc = route(in_dt, out_dt, op, 0, nullptr, nullptr, n, cap,
                       nullptr, nullptr, &p, nullptr);
  plan[0] = p.path;
  plan[1] = p.grid;
  plan[2] = p.scratch;
  return rc;
}

// One shape's launch parameters (ops/segment.py `_SegPlan`), built once
// from tt_segment_plan's result and cached by the wrapper, which passes
// it with each call's pointers. out: cap elements of out_dt. scratch:
// the plan's bytes, whose first 16 bytes are the small path's completion
// counter: zero before the first call, and every call leaves it zero
// (the other paths keep their partials behind it).
struct SegPlan {
  long long n;
  long long path;
  long long grid;
  int in_dt;
  int out_dt;
  int op;
  int cap;
};

int tt_segment_reduce(const void* plan, const void* data, const int* gids,
                      void* out, void* scratch, void* stream) {
  const SegPlan& a = *static_cast<const SegPlan*>(plan);
  if (a.grid < 1 || a.path < PATH_SMALL || a.path > PATH_LARGE ||
      (a.path == PATH_SMALL) != (a.cap <= SMALL_CAP) ||
      (a.path == PATH_LARGE) != (a.cap > MID_CAP))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launches
  Plan p{a.path, a.grid, 0};
  const int rc = route(a.in_dt, a.out_dt, a.op, 1, data, gids, a.n, a.cap,
                       out, scratch, &p, static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// the size of SegPlan, which the wrapper's ctypes block must match
int tt_segment_plan_bytes(void) { return static_cast<int>(sizeof(SegPlan)); }

int tt_segment_small_cap(void) { return SMALL_CAP; }

int tt_segment_mid_cap(void) { return MID_CAP; }

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
