// K4 lut_build and K5 lut_probe — the LUT (bounded-key) equi-join.
//
// Replaces: tidb_tpu/ops/join.py pack_bounded_codes (both halves),
// the count/LUT scatters of lut_probe_unique and lut_probe_multi and their
// probe gathers, and the aligned-join cache builds of
// tidb_tpu/executor/device_cache.py get_aligned (_lut, _probe).
//
// K4 packs each build row's key columns into one dense code,
//   code = sum_q (clip(v_q, lo_q, hi_q) - lo_q) * stride_q,
// and sends NULL keys, out-of-domain keys and dead rows (the `live` mask,
// the `n_live` prefix) to the sentinel slot `domain`. It counts the rows
// of each code into cnt (domain + 1 slots, the sentinel counted too, so
// the build order of K6 can place dead rows), writes a row id of each code
// into lut (-1 where no row has the code; for a duplicated code any one of
// its rows, as with JAX's unordered scatter) and keeps the largest count
// of a real code: the build side is unique iff it is <= 1. On request it
// also writes each row's code (int32, the sentinel for dead rows) for K6.
//
// K5 packs each probe row the same way and gathers one table entry a
// row. Unique mode takes K4's lut, -1 filled by the wrapper and written
// by K4 for every counted row, so for a code below `domain`
// lut[code] >= 0 exactly when cnt[code] > 0: it writes
// match_idx = lut[code] clamped to [0, nb) (0 when unmatched) and
// matched = ok && lut[code] >= 0, and never reads cnt. Multi mode takes
// K6's starts, the exclusive scan of cnt over domain + 1 slots, and
// writes start = starts[code] and count = ok ? starts[code + 1] -
// starts[code] : 0 (two adjacent words, usually one sector).
//
// What bounds them on an H100: bytes. K4 reads the build keys and masks
// once, fills cnt and lut (8 B a code) and scatters 4-8 B a row into
// them; K5 reads the probe keys and masks once and writes 5-8 B a row.
// The tables of a dimension build (1.5M codes, 6 MB a table) sit in the
// 50 MB L2, so the scattered and gathered table traffic mostly never
// reaches HBM. At the orders build (2,097,152 rows) a whole K4 call is a
// few tens of µs, so the host work around it counts as much as the card's.
//
// Design. Both kernels run four rows a thread a step over a grid sized
// from the SM count and the kernel's occupancy, and take their arguments
// as one struct (BuildArgs, ProbeArgs) that the wrapper caches per key
// signature and fills with its pointers.
// K4: one C call a build of two launches. Its outputs are views of one
// allocation (maxcnt, cnt, lut, codes back to back,
// ops/join.build_layout), which the entry fills itself (`build_prep`: 0
// for maxcnt and cnt, -1 for lut) before the pass. A warp takes 128
// consecutive rows a step, lane l the rows 32 j + l of it: every load and
// the codes' store are coalesced whatever a view's offset, and a dense
// primary key's consecutive codes put each round's 32 atomics on 128
// consecutive bytes of cnt, which L2 merges (a lane's four consecutive
// rows, with 16-byte key loads, spread them over 512 bytes and measured
// 1.6-1.9x slower at the orders build on an H100 80GB HBM3 at 700 W). A
// lane issues its four rounds' `atomicAdd`s on cnt before any result is
// used. The sentinel count and the largest count stay in registers over
// a thread's steps and are reduced per warp and per block (shared
// memory) before one global atomic each a block: a filtered build sends
// most of its rows to the single sentinel slot, and one atomic per row
// there would serialize the kernel.
// K5: a thread's four consecutive rows: a 16-byte load of four int32
// keys (two of four int64 keys), one 4-byte word of each mask and of live
// (`pack_group`), the four independent table reads, then a 16-byte store
// of out_a and a 4-byte (unique) or 16-byte (multi) store of out_b.
// (Eight rows a step, and evict-first hints on the row streams, measured
// no faster: the random table reads bound it, as they bound torch.take.)
// A torch view may start anywhere: a key column off its 16-byte boundary
// is read with scalar loads, a mask or live off its 4-byte boundary as
// the two aligned words around its four bytes (funnel shift); the
// outputs, which the wrapper allocates, are aligned (the entry refuses
// them otherwise). The last n % 4 rows take one scalar step each
// (`pack_one`).
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_KEYS = 4;

// K5's arguments (ops/join.py _ProbeArgs mirrors the layout)
struct ProbeArgs {
  const void* vals[MAX_KEYS];
  const void* masks[MAX_KEYS];
  const void* live;            // may be null
  const void* table;           // lut (unique) or starts (multi)
  void* out_a;                 // int32 match_idx / start
  void* out_b;                 // bool matched / int32 count
  long long lo[MAX_KEYS];
  long long hi[MAX_KEYS];
  long long stride[MAX_KEYS];
  long long n;
  long long domain;
  int is64[MAX_KEYS];
  int k;
  int unique_mode;
  int nb;
  int reserved;
};

// K4's arguments (ops/join.py _BuildArgs mirrors the layout)
struct BuildArgs {
  const void* vals[MAX_KEYS];
  const void* masks[MAX_KEYS];
  const void* live;            // may be null
  void* out;                   // the outputs' one int32 allocation:
                               // maxcnt, cnt (domain + 1), lut (domain +
                               // 1, with BUILD_LUT), codes (nb, with
                               // BUILD_CODES), back to back
  long long lo[MAX_KEYS];
  long long hi[MAX_KEYS];
  long long stride[MAX_KEYS];
  long long nb;
  long long n_live;            // rows at or past it are dead
  long long domain;
  int is64[MAX_KEYS];
  int k;
  int flags;                   // BUILD_LUT | BUILD_CODES
};

enum { BUILD_LUT = 1, BUILD_CODES = 2 };

constexpr int VEC = 4;    // K5: rows a group

// keys of rows 4g .. 4g + 3
__device__ __forceinline__ void load_keys4(const void* p, int is64,
                                           long long g, long long v[VEC]) {
  if (is64) {
    const long long* q = static_cast<const long long*>(p) + VEC * g;
    if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
      const longlong2* q2 = reinterpret_cast<const longlong2*>(q);
      const longlong2 a = __ldg(q2);
      const longlong2 b = __ldg(q2 + 1);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = b.x;
      v[3] = b.y;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = __ldg(q + j);
    }
  } else {
    const int* q = static_cast<const int*>(p) + VEC * g;
    if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(q));
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = __ldg(q + j);
    }
  }
}

// the bytes of rows 4g .. 4g + 3 of a bool column as one word (byte j is
// row 4g + j); off its 4-byte boundary, from the two aligned words that
// hold them (both hold a byte of the column)
__device__ __forceinline__ unsigned load_bytes4(const unsigned char* p,
                                                long long g) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p + VEC * g);
  const unsigned s = static_cast<unsigned>(a & 3);
  const unsigned* w = reinterpret_cast<const unsigned*>(a - s);
  const unsigned lo = __ldg(w);
  if (s == 0) return lo;
  return __funnelshift_r(lo, __ldg(w + 1), 8 * s);
}

// one probe row's outputs from its packed code and flag
__device__ __forceinline__ void probe_out(const ProbeArgs& A, long long code,
                                          bool ok, int* a, int* b) {
  const int* table = static_cast<const int*>(A.table);
  code = code < 0 ? 0 : (code >= A.domain ? A.domain - 1 : code);
  if (A.unique_mode) {
    const int t = __ldg(table + code);
    const bool m = ok && t >= 0;
    *a = m ? (t >= A.nb ? A.nb - 1 : t) : 0;
    *b = m ? 1 : 0;
  } else {
    const int s = __ldg(table + code);
    *a = s;
    *b = ok ? __ldg(table + code + 1) - s : 0;
  }
}

// K5's rows 4g .. 4g + 3: their packed codes and, byte j of the word,
// whether row 4g + j is live, non-NULL and inside every key's bounds
__device__ __forceinline__ unsigned pack_group(const ProbeArgs& A,
                                               long long g,
                                               long long code[VEC]) {
  const unsigned char* live = static_cast<const unsigned char*>(A.live);
  unsigned ok = live ? load_bytes4(live, g) : 0x01010101u;
#pragma unroll
  for (int j = 0; j < VEC; ++j) code[j] = 0;
#pragma unroll
  for (int q = 0; q < MAX_KEYS; ++q) {
    if (q >= A.k) break;
    long long v[VEC];
    load_keys4(A.vals[q], A.is64[q], g, v);
    const unsigned m =
        load_bytes4(static_cast<const unsigned char*>(A.masks[q]), g);
    const long long lo = A.lo[q], hi = A.hi[q];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (!((m >> (8 * j)) & 0xffu) || v[j] < lo || v[j] > hi)
        ok &= ~(0xffu << (8 * j));
      const long long c = v[j] < lo ? lo : (v[j] > hi ? hi : v[j]);
      code[j] += (c - lo) * A.stride[q];
    }
  }
  return ok;
}

// row i alone (K4's rows, K5's last n % 4): its packed code and whether it
// is live, non-NULL and inside every key's bounds. Every load is made
// whatever the others read (no short-circuit), so a thread's rows issue
// all their loads before the first one returns.
template <typename Args>
__device__ __forceinline__ bool pack_one(const Args& A, long long i,
                                         long long* code) {
  const unsigned char* live = static_cast<const unsigned char*>(A.live);
  bool ok = live == nullptr ? true : live[i] != 0;
  long long c = 0;
#pragma unroll
  for (int q = 0; q < MAX_KEYS; ++q) {
    if (q >= A.k) break;
    const long long v =
        A.is64[q] ? static_cast<const long long*>(A.vals[q])[i]
                  : static_cast<long long>(
                        static_cast<const int*>(A.vals[q])[i]);
    const long long lo = A.lo[q], hi = A.hi[q];
    ok = ok & (static_cast<const unsigned char*>(A.masks[q])[i] != 0) &
         (v >= lo) & (v <= hi);
    const long long cv = v < lo ? lo : (v > hi ? hi : v);
    c += (cv - lo) * A.stride[q];
  }
  *code = c;
  return ok;
}

constexpr int BUILD_ROUNDS = 4;    // K4: rows a thread a warp step

// K4: one warp step of 32 * BUILD_ROUNDS consecutive rows from `base`,
// lane l taking rows base + 32 j + l (coalesced loads and code stores, and
// the counts' atomics of one round on consecutive codes when the keys are
// consecutive, as a dense primary key's are); every round's atomic issued
// before any result is used, then the lut stores; the rows not counted
// (sentinel) and the largest count folded into `sent` and `most`
__device__ __forceinline__ void build_step(const BuildArgs& A,
                                          int* __restrict__ cnt,
                                          int* __restrict__ lut,
                                          int* __restrict__ codes,
                                          long long base, int lane,
                                          int* sent, int* most) {
  long long code[BUILD_ROUNDS];
  bool on[BUILD_ROUNDS];
  int c[BUILD_ROUNDS];
#pragma unroll
  for (int j = 0; j < BUILD_ROUNDS; ++j) {
    const long long i = base + 32 * j + lane;
    // a row past nb reads the last row's slots and counts nothing
    const bool ok = pack_one(A, i < A.nb ? i : A.nb - 1, &code[j]);
    on[j] = ok & (i < A.nb) & (i < A.n_live);
  }
#pragma unroll
  for (int j = 0; j < BUILD_ROUNDS; ++j)
    c[j] = on[j] ? atomicAdd(&cnt[code[j]], 1) : 0;
#pragma unroll
  for (int j = 0; j < BUILD_ROUNDS; ++j) {
    const long long i = base + 32 * j + lane;
    if (i >= A.nb) continue;
    if (on[j]) {
      *most = c[j] + 1 > *most ? c[j] + 1 : *most;
      if (lut != nullptr) lut[code[j]] = static_cast<int>(i);
    } else {
      *sent += 1;
    }
    if (codes != nullptr)
      codes[i] = on[j] ? static_cast<int>(code[j])
                       : static_cast<int>(A.domain);
  }
}

// K4's fill before its pass: maxcnt and cnt (`zeros` words from `z`) to
// 0, lut (`ones` words from `f`) to -1, grid-stride
__global__ void __launch_bounds__(THREADS)
    build_prep(int* __restrict__ z, long long zeros, int* __restrict__ f,
               long long ones) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < zeros + ones; i += step) {
    if (i < zeros)
      z[i] = 0;
    else
      f[i - zeros] = -1;
  }
}

// K4: warp steps in a grid-stride loop over warps; the sentinel count and
// the largest count stay in registers over a thread's steps, then one
// shared atomic a warp and one global atomic a block each
__global__ void __launch_bounds__(THREADS)
    lut_build_kernel(BuildArgs A, int* __restrict__ cnt,
                     int* __restrict__ lut, int* __restrict__ codes,
                     int* __restrict__ maxcnt) {
  __shared__ int s_sent;
  __shared__ int s_max;
  if (threadIdx.x == 0) {
    s_sent = 0;
    s_max = 0;
  }
  __syncthreads();
  constexpr long long STEP = 32 * BUILD_ROUNDS;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
  int sent = 0, most = 0;
  for (long long w = static_cast<long long>(blockIdx.x) * (THREADS / 32) +
                     (threadIdx.x >> 5);
       w * STEP < A.nb; w += warps)
    build_step(A, cnt, lut, codes, w * STEP, lane, &sent, &most);
  sent = static_cast<int>(__reduce_add_sync(0xffffffffu,
                                            static_cast<unsigned>(sent)));
  most = __reduce_max_sync(0xffffffffu, most);
  if (lane == 0) {
    if (sent) atomicAdd(&s_sent, sent);
    if (most) atomicMax(&s_max, most);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_sent) atomicAdd(&cnt[A.domain], s_sent);
    if (s_max) atomicMax(maxcnt, s_max);
  }
}

__global__ void __launch_bounds__(THREADS) lut_probe_kernel(ProbeArgs A) {
  const long long groups = A.n / VEC;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += step) {
    long long code[VEC];
    const unsigned ok = pack_group(A, g, code);
    int a[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      probe_out(A, code[j], ((ok >> (8 * j)) & 0xffu) != 0u, &a[j], &b[j]);
    reinterpret_cast<int4*>(A.out_a)[g] = make_int4(a[0], a[1], a[2], a[3]);
    if (A.unique_mode)
      reinterpret_cast<unsigned*>(A.out_b)[g] =
          static_cast<unsigned>(b[0]) | (static_cast<unsigned>(b[1]) << 8) |
          (static_cast<unsigned>(b[2]) << 16) |
          (static_cast<unsigned>(b[3]) << 24);
    else
      reinterpret_cast<int4*>(A.out_b)[g] = make_int4(b[0], b[1], b[2], b[3]);
  }
  // the last n % 4 rows, one a thread of block 0
  const long long i = groups * VEC + threadIdx.x;
  if (blockIdx.x == 0 && i < A.n) {
    long long code;
    const bool ok = pack_one(A, i, &code);
    int a, b;
    probe_out(A, code, ok, &a, &b);
    static_cast<int*>(A.out_a)[i] = a;
    if (A.unique_mode)
      static_cast<unsigned char*>(A.out_b)[i] = static_cast<unsigned char>(b);
    else
      static_cast<int*>(A.out_b)[i] = b;
  }
}

// blocks of a kernel that wants `groups` threads: as many as the card
// holds at once, fewer for a short input (`resident`: the count per
// device ordinal, 0 = not asked yet)
template <typename K>
int vec_grid(K kernel, long long groups, int* resident) {
  int dev = 0;
  cudaGetDevice(&dev);
  int r = dev < 64 ? resident[dev] : 0;
  if (r == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                  0);
    r = sms * per_sm;
    if (r < 1) r = 1;
    if (dev < 64) resident[dev] = r;
  }
  const long long want = (groups + THREADS - 1) / THREADS;
  return want < 1 ? 1 : (want < r ? static_cast<int>(want) : r);
}

}  // namespace

extern "C" {

// K4. args: one BuildArgs (k key columns: vals[q], int64 if is64[q] else
// int32, masks[q] bool, bounds lo/hi and stride per key; live bool or
// null and the live prefix n_live; nb build rows; domain codes; `out` the
// outputs' allocation, laid out as BuildArgs says, every word written
// here: maxcnt, cnt (the sentinel slot `domain` too) and, with BUILD_LUT,
// lut (-1 where no row counted); with BUILD_CODES each row's code).
int tt_lut_build(const void* args, void* stream) {
  static int resident[64];
  const BuildArgs A = *static_cast<const BuildArgs*>(args);
  if (A.k < 1 || A.k > MAX_KEYS || A.domain < 1 ||
      A.domain >= (1LL << 31) - 1 || A.nb < 0 || A.nb >= (1LL << 31) ||
      A.out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our calls
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* maxcnt = static_cast<int*>(A.out);
  int* cnt = maxcnt + 1;
  int* lut = (A.flags & BUILD_LUT) ? cnt + A.domain + 1 : nullptr;
  int* codes = (A.flags & BUILD_CODES)
                   ? cnt + (lut ? 2 : 1) * (A.domain + 1) : nullptr;
  static int prep_resident[64];
  const long long fill = (A.domain + 2) + (lut ? A.domain + 1 : 0);
  build_prep<<<vec_grid(build_prep, fill, prep_resident), THREADS, 0,
               st>>>(maxcnt, A.domain + 2, lut, lut ? A.domain + 1 : 0);
  if (A.nb > 0)
    lut_build_kernel<<<vec_grid(lut_build_kernel,
                                (A.nb + 32 * BUILD_ROUNDS - 1) /
                                    (32 * BUILD_ROUNDS) * 32, resident),
                       THREADS, 0, st>>>(A, cnt, lut, codes, maxcnt);
  return static_cast<int>(cudaGetLastError());
}

// K5. args: one ProbeArgs (keys as for K4; live may be null; table of
// domain int32 in unique mode, K4's lut, -1 where no row counted; of
// domain + 1 int32 in multi mode, K6's starts). Unique mode: out_a int32
// match_idx (clamped to [0, nb)), out_b bool matched, 16- and 4-byte
// aligned. Multi mode: out_a int32 start, out_b int32 count, both
// 16-byte aligned.
int tt_lut_probe(const void* args, void* stream) {
  const ProbeArgs A = *static_cast<const ProbeArgs*>(args);
  if (A.k < 1 || A.k > MAX_KEYS || A.domain < 1 || A.nb < 1 || A.n < 0 ||
      A.table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(A.out_a) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(A.out_b) & (A.unique_mode ? 3 : 15)) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static int resident[64];
  cudaGetLastError();
  if (A.n > 0)
    lut_probe_kernel<<<vec_grid(lut_probe_kernel, A.n / VEC, resident),
                       THREADS, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
