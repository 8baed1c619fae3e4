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
// into lut (-1 filled by the wrapper; for a duplicated code any one of its
// rows, as with JAX's unordered scatter) and keeps the largest count of a
// real code: the build side is unique iff it is <= 1. On request it also
// writes each row's code (int32, the sentinel for dead rows) for K6.
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
// once and scatters 4-8 B a row into cnt/lut; K5 reads the probe keys and
// masks once and writes 5-8 B a row. The tables of a dimension build
// (1.5M codes, 6 MB a table) sit in the 50 MB L2, so the scattered and
// gathered table traffic mostly never reaches HBM.
//
// Design. K4: one row per thread in a grid-stride loop. The sentinel
// count and the largest count are aggregated per warp (ballot,
// __reduce_max_sync) and per block in shared memory before one global
// atomic per block: a filtered build sends most of its rows to the
// single sentinel slot, and one atomic per row there would serialize the
// kernel. K5: four rows a thread a step over a grid sized from the SM
// count and the kernel's occupancy: a 16-byte load of four int32 keys
// (two of four int64 keys), one 4-byte word of each mask and of live,
// the four independent table reads, then a 16-byte store of out_a and a
// 4-byte (unique) or 16-byte (multi) store of out_b. (Eight rows a step,
// and evict-first hints on the row streams, measured no faster: the
// random table reads bound it, as they bound torch.take.) A torch view
// may start anywhere: a key column off its 16-byte boundary is read
// with scalar loads, a mask or live off its 4-byte boundary as the two
// aligned words around its four bytes (funnel shift); the outputs, which
// the wrapper allocates, are aligned (the entry refuses them otherwise).
// The last n % 4 rows take one scalar step each. K5's arguments come as
// one struct (ProbeArgs) that the wrapper caches per key signature.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_KEYS = 4;

struct Keys {
  const void* vals[MAX_KEYS];
  const unsigned char* masks[MAX_KEYS];
  int is64[MAX_KEYS];
  long long lo[MAX_KEYS];
  long long hi[MAX_KEYS];
  long long stride[MAX_KEYS];
  int k;
};

// → the packed code of row i (each column clamped into its bounds) and
// whether every key is non-NULL and inside its bounds.
__device__ __forceinline__ bool pack_row(const Keys& K, long long i,
                                         long long* code) {
  bool ok = true;
  long long c = 0;
#pragma unroll
  for (int q = 0; q < MAX_KEYS; ++q) {
    if (q >= K.k) break;
    long long v = K.is64[q]
                      ? static_cast<const long long*>(K.vals[q])[i]
                      : static_cast<long long>(
                            static_cast<const int*>(K.vals[q])[i]);
    ok = ok && K.masks[q][i] && v >= K.lo[q] && v <= K.hi[q];
    v = v < K.lo[q] ? K.lo[q] : (v > K.hi[q] ? K.hi[q] : v);
    c += (v - K.lo[q]) * K.stride[q];
  }
  *code = c;
  return ok;
}

__global__ void __launch_bounds__(THREADS)
    lut_build_kernel(Keys K, const unsigned char* __restrict__ live,
                     long long n_live, long long nb, long long domain,
                     int* __restrict__ cnt, int* __restrict__ lut,
                     int* __restrict__ codes, int* __restrict__ maxcnt) {
  __shared__ int s_sent;
  __shared__ int s_max;
  if (threadIdx.x == 0) {
    s_sent = 0;
    s_max = 0;
  }
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // every thread of a block runs the same number of rounds, so the warp
  // votes below always see all 32 lanes
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < nb; base += step) {
    const long long i = base + threadIdx.x;
    const bool valid = i < nb;
    long long code = domain;
    bool ok = false;
    if (valid) {
      ok = pack_row(K, i, &code) && i < n_live && (live == nullptr ||
                                                   live[i]);
      if (!ok) code = domain;
      if (codes != nullptr) codes[i] = static_cast<int>(code);
    }
    int c = 0;
    if (ok) {
      c = atomicAdd(&cnt[code], 1) + 1;
      if (lut != nullptr) lut[code] = static_cast<int>(i);
    }
    const unsigned sent = __ballot_sync(0xffffffffu, valid && !ok);
    const int wmax = __reduce_max_sync(0xffffffffu, c);
    if ((threadIdx.x & 31) == 0) {
      if (sent) atomicAdd(&s_sent, __popc(sent));
      if (wmax > 0) atomicMax(&s_max, wmax);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_sent) atomicAdd(&cnt[domain], s_sent);
    if (s_max) atomicMax(maxcnt, s_max);
  }
}

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

constexpr int VEC = 4;    // probe rows a group

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
  const unsigned char* live = static_cast<const unsigned char*>(A.live);
  // the last n % 4 rows, one a thread of block 0
  const long long i = groups * VEC + threadIdx.x;
  if (blockIdx.x == 0 && i < A.n) {
    bool ok = live == nullptr || live[i] != 0;
    long long code = 0;
    for (int q = 0; q < A.k; ++q) {
      const long long v =
          A.is64[q] ? static_cast<const long long*>(A.vals[q])[i]
                    : static_cast<long long>(
                          static_cast<const int*>(A.vals[q])[i]);
      const long long lo = A.lo[q], hi = A.hi[q];
      ok = ok && static_cast<const unsigned char*>(A.masks[q])[i] != 0 &&
           v >= lo && v <= hi;
      const long long c = v < lo ? lo : (v > hi ? hi : v);
      code += (c - lo) * A.stride[q];
    }
    int a, b;
    probe_out(A, code, ok, &a, &b);
    static_cast<int*>(A.out_a)[i] = a;
    if (A.unique_mode)
      static_cast<unsigned char*>(A.out_b)[i] = static_cast<unsigned char>(b);
    else
      static_cast<int*>(A.out_b)[i] = b;
  }
}

// blocks of K5: as many as the card holds at once, fewer for a short probe
int probe_grid(long long groups) {
  static int resident[64];             // per device ordinal, 0 = not asked
  int dev = 0;
  cudaGetDevice(&dev);
  int r = dev < 64 ? resident[dev] : 0;
  if (r == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lut_probe_kernel,
                                                  THREADS, 0);
    r = sms * per_sm;
    if (r < 1) r = 1;
    if (dev < 64) resident[dev] = r;
  }
  const long long want = (groups + THREADS - 1) / THREADS;
  return want < 1 ? 1 : (want < r ? static_cast<int>(want) : r);
}

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 16) b = 132 * 16;
  return b < 1 ? 1 : static_cast<int>(b);
}

bool load_keys(Keys* K, int k, const void* const* vals,
               const void* const* masks, const int* is64,
               const long long* lo, const long long* hi,
               const long long* stride) {
  if (k < 1 || k > MAX_KEYS) return false;
  for (int q = 0; q < MAX_KEYS; ++q) {
    const bool on = q < k;
    K->vals[q] = on ? vals[q] : nullptr;
    K->masks[q] = on ? static_cast<const unsigned char*>(masks[q]) : nullptr;
    K->is64[q] = on ? is64[q] : 0;
    K->lo[q] = on ? lo[q] : 0;
    K->hi[q] = on ? hi[q] : 0;
    K->stride[q] = on ? stride[q] : 0;
  }
  K->k = k;
  return true;
}

}  // namespace

extern "C" {

// K4. k key columns: vals[q] (int64 if is64[q] else int32), masks[q]
// (bool), bounds lo/hi and stride per key; live (bool, may be null) and
// the live prefix n_live; nb build rows; domain codes.
// cnt: int32 (domain + 1), zeroed by the caller; lut: int32 (domain + 1),
// -1 filled by the caller, or null; codes: int32 (nb) or null; maxcnt:
// one int32, zeroed by the caller.
int tt_lut_build(int k, const void* const* vals, const void* const* masks,
                 const int* is64, const long long* lo, const long long* hi,
                 const long long* stride, const void* live, long long n_live,
                 long long nb, long long domain, void* cnt, void* lut,
                 void* codes, void* maxcnt, void* stream) {
  Keys K;
  if (!load_keys(&K, k, vals, masks, is64, lo, hi, stride) || domain < 1 ||
      domain >= (1LL << 31) - 1 || nb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launch
  if (nb > 0)
    lut_build_kernel<<<grid_for(nb), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        K, static_cast<const unsigned char*>(live), n_live, nb, domain,
        static_cast<int*>(cnt), static_cast<int*>(lut),
        static_cast<int*>(codes), static_cast<int*>(maxcnt));
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
  cudaGetLastError();
  if (A.n > 0)
    lut_probe_kernel<<<probe_grid(A.n / VEC), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
