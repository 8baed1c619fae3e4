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
// K5 packs each probe row the same way and gathers. Unique mode writes
// match_idx = lut[code] clamped to [0, nb) (0 when unmatched) and
// matched = ok && cnt[code] > 0; multi mode writes start = starts[code]
// (the exclusive scan of cnt, from K6) and count = ok ? cnt[code] : 0.
//
// What bounds them on an H100: bytes. K4 reads the build keys and masks
// once and scatters 4-8 B a row into cnt/lut; K5 reads the probe keys and
// masks once and writes 5-8 B a row. The tables of a dimension build
// (1.5M codes, 12 MB for cnt + lut) sit in the 50 MB L2, so the scattered
// and gathered table traffic mostly never reaches HBM.
//
// Design: one row per thread in a grid-stride loop. The sentinel count
// and the largest count are aggregated per warp (ballot, __reduce_max_sync)
// and per block in shared memory before one global atomic per block: a
// filtered build sends most of its rows to the single sentinel slot, and
// one atomic per row there would serialize the kernel.
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

__global__ void __launch_bounds__(THREADS)
    lut_probe_kernel(Keys K, const unsigned char* __restrict__ live,
                     long long n, long long domain,
                     const int* __restrict__ cnt,
                     const int* __restrict__ table, int unique_mode, int nb,
                     int* __restrict__ out_a, void* __restrict__ out_b) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    long long code;
    const bool ok = pack_row(K, i, &code) && (live == nullptr || live[i]);
    code = code < 0 ? 0 : (code >= domain ? domain - 1 : code);
    if (unique_mode) {
      const bool m = ok && cnt[code] > 0;
      int idx = m ? table[code] : 0;
      idx = idx < 0 ? 0 : (idx >= nb ? nb - 1 : idx);
      out_a[i] = idx;
      static_cast<unsigned char*>(out_b)[i] = m ? 1 : 0;
    } else {
      out_a[i] = table[code];
      static_cast<int*>(out_b)[i] = ok ? cnt[code] : 0;
    }
  }
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

// K5. Keys as for K4; live (bool, may be null); n probe rows. cnt and
// table (lut in unique mode, starts in multi mode) hold domain (+1) int32.
// Unique mode: out_a int32 match_idx (clamped to [0, nb)), out_b bool
// matched. Multi mode: out_a int32 start, out_b int32 count.
int tt_lut_probe(int k, const void* const* vals, const void* const* masks,
                 const int* is64, const long long* lo, const long long* hi,
                 const long long* stride, const void* live, long long n,
                 long long domain, const void* cnt, const void* table,
                 int unique_mode, int nb, void* out_a, void* out_b,
                 void* stream) {
  Keys K;
  if (!load_keys(&K, k, vals, masks, is64, lo, hi, stride) || domain < 1 ||
      nb < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n > 0)
    lut_probe_kernel<<<grid_for(n), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        K, static_cast<const unsigned char*>(live), n, domain,
        static_cast<const int*>(cnt), static_cast<const int*>(table),
        unique_mode, nb, static_cast<int*>(out_a), out_b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
