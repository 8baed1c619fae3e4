// K18 gather_columns — several (value, mask) columns gathered through one
// index vector, the masks cut to the slots below a device-held count.
//
// Replaces: the row gathers of tidb_tpu/executor/device_emit.py
// emit_distinct (the pair output: each group key and each raw DISTINCT
// argument column through rep[:pc], the masks AND-ed with
// pslot = iota < n_pairs) and of emit_agg's ROLLUP branch (key_out: each
// key and the level column through rep, AND-ed with iota < n_groups).
// In the reference these are jnp indexing inside the traced program.
//   out_v[c][s] = in_v[c][idx[s]]
//   out_m[c][s] = (in_m[c] ? in_m[c][idx[s]] : 1) && s < *n_valid
// n_valid is read on the device, so the caller never syncs for it. An
// index outside [0, n_src) gives a zero value and a false mask.
//
// What bounds it on an H100: not bytes (per output slot the index read
// once and per column one value of 1, 2, 4 or 8 bytes and one mask byte
// gathered and written) but random loads. Each gathered element is its
// own 32-byte L2 sector; at the main path's shapes (D2's pair output: 3
// columns of a 2,097,152-row slab, 36 MB in L2) the card serves about
// 100 G of them a second, in this kernel as in torch's index_select (one
// 2,097,152-row gather about 21 µs; tidb_tpu_torch/tools/scan_timing.py),
// so 5 gathers a slot take ~105 µs whatever the kernel's occupancy or
// loads in flight.
//
// Design:
//   * each thread takes SLOTS = 4 consecutive slots: one 16-byte load of
//     their int32 indices (two for int64) where the index vector is
//     16-byte aligned;
//   * the columns go in groups of GROUP = 4: every value and mask of the
//     group is loaded for the four slots (read-only, `__ldg`, from
//     `__restrict__` sources) before any of them is stored, so a thread
//     keeps up to 32 gathers in flight;
//   * the four values of a column leave as one store (4 bytes of 1-byte
//     values, 8 of 2-byte, 16 of 4-byte, two 16-byte stores of 8-byte
//     values) and the four mask bytes as one 32-bit store, all streaming
//     (evict-first) so the outputs do not push the sources out of L2;
//     the wrapper carves every output out of one allocation at 16-byte
//     aligned offsets, which these stores need (the entry checks);
//   * a column's width is uniform across the grid, so its dispatch is a
//     branch every warp takes the same way;
//   * calls of at most 4 columns pass a 4-column argument block, the
//     others a 64-column one; the grid is every SM at full residency
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), looping over the
//     slot quads; a tail of fewer than 4 slots is stored slot by slot.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_COLS = 64;
constexpr int SLOTS = 4;        // consecutive output slots a thread takes
constexpr int GROUP = 4;        // columns whose loads go out together
typedef unsigned long long u64;

// one launch's columns, sized for C columns (the kernel parameter)
template <int C>
struct Cols {
  const void* src[C];
  const unsigned char* msrc[C];   // null: every row valid
  void* dst[C];
  unsigned char* mdst[C];
  int bytes[C];
};

template <bool IDX64>
__device__ __forceinline__ void load_idx(const void* __restrict__ idx,
                                         long long s0, long long m, bool vec,
                                         long long* r) {
  if (vec) {
    if (IDX64) {
      const longlong2* p = reinterpret_cast<const longlong2*>(
          static_cast<const long long*>(idx) + s0);
      const longlong2 a = __ldcs(p), b = __ldcs(p + 1);
      r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
    } else {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(
          static_cast<const int*>(idx) + s0));
      r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const long long s = s0 + j;
    r[j] = s >= m ? -1
                  : (IDX64 ? static_cast<const long long*>(idx)[s]
                           : static_cast<long long>(
                                 static_cast<const int*>(idx)[s]));
  }
}

template <typename T>
__device__ __forceinline__ void load4(const void* __restrict__ src,
                                      const long long* r, const bool* ok,
                                      u64* v) {
  const T* __restrict__ p = static_cast<const T*>(src);
#pragma unroll
  for (int j = 0; j < SLOTS; ++j)
    v[j] = ok[j] ? static_cast<u64>(__ldg(p + r[j])) : 0ull;
}

__device__ __forceinline__ void load_values(const void* __restrict__ src,
                                            int bytes, const long long* r,
                                            const bool* ok, u64* v) {
  switch (bytes) {
    case 1: load4<unsigned char>(src, r, ok, v); break;
    case 2: load4<unsigned short>(src, r, ok, v); break;
    case 4: load4<unsigned int>(src, r, ok, v); break;
    default: load4<unsigned long long>(src, r, ok, v);
  }
}

// the four mask bytes of slots s0..s0+3, little-endian in one word
__device__ __forceinline__ unsigned load_mask(
    const unsigned char* __restrict__ msrc, const long long* r,
    const bool* ok, long long s0, long long nv) {
  unsigned w = 0u;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    bool b = ok[j] && s0 + j < nv;
    if (msrc != nullptr && ok[j]) b = b && __ldg(msrc + r[j]) != 0;
    w |= (b ? 1u : 0u) << (8 * j);
  }
  return w;
}

__device__ __forceinline__ void store_values(void* dst, int bytes,
                                             long long s0, long long m,
                                             bool full, const u64* v) {
  if (!full) {
    for (int j = 0; j < SLOTS && s0 + j < m; ++j) {
      const long long s = s0 + j;
      switch (bytes) {
        case 1: static_cast<unsigned char*>(dst)[s] =
                    static_cast<unsigned char>(v[j]); break;
        case 2: static_cast<unsigned short*>(dst)[s] =
                    static_cast<unsigned short>(v[j]); break;
        case 4: static_cast<unsigned*>(dst)[s] =
                    static_cast<unsigned>(v[j]); break;
        default: static_cast<u64*>(dst)[s] = v[j];
      }
    }
    return;
  }
  switch (bytes) {
    case 1:
      __stcs(static_cast<unsigned*>(dst) + s0 / 4,
             static_cast<unsigned>(v[0] | (v[1] << 8) | (v[2] << 16) |
                                   (v[3] << 24)));
      break;
    case 2:
      __stcs(static_cast<u64*>(dst) + s0 / 4,
             v[0] | (v[1] << 16) | (v[2] << 32) | (v[3] << 48));
      break;
    case 4:
      __stcs(reinterpret_cast<uint4*>(static_cast<unsigned*>(dst) + s0),
             make_uint4(static_cast<unsigned>(v[0]),
                        static_cast<unsigned>(v[1]),
                        static_cast<unsigned>(v[2]),
                        static_cast<unsigned>(v[3])));
      break;
    default: {
      ulonglong2* p = reinterpret_cast<ulonglong2*>(static_cast<u64*>(dst) +
                                                    s0);
      __stcs(p, make_ulonglong2(v[0], v[1]));
      __stcs(p + 1, make_ulonglong2(v[2], v[3]));
    }
  }
}

__device__ __forceinline__ void store_mask(unsigned char* mdst, long long s0,
                                           long long m, bool full,
                                           unsigned w) {
  if (full) {
    __stcs(reinterpret_cast<unsigned*>(mdst + s0), w);
    return;
  }
  for (int j = 0; j < SLOTS && s0 + j < m; ++j)
    mdst[s0 + j] = static_cast<unsigned char>((w >> (8 * j)) & 1u);
}

template <int C, bool IDX64>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(Cols<C> K, int ncols, const void* __restrict__ idx,
                  int idx_vec, long long m, long long n_src,
                  const int* __restrict__ n_valid) {
  const long long nv = n_valid ? static_cast<long long>(*n_valid) : m;
  const long long quads = (m + SLOTS - 1) / SLOTS;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long q = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       q < quads; q += step) {
    const long long s0 = q * SLOTS;
    const bool full = s0 + SLOTS <= m;
    long long r[SLOTS];
    load_idx<IDX64>(idx, s0, m, full && idx_vec, r);
    bool ok[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) ok[j] = r[j] >= 0 && r[j] < n_src;
    // one group in the 4-column instantiation: its columns' indices are
    // then constants and the argument block is read without indexing
    const int groups = C == GROUP ? 1 : (ncols + GROUP - 1) / GROUP;
    for (int gi = 0; gi < groups; ++gi) {
      const int c0 = gi * GROUP;
      u64 v[GROUP][SLOTS];
      unsigned mk[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int c = c0 + g;
        if (c < ncols) {
          load_values(K.src[c], K.bytes[c], r, ok, v[g]);
          mk[g] = load_mask(K.msrc[c], r, ok, s0, nv);
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int c = c0 + g;
        if (c < ncols) {
          store_values(K.dst[c], K.bytes[c], s0, m, full, v[g]);
          store_mask(K.mdst[c], s0, m, full, mk[g]);
        }
      }
    }
  }
}

template <int C, bool IDX64>
int grid_for(long long quads) {
  static int most = 0;          // SMs x resident blocks, found once
  if (most == 0) {
    int dev = 0, sms = 132, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, gather_kernel<C, IDX64>, THREADS, 0);
    most = sms * (per > 0 ? per : 1);
  }
  const long long b = (quads + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b > most ? most : static_cast<int>(b));
}

}  // namespace

// The argument block of one launch (ops/gather.py `_GatherArgs`): the
// wrapper copies its signature's cached block and fills in the pointers.
struct GatherArgs {
  const void* src[MAX_COLS];
  const void* msrc[MAX_COLS];     // null: every row valid
  void* dst[MAX_COLS];            // 16-byte aligned
  void* mdst[MAX_COLS];           // 16-byte aligned
  const void* idx;                // m int32 (idx64 = 0) or int64 row ids
  const void* n_valid;            // a device int32 scalar, or null for m
  long long m;
  long long n_src;
  int bytes[MAX_COLS];            // 1, 2, 4 or 8
  int ncols;                      // 1..64
  int idx64;
};

namespace {

template <int C, bool IDX64>
void launch(const GatherArgs& a, cudaStream_t st) {
  Cols<C> K;
  for (int c = 0; c < C; ++c) {
    const bool on = c < a.ncols;
    K.src[c] = on ? a.src[c] : nullptr;
    K.msrc[c] = on ? static_cast<const unsigned char*>(a.msrc[c]) : nullptr;
    K.dst[c] = on ? a.dst[c] : nullptr;
    K.mdst[c] = on ? static_cast<unsigned char*>(a.mdst[c]) : nullptr;
    K.bytes[c] = on ? a.bytes[c] : 1;
  }
  const long long quads = (a.m + SLOTS - 1) / SLOTS;
  const int vec = (reinterpret_cast<uintptr_t>(a.idx) & 15u) == 0u;
  gather_kernel<C, IDX64><<<grid_for<C, IDX64>(quads), THREADS, 0, st>>>(
      K, a.ncols, a.idx, vec, a.m, a.n_src,
      static_cast<const int*>(a.n_valid));
}

}  // namespace

extern "C" {

// args: one GatherArgs (host memory). out values and masks: m elements
// each, every one 16-byte aligned.
int tt_gather_columns(const void* args, void* stream) {
  const GatherArgs& a = *static_cast<const GatherArgs*>(args);
  if (a.ncols < 1 || a.ncols > MAX_COLS || a.m < 0 || a.n_src < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < a.ncols; ++c) {
    const int b = a.bytes[c];
    if ((b != 1 && b != 2 && b != 4 && b != 8) ||
        ((reinterpret_cast<uintptr_t>(a.dst[c]) |
          reinterpret_cast<uintptr_t>(a.mdst[c])) & 15u) != 0u)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();  // clear any stale error before our launch
  if (a.m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.ncols <= GROUP)
    a.idx64 ? launch<GROUP, true>(a, st) : launch<GROUP, false>(a, st);
  else
    a.idx64 ? launch<MAX_COLS, true>(a, st) : launch<MAX_COLS, false>(a, st);
  return static_cast<int>(cudaGetLastError());
}

// the size of GatherArgs, which the wrapper's ctypes block must match
int tt_gather_args_bytes() { return static_cast<int>(sizeof(GatherArgs)); }

}  // extern "C"
