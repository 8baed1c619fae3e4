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
// What bounds it on an H100: bytes — per output slot, the index read
// once and per column one value (1, 2, 4 or 8 bytes) and one mask byte
// gathered and written. The gathers are random reads; at the pair caps
// of the main path (<= 2,097,152 slots over 8,388,608-row columns) the
// sources exceed L2, so each gathered element costs a 32-byte sector.
// One slot per thread in a grid-stride loop; the columns loop inside the
// thread so the index is read once.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_COLS = 64;

struct GCols {
  const void* src[MAX_COLS];
  const unsigned char* msrc[MAX_COLS];   // null: every row valid
  void* dst[MAX_COLS];
  unsigned char* mdst[MAX_COLS];
  int bytes[MAX_COLS];
};

template <typename T>
__device__ void gather_one(const void* src, void* dst, long long r, bool ok,
                           long long s) {
  static_cast<T*>(dst)[s] = ok ? static_cast<const T*>(src)[r] : T(0);
}

__global__ void gather_kernel(GCols C, int ncols, const void* idx, int idx64,
                              long long m, long long n_src,
                              const int* __restrict__ n_valid) {
  const long long nv = n_valid ? static_cast<long long>(*n_valid) : m;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < m; s += step) {
    const long long r =
        idx64 ? static_cast<const long long*>(idx)[s]
              : static_cast<long long>(static_cast<const int*>(idx)[s]);
    const bool ok = r >= 0 && r < n_src;
    const bool slot = s < nv;
    for (int c = 0; c < ncols; ++c) {
      switch (C.bytes[c]) {
        case 1: gather_one<uint8_t>(C.src[c], C.dst[c], r, ok, s); break;
        case 2: gather_one<uint16_t>(C.src[c], C.dst[c], r, ok, s); break;
        case 4: gather_one<uint32_t>(C.src[c], C.dst[c], r, ok, s); break;
        default:
          gather_one<unsigned long long>(C.src[c], C.dst[c], r, ok, s);
      }
      C.mdst[c][s] = ok && slot && (C.msrc[c] ? C.msrc[c][r] != 0 : true);
    }
  }
}

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 32) b = 132 * 32;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

extern "C" {

// ncols (<= 64) source columns of n_src rows: vals[c] (bytes[c] = 1, 2, 4
// or 8 bytes per element), masks[c] (bool, or null for all valid); idx: m
// int32 (idx64 = 0) or int64 row ids; n_valid: a device int32 scalar, or
// null for m. out_vals[c] / out_masks[c]: m elements each.
int tt_gather_columns(int ncols, const void* const* vals,
                      const void* const* masks, const int* bytes,
                      long long n_src, const void* idx, int idx64,
                      long long m, const void* n_valid,
                      void* const* out_vals, void* const* out_masks,
                      void* stream) {
  if (ncols < 1 || ncols > MAX_COLS || m < 0 || n_src < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GCols C;
  for (int c = 0; c < MAX_COLS; ++c) {
    const bool on = c < ncols;
    C.src[c] = on ? vals[c] : nullptr;
    C.msrc[c] = on ? static_cast<const unsigned char*>(masks[c]) : nullptr;
    C.dst[c] = on ? out_vals[c] : nullptr;
    C.mdst[c] = on ? static_cast<unsigned char*>(out_masks[c]) : nullptr;
    C.bytes[c] = on ? bytes[c] : 1;
    if (on && bytes[c] != 1 && bytes[c] != 2 && bytes[c] != 4 &&
        bytes[c] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();  // clear any stale error before our launch
  if (m > 0)
    gather_kernel<<<grid_for(m), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        C, ncols, idx, idx64, m, n_src, static_cast<const int*>(n_valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
