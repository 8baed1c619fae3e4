// K17 rollup_tile — the level replication of GROUP BY ... WITH ROLLUP.
//
// Replaces: tidb_tpu/executor/device_emit.py _rollup_tile (the batch's
// columns concatenated (nk+1)x along the row axis) and the per-row half
// of emit_agg's ROLLUP branch (the grouping-level column
// lev = repeat(arange(nk+1), n) and each group key's validity masked to
// m & (lev < nk - i), so copy l rolls up the last l keys).
//   tile    one launch over a table of columns (1-, 2-, 4- or 8-byte
//           elements; 1-D columns and 2-D (planes, n) limb planes, which
//           tile along their last axis): out[p, l*n + i] = in[p, i] for
//           l in [0, reps);
//   levels  the int64 level column and the masked key validities over
//           the tiled rows, in one launch over the keys' masks.
// The caller tiles only the columns that the group keys and the
// aggregate arguments read; the expressions are row-wise, so their
// results over the tiled columns are the reference's.
//
// What bounds it on an H100: bytes — each input element read once and
// written reps times; levels reads nk masks and writes nk masks and the
// 8-byte level per tiled row. One thread per input element in a
// grid-stride loop, the column index in blockIdx.y.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_COLS = 64;
constexpr int MAX_KEYS = 32;

struct Cols {
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  long long planes[MAX_COLS];
  int bytes[MAX_COLS];
};

struct Masks {
  const unsigned char* in[MAX_KEYS];
  unsigned char* out[MAX_KEYS];
};

template <typename T>
__device__ void tile_one(const void* src, void* dst, long long e,
                         long long base, long long n, int reps) {
  const T x = static_cast<const T*>(src)[e];
  T* d = static_cast<T*>(dst);
  for (int l = 0; l < reps; ++l) d[base + l * n] = x;
}

__global__ void tile_kernel(Cols C, long long n, int reps) {
  const int c = blockIdx.y;
  const long long total = C.planes[c] * n;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += step) {
    const long long p = e / n;
    const long long base = p * reps * n + (e - p * n);
    switch (C.bytes[c]) {
      case 1: tile_one<uint8_t>(C.src[c], C.dst[c], e, base, n, reps); break;
      case 2: tile_one<uint16_t>(C.src[c], C.dst[c], e, base, n, reps); break;
      case 4: tile_one<uint32_t>(C.src[c], C.dst[c], e, base, n, reps); break;
      default:
        tile_one<unsigned long long>(C.src[c], C.dst[c], e, base, n, reps);
    }
  }
}

__global__ void levels_kernel(Masks M, int nk, long long n0,
                              long long* __restrict__ lev) {
  const long long total = static_cast<long long>(nk + 1) * n0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < total; j += step) {
    const long long l = j / n0;
    lev[j] = l;
    for (int i = 0; i < nk; ++i)
      M.out[i][j] = M.in[i][j] && l < nk - i;
  }
}

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 32) b = 132 * 32;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

extern "C" {

// ncols (<= 64) columns of n rows: src[c] holds planes[c] x n elements of
// bytes[c] (1, 2, 4 or 8) bytes; dst[c] receives planes[c] x (reps * n).
int tt_rollup_tile(int ncols, const void* const* src, void* const* dst,
                   const long long* planes, const int* bytes, long long n,
                   int reps, void* stream) {
  if (ncols < 1 || ncols > MAX_COLS || reps < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols C;
  long long most = 0;
  for (int c = 0; c < MAX_COLS; ++c) {
    const bool on = c < ncols;
    C.src[c] = on ? src[c] : nullptr;
    C.dst[c] = on ? dst[c] : nullptr;
    C.planes[c] = on ? planes[c] : 0;
    C.bytes[c] = on ? bytes[c] : 1;
    if (on) {
      const int b = bytes[c];
      if (b != 1 && b != 2 && b != 4 && b != 8)
        return static_cast<int>(cudaErrorInvalidValue);
      if (planes[c] > most) most = planes[c];
    }
  }
  cudaGetLastError();  // clear any stale error before our launch
  if (n > 0 && most > 0) {
    dim3 grid(grid_for(most * n), ncols);
    tile_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        C, n, reps);
  }
  return static_cast<int>(cudaGetLastError());
}

// nk (<= 32) key masks over (nk + 1) * n0 tiled rows: mask_out[i][j] =
// mask_in[i][j] && (j / n0 < nk - i); lev[j] = j / n0 (int64).
int tt_rollup_levels(int nk, const void* const* mask_in,
                     void* const* mask_out, long long n0, void* lev,
                     void* stream) {
  if (nk < 0 || nk > MAX_KEYS || n0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Masks M;
  for (int i = 0; i < MAX_KEYS; ++i) {
    const bool on = i < nk;
    M.in[i] = on ? static_cast<const unsigned char*>(mask_in[i]) : nullptr;
    M.out[i] = on ? static_cast<unsigned char*>(mask_out[i]) : nullptr;
  }
  cudaGetLastError();
  const long long total = static_cast<long long>(nk + 1) * n0;
  if (total > 0)
    levels_kernel<<<grid_for(total), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        M, nk, n0, static_cast<long long*>(lev));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
