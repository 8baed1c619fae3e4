// K16 distinct_pairs — the two row-scale steps of the DISTINCT pair
// factorize that are not a sort.
//
// Replaces: the arithmetic of tidb_tpu/ops/factorize.py
// distinct_pair_factorize (and so distinct_mask and
// tidb_tpu/executor/device_emit.py emit_distinct's first mask):
//   pair_code   code[i] = gid[i] * (n + 1) + vid[i]  — one int64 code per
//               row for the (group, value-rank) pair; gid is the row's
//               group id (cap for dead rows), vid its dense value rank
//               from _dense1 (K9 + K8 + K10);
//   first_mask  first[i] = (rep[pg[i]] == i)  — after the pair code's
//               factorize (K9 + K8 + K10), true at the smallest row of
//               each pair group, i.e. the first occurrence of the pair.
// Between the two entries the existing sort kernels run: the pair code
// carries its host-known bound (cap + 1) * (n + 1), so K9 packs it with
// no min/max read-back.
//
// What bounds them on an H100: bytes. pair_code reads two int32 and
// writes one int64 per row; first_mask reads pg and writes one byte per
// row, plus one gather of rep, which at up to ~10^6 pairs (4 MB) stays in
// the 50 MB L2. Elementwise, one row per thread in a grid-stride loop.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void pair_code_kernel(const int* __restrict__ gids,
                                 const int* __restrict__ vid, long long n,
                                 long long stride,
                                 long long* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step)
    out[i] = static_cast<long long>(gids[i]) * stride +
             static_cast<long long>(vid[i]);
}

__global__ void first_mask_kernel(const int* __restrict__ rep,
                                  const int* __restrict__ pg, long long n,
                                  int cap, unsigned char* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int g = pg[i];
    out[i] = static_cast<unsigned>(g) < static_cast<unsigned>(cap) &&
             static_cast<long long>(rep[g]) == i;
  }
}

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 32) b = 132 * 32;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

extern "C" {

// gids, vid: n int32 each; out: n int64 = gids * stride + vid.
int tt_pair_code(const void* gids, const void* vid, long long n,
                 long long stride, void* out, void* stream) {
  if (stride <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launch
  if (n > 0)
    pair_code_kernel<<<grid_for(n), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(gids), static_cast<const int*>(vid), n,
        stride, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// rep: cap int32; pg: n int32; out: n bool = (rep[pg[i]] == i), false
// where pg[i] lies outside [0, cap).
int tt_first_mask(const void* rep, const void* pg, long long n, int cap,
                  void* out, void* stream) {
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n > 0)
    first_mask_kernel<<<grid_for(n), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rep), static_cast<const int*>(pg), n, cap,
        static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
