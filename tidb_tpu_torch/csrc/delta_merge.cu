// K19 delta_merge — a tombstone set applied to one resident slab: the
// surviving rows stable-partitioned to the front and every bit-packed
// column (and every packed validity mask) repacked through that order.
//
// Replaces: tidb_tpu/executor/device_emit.py emit_delta_merge (the
// argsort(~keep, stable=True) and, per packed column, the unpack → take
// → where(iota < n_new) → _emit_pack_codes chain) and _emit_pack_codes.
// The reference sorts once per column inside each column's program; here
// the permutation is computed once per slab and every column reuses it.
// Raw columns go through K18 gather_columns with the same permutation.
//
//   delta_perm:   keep (bool, cap) → perm (int32, cap), perm =
//                 argsort(~keep, stable): kept rows first in row order,
//                 then dropped and padding rows in row order. Three
//                 passes, as K10's group ids: per-tile kept counts, one
//                 block scanning them to carries (and the kept total), a
//                 re-read that scans the tile's flags and scatters i to
//                 carry + rank (kept) or n_keep + i - kept_before (not).
//   delta_repack: one thread per OUTPUT word of a column packed at
//                 `width` bits (1, 2, 4, 8, 16 or 32): it gathers the
//                 32/width source codes of its slots through perm
//                 straight from the input words, writes 0 for slots at or
//                 past n_new, and stores the packed word. No atomics and
//                 no unpacked codes in memory. The validity words are the
//                 same call at width 1.
//
// The outputs are byte-equal to the reference's: zeroed codes and a
// zeroed validity tail past n_new, exactly as the host encoder pads.
//
// What bounds it on an H100: bytes. delta_perm reads keep twice (one byte
// a row) and writes perm once (4 bytes a row). delta_repack reads perm
// for every slot below n_new and one source word per code (random reads
// into words that, for a 2,097,152-row slab, are at most 8 MB and stay in
// the 50 MB L2), and writes each output word once.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_T = 1024;

__global__ void __launch_bounds__(SCAN_T)
    perm_totals(const unsigned char* __restrict__ keep, long long n,
                int* __restrict__ totals) {
  typedef cub::BlockReduce<int, SCAN_T> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const long long i = static_cast<long long>(blockIdx.x) * SCAN_T +
                      threadIdx.x;
  const int f = (i < n && keep[i]) ? 1 : 0;
  const int s = Reduce(tmp).Sum(f);
  if (threadIdx.x == 0) totals[blockIdx.x] = s;
}

// in place: totals[b] ← the sum of totals[0..b); the grand total → *n_keep
__global__ void __launch_bounds__(SCAN_T)
    perm_carries(int* __restrict__ totals, long long nblocks,
                 int* __restrict__ n_keep) {
  typedef cub::BlockScan<int, SCAN_T> Scan;
  __shared__ typename Scan::TempStorage tmp;
  int carry = 0;
  for (long long base = 0; base < nblocks; base += SCAN_T) {
    const long long i = base + threadIdx.x;
    const int v = i < nblocks ? totals[i] : 0;
    int ex, agg;
    Scan(tmp).ExclusiveSum(v, ex, agg);
    if (i < nblocks) totals[i] = carry + ex;
    carry += agg;
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_keep = carry;
}

__global__ void __launch_bounds__(SCAN_T)
    perm_scatter(const unsigned char* __restrict__ keep, long long n,
                 const int* __restrict__ carries,
                 const int* __restrict__ n_keep, int* __restrict__ perm) {
  typedef cub::BlockScan<int, SCAN_T> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long i = static_cast<long long>(blockIdx.x) * SCAN_T +
                      threadIdx.x;
  const int f = (i < n && keep[i]) ? 1 : 0;
  int ex;
  Scan(tmp).ExclusiveSum(f, ex);
  if (i >= n) return;
  const long long kept_before = static_cast<long long>(carries[blockIdx.x]) +
                                ex;
  const long long dst = f ? kept_before : *n_keep + (i - kept_before);
  perm[dst] = static_cast<int>(i);
}

__global__ void __launch_bounds__(THREADS)
    repack_words(const uint32_t* __restrict__ words, long long n_in_words,
                 int width, const int* __restrict__ perm, long long cap,
                 long long n_new, long long n_out_words,
                 uint32_t* __restrict__ out) {
  const int per = 32 / width;
  const uint32_t mask =
      width == 32 ? 0xffffffffu : ((1u << width) - 1u);
  const long long live = n_new < cap ? n_new : cap;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       o < n_out_words; o += step) {
    uint32_t acc = 0;
    const long long first = o * per;
    for (int k = 0; k < per; ++k) {
      const long long slot = first + k;
      if (slot >= live) break;
      const long long src = perm[slot];
      const long long w = src / per;
      if (src < 0 || w >= n_in_words) continue;
      const uint32_t code =
          (words[w] >> ((src - w * per) * width)) & mask;
      acc |= code << (k * width);
    }
    out[o] = acc;
  }
}

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 32) b = 132 * 32;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

extern "C" {

// keep: n bools; perm: n int32 (out); scratch: ceil(n / 1024) + 1 int32
// (tile carries, then the kept total).
int tt_delta_perm(const void* keep, long long n, void* perm, void* scratch,
                  void* stream) {
  if (n < 0 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launches
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nblocks = (n + SCAN_T - 1) / SCAN_T;
  int* totals = static_cast<int*>(scratch);
  int* n_keep = totals + nblocks;
  const unsigned char* k = static_cast<const unsigned char*>(keep);
  perm_totals<<<static_cast<unsigned>(nblocks), SCAN_T, 0, st>>>(k, n,
                                                                 totals);
  perm_carries<<<1, SCAN_T, 0, st>>>(totals, nblocks, n_keep);
  perm_scatter<<<static_cast<unsigned>(nblocks), SCAN_T, 0, st>>>(
      k, n, totals, n_keep, static_cast<int*>(perm));
  return static_cast<int>(cudaGetLastError());
}

// words: n_in_words uint32 codes packed at `width` bits; perm: cap int32;
// out: n_out_words uint32 words (n_out_words = ceil(cap * width / 32)).
// Output slot s (< cap) holds the code of source slot perm[s] when
// s < n_new, else 0.
int tt_delta_repack(const void* words, long long n_in_words, int width,
                    const void* perm, long long cap, long long n_new,
                    void* out, long long n_out_words, void* stream) {
  if (width != 1 && width != 2 && width != 4 && width != 8 && width != 16 &&
      width != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cap < 0 || n_new < 0 || n_in_words < 0 || n_out_words < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n_out_words == 0) return 0;
  repack_words<<<grid_for(n_out_words), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_in_words, width,
      static_cast<const int*>(perm), cap, n_new, n_out_words,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
