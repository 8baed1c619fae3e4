// K16 distinct_pairs — the DISTINCT pair factorize's one row-scale step
// that is not the sort: the pair sort's radix word.
//
// Replaces: the pair code of tidb_tpu/ops/factorize.py
// distinct_pair_factorize (and so distinct_mask and
// tidb_tpu/executor/device_emit.py emit_distinct's first mask),
// `gid·(n+1) + vid`, together with the two K9 passes that encoded it and
// the pair's liveness into the sort's word:
//   pair_word  w[i] = (gid[i]·(n+1) + vid[i]) | (pair_live[i] ? 0 : 1) << W
// with W = ((gid_cap+1)·(n+1) − 1).bit_length(): bit for bit the word K9
// builds from [SortOp(pair_live, desc=True), SortOp(code, hi=(gid_cap+1)·
// (n+1))] (the code at shift 0 over W bits, the dead flag at bit W). gid
// is the row's group id (gid_cap for dead rows), vid its dense value rank
// from _dense1 (K9 + K8 + K10). K8 sorts the word over W + 1 bits, and
// K10's word entry numbers the pairs and, in the same pass, writes the
// first-occurrence mask `rep[pg] == iota` (csrc/sorted_groups.cu).
//
// What bounds it on an H100: bytes — two int32 and a flag byte read, one
// int64 word written a row (17 B; 143 MB at n = 8,388,608, 0.043 ms at
// 3.35 TB/s). A warp takes 128 rows a step, a lane two pairs of rows:
// 8-byte loads of the gids and ranks and a 2-byte load of the flags
// (where all three are aligned so; else scalar loads), then two 16-byte
// stores, each warp access a contiguous run of whole sectors; a
// persistent grid-stride loop over warps.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
typedef unsigned long long u64;

// A warp step covers 128 rows: lane t's two groups are rows 2t, 2t + 1 and
// 64 + 2t, 65 + 2t of it, so each of the warp's loads (8-byte pairs of
// gids and ranks, 2-byte pairs of flags) and 16-byte stores covers a
// contiguous run (256, 64 and 512 bytes): whole sectors, none written in
// halves. All loads are made before the stores. The rows after the last
// whole step go one a thread.
constexpr int STEP_ROWS = 128;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    pair_word_kernel(const int* __restrict__ gids, const int* __restrict__ vid,
                     const unsigned char* __restrict__ live, long long n,
                     long long stride, int w_bit, u64* __restrict__ out) {
  const long long steps = n / STEP_ROWS;
  const long long g = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
  const u64 dead = 1ull << w_bit;
  for (long long k = g >> 5; k < steps; k += warps) {
    int gv[2][2], vv[2][2];
    unsigned lv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long r = k * STEP_ROWS + j * 64 + 2 * lane;
      if (VEC) {
        const int2 a = __ldcs(reinterpret_cast<const int2*>(gids + r));
        const int2 b = __ldcs(reinterpret_cast<const int2*>(vid + r));
        lv[j] = __ldcs(reinterpret_cast<const unsigned short*>(live + r));
        gv[j][0] = a.x, gv[j][1] = a.y;
        vv[j][0] = b.x, vv[j][1] = b.y;
      } else {
        gv[j][0] = gids[r], gv[j][1] = gids[r + 1];
        vv[j][0] = vid[r], vv[j][1] = vid[r + 1];
        lv[j] = live[r] | static_cast<unsigned>(live[r + 1]) << 8;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      u64 w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        w[e] = static_cast<u64>(static_cast<long long>(gv[j][e]) * stride +
                                vv[j][e]) |
               (((lv[j] >> (8 * e)) & 0xffu) ? 0ull : dead);
      reinterpret_cast<ulonglong2*>(out + k * STEP_ROWS + j * 64)[lane] =
          make_ulonglong2(w[0], w[1]);
    }
  }
  // the last n % 128 rows, one a thread
  const long long r = steps * STEP_ROWS + g;
  if (r < n)
    out[r] = static_cast<u64>(static_cast<long long>(gids[r]) * stride +
                              vid[r]) | (live[r] ? 0ull : dead);
}

}  // namespace

extern "C" {

// gids, vid: n int32 each; live: n bool; out: n uint64 (16-byte aligned)
// = (gids * stride + vid) | !live << w_bit, with stride = n + 1 and w_bit
// the code's width W (1..63).
int tt_pair_word(const void* gids, const void* vid, const void* live,
                 long long n, long long stride, int w_bit, void* out,
                 void* stream) {
  if (n < 0 || stride <= 0 || w_bit < 1 || w_bit > 63 ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launch
  if (n > 0) {
    long long blocks =
        (n / STEP_ROWS * 32 + THREADS - 1) / THREADS;   // a warp a step
    if (blocks > 132 * 8) blocks = 132 * 8;
    if (blocks < 1) blocks = 1;
    const bool vec = ((reinterpret_cast<uintptr_t>(gids) |
                       reinterpret_cast<uintptr_t>(vid)) & 7) == 0 &&
                     (reinterpret_cast<uintptr_t>(live) & 1) == 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* g = static_cast<const int*>(gids);
    const int* v = static_cast<const int*>(vid);
    const unsigned char* l = static_cast<const unsigned char*>(live);
    u64* o = static_cast<u64*>(out);
    if (vec)
      pair_word_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0,
                               st>>>(g, v, l, n, stride, w_bit, o);
    else
      pair_word_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0,
                                st>>>(g, v, l, n, stride, w_bit, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
