// A single-pass int64 sum scan with decoupled look-back (Merrill and
// Garland, 2016), for the kernels whose tiles take their ids from an
// atomic counter: K7 join_expand's probe tiles and K2 unpack_decode's
// delta tiles. csrc/window_scan.cu holds the general engine (any state,
// any associative op) of K12/K13; this header is its int64-sum case,
// shared by join_expand.cu and unpack_decode.cu.
//
// A tile's status is a flag word (0 nothing yet, ST_AGG its aggregate is
// out, ST_INCL its inclusive prefix is out) and two int64 payload slots,
// the aggregate and the inclusive prefix, never overwritten. The payload
// is written first and the flag with st.release.gpu after it; a reader
// takes the flag with ld.acquire.gpu, then the payload with
// ld.relaxed.gpu. The caller zeroes the flags before each launch. A tile
// waits only on tiles with smaller ids, which took their ids from the
// counter earlier and so are running: the wait cannot deadlock.

#pragma once

#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ST_AGG = 1u;
constexpr unsigned ST_INCL = 2u;

struct Status {
  unsigned* flags;      // zeroed by the caller
  long long* agg;
  long long* incl;
};

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ long long load_relaxed(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.s64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void publish(const Status& st, long long tile,
                                       long long v, unsigned flag) {
  (flag == ST_INCL ? st.incl : st.agg)[tile] = v;
  store_release(st.flags + tile, flag);
}

// The sum of every tile in [first, tile) of the status, by one warp: lane
// l reads tile t0 - l, waits for its flag, and the window's values up to
// the nearest inclusive prefix add up; tiles before `first` count as an
// empty inclusive prefix.
__device__ __forceinline__ long long look_back(const Status& st,
                                               long long first,
                                               long long tile, int lane) {
  long long excl = 0;
  for (long long t0 = tile - 1;; t0 -= 32) {
    const long long t = t0 - lane;
    unsigned f = ST_INCL;
    long long v = 0;
    if (t >= first) {
      do {
        f = load_acquire(st.flags + t);
      } while (f == 0u);
      v = load_relaxed((f == ST_INCL ? st.incl : st.agg) + t);
    }
    const unsigned incl = __ballot_sync(FULL, f == ST_INCL);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    if (lane > stop) v = 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    excl += v;
    if (incl) break;
  }
  return excl;
}

// Warp 0's part of a tile's scan, once the tile's aggregate `agg` is
// known: publish it, look back over the tiles in [first, tile) and
// publish the inclusive prefix. → the tile's exclusive prefix (all lanes).
__device__ __forceinline__ long long tile_prefix(const Status& st,
                                                long long first,
                                                long long tile,
                                                long long agg, int lane) {
  if (tile == first) {
    if (lane == 0) publish(st, tile, agg, ST_INCL);
    return 0;
  }
  if (lane == 0) publish(st, tile, agg, ST_AGG);
  const long long pre = look_back(st, first, tile, lane);
  if (lane == 0) publish(st, tile, pre + agg, ST_INCL);
  return pre;
}

// Inclusive warp scan of v over the 32 lanes.
__device__ __forceinline__ long long warp_inclusive(long long v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

}  // namespace lookback
