// K8 radix_sort and K9 sort_encode — the sort of the sort formulation.
//
// They replace the `lax.sort` calls of tidb_tpu/ops/factorize.py
// (_dense1, factorize, sort_perm — and through them pack_codes and topn)
// and tidb_tpu/ops/join.py (sorted_probe_unique, sorted_probe_multi, and
// combine_keys through pack_codes), and the stable argsort of the LIMIT
// branch of tidb_tpu/executor/device_emit.py emit_root.
//
// K9 turns one sort operand (bool, int32, int64 or float64 values, an
// optional validity mask whose false slots read as 0, a DESC flag) into
// order-preserving unsigned 64-bit radix bits, gathered through the
// current permutation: signed integers flip the sign bit; a float64
// canonicalizes -0.0 to +0.0 and every NaN to one code above +inf (the
// order of a stable torch.sort / lax.sort); DESC inverts the bits (NaN
// stays last, as `-v` sorts it). The caller subtracts the operand's
// smallest code (`base`) and shifts it into its bit field, so several
// narrow operands — the dead flag, the NULL flag and the value — pack
// into one word, most significant operand highest. A stats launch (no
// output) reduces the codes' min and max, so the caller knows how many
// bits vary.
//
// K8 is a stable LSD radix sort of (uint64 word, int32 row id) pairs over
// bits [0, end_bit) in 8-bit digits. Each pass runs (1) a per-tile digit
// histogram, (2) an exclusive scan of every digit's row of tile counts
// (digit-major [digit][tile] layout, one block per digit), and (3) a
// scatter in which each tile ranks its keys stably in index order: each
// warp owns a contiguous run of the tile and walks it in rounds of 32
// keys, ranking a round with __match_any_sync and carrying per-warp
// digit positions in shared memory. The digit's global start is the scan
// of the digit totals plus the tile's scanned count. Words of several
// 64-bit words sort from the least significant word to the most (the
// caller re-encodes the next word through the permutation). The result
// equals torch.sort(stable=True) element for element.
//
// What bounds them on an H100: bytes. A pass reads the keys twice (the
// histogram and the scatter) and the row ids once, and writes both: about
// 32 B per key per 8-bit digit, so a 24-bit key costs three passes. The
// design keeps the pass count at the bits that vary (the caller packs
// narrow operands into one word and subtracts the minimum) and the
// histogram free of atomic pile-ups (one shared atomic per distinct digit
// of a warp's round). The scatter's writes land in 256 buckets per tile,
// not coalesced: the price of a simple kernel, left for a later change.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                // keys per thread in a tile
constexpr int TILE = THREADS * ITEMS;    // 4096 keys
constexpr int RADIX = 256;               // 8-bit digits
constexpr int SCAN_T = 1024;
static_assert(RADIX == THREADS, "one digit per thread");

enum { DT_BOOL = 0, DT_I32 = 1, DT_I64 = 2, DT_F64 = 3 };

// ---- K9 ------------------------------------------------------------------

__device__ __forceinline__ u64 zero_code(int dtype) {
  switch (dtype) {
    case DT_BOOL: return 0ull;
    case DT_I32: return 0x80000000ull;
    default: return 1ull << 63;          // int64 0 and float64 +0.0
  }
}

__device__ __forceinline__ u64 value_code(const void* src, int dtype,
                                          long long r) {
  switch (dtype) {
    case DT_BOOL:
      return static_cast<const unsigned char*>(src)[r] ? 1ull : 0ull;
    case DT_I32:
      return static_cast<u64>(
          static_cast<uint32_t>(static_cast<const int*>(src)[r]) ^
          0x80000000u);
    case DT_I64:
      return static_cast<u64>(static_cast<const long long*>(src)[r]) ^
             (1ull << 63);
    default: {
      const double x = static_cast<const double*>(src)[r];
      if (x != x) return ~0ull;          // every NaN, above +inf
      if (x == 0.0) return 1ull << 63;   // -0.0 == +0.0
      const u64 b = static_cast<u64>(__double_as_longlong(x));
      return (b >> 63) ? ~b : (b | (1ull << 63));
    }
  }
}

__device__ __forceinline__ u64 flip_code(u64 u, int dtype) {
  switch (dtype) {
    case DT_BOOL: return u ^ 1ull;
    case DT_I32: return u ^ 0xFFFFFFFFull;
    case DT_I64: return ~u;
    default: return u == ~0ull ? u : ~u;   // NaN stays last
  }
}

struct MinOp {
  __device__ u64 operator()(u64 a, u64 b) const { return a < b ? a : b; }
};
struct MaxOp {
  __device__ u64 operator()(u64 a, u64 b) const { return a > b ? a : b; }
};

__global__ void __launch_bounds__(THREADS)
    encode_kernel(const void* __restrict__ src, int dtype, long long n,
                  const int* __restrict__ perm,
                  const unsigned char* __restrict__ mask, int desc,
                  u64 base, int shift, u64* __restrict__ out, int accumulate,
                  u64* __restrict__ stats) {
  u64 lo = ~0ull, hi = 0ull;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += step) {
    const long long r = perm ? static_cast<long long>(perm[i]) : i;
    u64 u = (mask && !mask[r]) ? zero_code(dtype) : value_code(src, dtype, r);
    if (desc) u = flip_code(u, dtype);
    lo = u < lo ? u : lo;
    hi = u > hi ? u : hi;
    if (out) {
      const u64 w = (u - base) << shift;
      out[i] = accumulate ? (out[i] | w) : w;
    }
  }
  if (stats) {
    typedef cub::BlockReduce<u64, THREADS> Reduce;
    __shared__ typename Reduce::TempStorage tmp;
    const u64 blo = Reduce(tmp).Reduce(lo, MinOp());
    __syncthreads();
    const u64 bhi = Reduce(tmp).Reduce(hi, MaxOp());
    if (threadIdx.x == 0) {
      atomicMin(&stats[0], blo);
      atomicMax(&stats[1], bhi);
    }
  }
}

// ---- K8 ------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    digit_hist(const u64* __restrict__ keys, long long n, int shift,
               u64 dmask, int n_tiles, int* __restrict__ counts) {
  __shared__ int hist[RADIX];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + static_cast<long long>(j) * THREADS +
                        threadIdx.x;
    const int d = i < n ? static_cast<int>((keys[i] >> shift) & dmask)
                        : RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < RADIX && lane == __ffs(peers) - 1)
      atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  counts[static_cast<long long>(threadIdx.x) * n_tiles + blockIdx.x] =
      hist[threadIdx.x];
}

// one block per digit: its row of tile counts → exclusive prefix in
// place; the row total → digit_total
__global__ void __launch_bounds__(SCAN_T)
    scan_digit_rows(int* __restrict__ counts, int n_tiles,
                    int* __restrict__ digit_total) {
  typedef cub::BlockScan<int, SCAN_T> Scan;
  __shared__ typename Scan::TempStorage tmp;
  int* row = counts + static_cast<long long>(blockIdx.x) * n_tiles;
  int carry = 0;
  for (int b = 0; b < n_tiles; b += SCAN_T) {
    const int i = b + threadIdx.x;
    const int v = i < n_tiles ? row[i] : 0;
    int ex, agg;
    Scan(tmp).ExclusiveSum(v, ex, agg);
    if (i < n_tiles) row[i] = carry + ex;
    carry += agg;
    __syncthreads();
  }
  if (threadIdx.x == 0) digit_total[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(THREADS)
    digit_scatter(const u64* __restrict__ keys_in,
                  const int* __restrict__ vals_in, long long n, int shift,
                  u64 dmask, int n_tiles, const int* __restrict__ counts,
                  const int* __restrict__ digit_total,
                  u64* __restrict__ keys_out, int* __restrict__ vals_out) {
  typedef cub::BlockScan<int, THREADS> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int warp_pos[WARPS][RADIX];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // where this tile's keys of digit `tid` start in the output
  int dstart;
  Scan(scan_tmp).ExclusiveSum(digit_total[tid], dstart);
  dstart += counts[static_cast<long long>(tid) * n_tiles + blockIdx.x];
  for (int w = 0; w < WARPS; ++w) warp_pos[w][tid] = 0;
  __syncthreads();

  // warp `warp` owns keys [wbase, wbase + 32 * ITEMS) of the tile, walked
  // in rounds of 32: index order is (warp, round, lane)
  const long long wbase = static_cast<long long>(blockIdx.x) * TILE +
                          static_cast<long long>(warp) * (32 * ITEMS);
  u64 k[ITEMS];
  int v[ITEMS];
  int d[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    if (i < n) {
      k[j] = keys_in[i];
      v[j] = vals_in ? vals_in[i] : static_cast<int>(i);
      d[j] = static_cast<int>((k[j] >> shift) & dmask);
    } else {
      k[j] = 0ull;
      v[j] = 0;
      d[j] = RADIX;
    }
  }
  // per-warp digit counts (one leader per digit and round writes)
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned peers = __match_any_sync(0xffffffffu, d[j]);
    if (d[j] < RADIX && lane == __ffs(peers) - 1)
      warp_pos[warp][d[j]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // warp-exclusive prefix per digit, from the digit's start in the output
  {
    int run = dstart;
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_pos[w][tid];
      warp_pos[w][tid] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned peers = __match_any_sync(0xffffffffu, d[j]);
    const bool ok = d[j] < RADIX;
    const int pos = ok ? warp_pos[warp][d[j]] + __popc(peers & lt) : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1)
      warp_pos[warp][d[j]] += __popc(peers);
    __syncwarp();
    if (ok) {
      keys_out[pos] = k[j];
      vals_out[pos] = v[j];
    }
  }
}

int blocks_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 16) b = 132 * 16;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

extern "C" {

// keys per K8 tile: the caller sizes `counts` as 256 * ceil(n / tile)
int tt_radix_tile() { return TILE; }

// K9. src: n values of `dtype` (0 bool, 1 int32, 2 int64, 3 float64);
// perm: int32 (n) or null (identity); mask: bool (length of src) or null,
// false slots read as 0; out: uint64 (n) or null — out[i] = (code(src[
// perm[i]]) - base) << shift, OR-ed into out[i] when `accumulate`; stats:
// two uint64 (min, max) or null, initialized by the caller to (~0, 0).
int tt_sort_encode(const void* src, int dtype, long long n, const void* perm,
                   const void* mask, int desc, unsigned long long base,
                   int shift, void* out, int accumulate, void* stats,
                   void* stream) {
  if (n < 0 || dtype < DT_BOOL || dtype > DT_F64 || shift < 0 ||
      shift > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  encode_kernel<<<blocks_for(n), THREADS, 0, st>>>(
      src, dtype, n, static_cast<const int*>(perm),
      static_cast<const unsigned char*>(mask), desc, base, shift,
      static_cast<u64*>(out), accumulate, static_cast<u64*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// K8. keys: uint64 (n); vals: int32 (n) or null (row ids 0..n-1); sorts
// by bits [0, end_bit) in ceil(end_bit / 8) passes. Pass p writes
// (keys_a, vals_a) when p is even, (keys_b, vals_b) when odd, and reads
// the input (p = 0) or the other pair. Scratch: counts int32 (256 *
// ceil(n / tt_radix_tile())), digit_total int32 (256).
int tt_radix_sort(const void* keys, const void* vals, long long n,
                  int end_bit, void* keys_a, void* vals_a, void* keys_b,
                  void* vals_b, void* counts, void* digit_total,
                  void* stream) {
  if (n < 0 || n >= (1LL << 31) || end_bit < 0 || end_bit > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0 || end_bit == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((n + TILE - 1) / TILE);
  int* cnt = static_cast<int*>(counts);
  int* tot = static_cast<int*>(digit_total);
  const u64* kin = static_cast<const u64*>(keys);
  const int* vin = static_cast<const int*>(vals);
  for (int shift = 0, p = 0; shift < end_bit; shift += 8, ++p) {
    const int bits = end_bit - shift < 8 ? end_bit - shift : 8;
    const u64 dmask = (1ull << bits) - 1ull;
    u64* kout = static_cast<u64*>(p % 2 == 0 ? keys_a : keys_b);
    int* vout = static_cast<int*>(p % 2 == 0 ? vals_a : vals_b);
    digit_hist<<<n_tiles, THREADS, 0, st>>>(kin, n, shift, dmask, n_tiles,
                                             cnt);
    scan_digit_rows<<<RADIX, SCAN_T, 0, st>>>(cnt, n_tiles, tot);
    digit_scatter<<<n_tiles, THREADS, 0, st>>>(kin, vin, n, shift, dmask,
                                                n_tiles, cnt, tot, kout,
                                                vout);
    kin = kout;
    vin = vout;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
