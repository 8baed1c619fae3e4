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
// bits [0, end_bit) in 8-bit digits, with the one-kernel-per-pass
// ("onesweep") structure of Adinets and Merrill (2022):
//   1. one histogram launch reads the words once and counts every pass's
//      256 digits (shared counters per block, one global add per bin);
//   2. one launch per pass. Each block takes its tile id from an atomic
//      counter (so tile order is index order and the look-back below
//      cannot wait on a tile that has not started), loads its 4,096 keys
//      coalesced, ranks them stably by digit (each warp owns a contiguous
//      run and walks it in rounds of 32 with __match_any_sync), publishes
//      its per-digit counts as an "aggregate", and one thread per digit
//      looks back over the earlier tiles' status words (decoupled
//      look-back) to its exclusive prefix, which it publishes as an
//      "inclusive prefix". The tile then scatters through shared memory:
//      keys, and then row ids, are reordered by digit inside the tile, so
//      consecutive threads write consecutive addresses of each digit's
//      run in the output.
// A status word is 64 bits: the count (< 2^31) in the low 32, the flag
// in bits 32-33 and the pass number + 1 in bits 40-47, so the words of
// one buffer serve every pass, and the scratch (tile counters,
// histograms, status) is zeroed by one memset per call. Words of several
// 64-bit words sort from the least significant word to the most (the
// caller re-encodes the next word through the permutation). The result
// equals torch.sort(stable=True) element for element.
//
// What bounds them on an H100: bytes. A pass reads the keys and the row
// ids once and writes both: 24 B per key per 8-bit digit (20 B on the
// first pass, whose row ids are the index), plus one 8 B read of every
// key for all the histograms; the status words add 2 KB per tile. The
// design keeps the pass count at the bits that vary (the caller packs
// narrow operands into one word and subtracts the minimum), reads each
// key once a pass, and turns the scatter's stores into runs of ~16
// consecutive keys (4,096 keys over 256 digits a tile) instead of one
// lone 8 B and 4 B store per key. The histogram takes a warp whose 32
// keys share a digit with one shared atomic (all-equal and sorted words),
// every other key with one.
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

constexpr int MAX_PASSES = 8;
constexpr int HIST_ITEMS = 8;            // keys per thread per round
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long PREFIX = 2ull << 32;
constexpr int TAG_SHIFT = 40;
constexpr int LOOK = 16;                 // status words a look-back step
// scratch, in 64-bit words: MAX_PASSES uint32 tile counters (padded to
// 64 B), MAX_PASSES x 256 uint32 digit counts, then 256 status words a
// tile
constexpr int HEADER_WORDS = 8 + MAX_PASSES * RADIX / 2;

__device__ __forceinline__ void store_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 load_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ u64 digit_mask(int shift, int end_bit) {
  const int bits = end_bit - shift < 8 ? end_bit - shift : 8;
  return (1ull << bits) - 1ull;
}

// every pass's digit counts in one read of the words
__global__ void __launch_bounds__(THREADS)
    pass_histograms(const u64* __restrict__ keys, long long n, int end_bit,
                    int passes, unsigned* __restrict__ hist) {
  __shared__ unsigned h[MAX_PASSES][RADIX];
  for (int p = 0; p < passes; ++p) h[p][threadIdx.x] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * THREADS *
                         HIST_ITEMS;
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS *
                        HIST_ITEMS;
       base < n; base += step) {
    u64 k[HIST_ITEMS];
    bool ok[HIST_ITEMS];
#pragma unroll
    for (int j = 0; j < HIST_ITEMS; ++j) {
      const long long i = base + j * THREADS + threadIdx.x;
      ok[j] = i < n;
      k[j] = ok[j] ? keys[i] : 0ull;
    }
#pragma unroll
    for (int j = 0; j < HIST_ITEMS; ++j) {
      for (int p = 0; p < passes; ++p) {
        const int d = static_cast<int>((k[j] >> (8 * p)) &
                                       digit_mask(8 * p, end_bit));
        const int d0 = __shfl_sync(FULL, d, 0);
        if (__all_sync(FULL, ok[j] && d == d0)) {
          if (lane == 0) atomicAdd(&h[p][d0], 32u);
        } else if (ok[j]) {
          atomicAdd(&h[p][d], 1u);
        }
      }
    }
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const unsigned c = h[p][threadIdx.x];
    if (c) atomicAdd(&hist[p * RADIX + threadIdx.x], c);
  }
}

// one pass: rank, look back, scatter through shared memory
__global__ void __launch_bounds__(THREADS, 2)
    onesweep_pass(const u64* __restrict__ keys_in,
                  const int* __restrict__ vals_in, long long n, int shift,
                  int end_bit, int pass, const unsigned* __restrict__ hist,
                  unsigned* __restrict__ tile_counter, u64* status,
                  u64* __restrict__ keys_out, int* __restrict__ vals_out) {
  typedef cub::BlockScan<int, THREADS> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ union {
    u64 k[TILE];
    int v[TILE];
  } buf;
  __shared__ int warp_cnt[WARPS][RADIX];
  __shared__ int tile_start[RADIX];   // digit d's first slot in the tile
  __shared__ int out_base[RADIX];     // output slot of tile slot 0, digit d
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(tile_counter, 1u));
#pragma unroll
  for (int w = 0; w < WARPS; ++w) warp_cnt[w][tid] = 0;
  // digit tid's start in this pass's output
  int gstart;
  Scan(scan_tmp).ExclusiveSum(static_cast<int>(hist[tid]), gstart);
  __syncthreads();
  const int tile = s_tile;
  const long long tbase = static_cast<long long>(tile) * TILE;
  const u64 dmask = digit_mask(shift, end_bit);

  // warp `warp` owns keys [wbase, wbase + 32 * ITEMS) of the tile, walked
  // in rounds of 32: index order is (warp, round, lane)
  const long long wbase = tbase + static_cast<long long>(warp) * (32 * ITEMS);
  u64 k[ITEMS];
  int v[ITEMS];
  int pos[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    k[j] = i < n ? keys_in[i] : 0ull;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    v[j] = i < n ? (vals_in ? vals_in[i] : static_cast<int>(i)) : 0;
  }
  // rank within the warp: the digit's count in earlier rounds plus the
  // lanes of this round before this one
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    const int d = i < n ? static_cast<int>((k[j] >> shift) & dmask) : RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    const int before = d < RADIX ? warp_cnt[warp][d] : 0;
    __syncwarp();
    if (d < RADIX && lane == __ffs(peers) - 1)
      warp_cnt[warp][d] = before + __popc(peers);
    __syncwarp();
    pos[j] = before + __popc(peers & lt);
  }
  __syncthreads();
  // digit tid: exclusive prefix over the warps, and the tile's count,
  // published at once for the tiles after this one
  int total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = warp_cnt[w][tid];
    warp_cnt[w][tid] = total;
    total += c;
  }
  const u64 tag = static_cast<u64>(pass + 1) << TAG_SHIFT;
  u64* mine = status + static_cast<long long>(tile) * RADIX + tid;
  store_relaxed(mine, tag | (tile == 0 ? PREFIX : AGGREGATE) |
                          static_cast<u64>(total));
  int tstart;
  Scan(scan_tmp).ExclusiveSum(total, tstart);
  tile_start[tid] = tstart;
  __syncthreads();
  // keys to their slot in the tile's digit order (this frees their
  // registers for the look-back)
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    if (i < n) {
      const int d = static_cast<int>((k[j] >> shift) & dmask);
      pos[j] += tile_start[d] + warp_cnt[warp][d];
      buf.k[pos[j]] = k[j];
    }
  }
  // decoupled look-back over the earlier tiles' counts of digit tid: LOOK
  // status words in flight a step (tile t, t-1, ...; before tile 0 reads
  // as an inclusive prefix of 0), taken in order up to the first not yet
  // published for this pass, or to an inclusive prefix
  int excl = 0;
  for (long long t = tile - 1; t >= 0;) {
    u64 w[LOOK];
#pragma unroll
    for (int q = 0; q < LOOK; ++q)
      w[q] = t - q >= 0 ? load_relaxed(status + (t - q) * RADIX + tid)
                        : (tag | PREFIX);
    int q = 0;
    bool found = false;
    for (; q < LOOK; ++q) {
      if ((w[q] >> TAG_SHIFT) != static_cast<u64>(pass + 1)) break;
      excl += static_cast<int>(w[q] & 0xffffffffull);
      if (w[q] & PREFIX) {
        found = true;
        break;
      }
    }
    if (found) break;
    t -= q;
  }
  if (tile > 0)
    store_relaxed(mine, tag | PREFIX | static_cast<u64>(excl + total));
  out_base[tid] = gstart + excl - tstart;
  __syncthreads();
  const int tn = static_cast<int>(n - tbase < TILE ? n - tbase : TILE);
  int ds[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int s = j * THREADS + tid;
    ds[j] = 0;
    if (s < tn) {
      const u64 key = buf.k[s];
      ds[j] = static_cast<int>((key >> shift) & dmask);
      keys_out[out_base[ds[j]] + s] = key;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = wbase + j * 32 + lane;
    if (i < n) buf.v[pos[j]] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int s = j * THREADS + tid;
    if (s < tn) vals_out[out_base[ds[j]] + s] = buf.v[s];
  }
}

int blocks_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 16) b = 132 * 16;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

extern "C" {

// keys per K8 tile
int tt_radix_tile() { return TILE; }

// K8's scratch for n keys, in 64-bit words
int tt_radix_scratch_words(long long n) {
  return HEADER_WORDS + static_cast<int>((n + TILE - 1) / TILE) * RADIX;
}

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
// the input (p = 0) or the other pair. Scratch: int64
// (tt_radix_scratch_words(n)), zeroed here.
int tt_radix_sort(const void* keys, const void* vals, long long n,
                  int end_bit, void* keys_a, void* vals_a, void* keys_b,
                  void* vals_b, void* scratch, void* stream) {
  if (n < 0 || n >= (1LL << 31) || end_bit < 0 || end_bit > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0 || end_bit == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n + TILE - 1) / TILE;
  const int passes = (end_bit + 7) / 8;
  u64* words = static_cast<u64*>(scratch);
  unsigned* counters = reinterpret_cast<unsigned*>(words);
  unsigned* hist = reinterpret_cast<unsigned*>(words + 8);
  u64* status = words + HEADER_WORDS;
  cudaMemsetAsync(scratch, 0,
                  static_cast<size_t>(HEADER_WORDS + n_tiles * RADIX) * 8,
                  st);
  long long hb = (n + THREADS * HIST_ITEMS - 1) / (THREADS * HIST_ITEMS);
  if (hb > 132 * 8) hb = 132 * 8;
  const u64* kin = static_cast<const u64*>(keys);
  const int* vin = static_cast<const int*>(vals);
  pass_histograms<<<static_cast<unsigned>(hb), THREADS, 0, st>>>(
      kin, n, end_bit, passes, hist);
  for (int p = 0; p < passes; ++p) {
    u64* kout = static_cast<u64*>(p % 2 == 0 ? keys_a : keys_b);
    int* vout = static_cast<int*>(p % 2 == 0 ? vals_a : vals_b);
    onesweep_pass<<<static_cast<unsigned>(n_tiles), THREADS, 0, st>>>(
        kin, vin, n, 8 * p, end_bit, p, hist + p * RADIX, counters + p,
        status, kout, vout);
    kin = kout;
    vin = vout;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
