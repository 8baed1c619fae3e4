// K2 unpack_decode — compressed column slabs to their logical values and
// validity masks, every column of a call in one launch.
//
// Replaces: tidb_tpu/chunk/compress.py _unpack_codes / decode_slab, as
// traced into every fragment by tidb_tpu/executor/device_emit.py
// emit_decode. The TPU form is a broadcast shift/mask over the word
// array that XLA fuses into the consumer; here it is a kernel of its own.
//
// Layouts (compress.ColLayout): `pack` (frame of reference: code + ref),
// `dict` (dictvals[min(code, card - 1)]), `delta` (base + inclusive
// cumsum of the codes), each at a packed width w in {1,2,4,8,16,32}, and
// width 0 (every value is `ref`; no words stored). The validity mask is
// always packed at width 1. Every slot equals the plain version's, not
// only the valid ones: a dead slot decodes code 0 (pack gives ref, dict
// dictvals[0], delta carries the running sum), and later kernels read
// those slots.
//
// What bounds it on an H100: bytes — the packed words read once, the
// values (8 or 4 B a row) and the mask (1 B a row) written once. The
// writes dominate: Q1's 7 columns of an 8,388,608-row slab write ~428 MB.
//
// Design. A call passes up to MAX_COLS column descriptors (kind, width,
// output type, pointers, ref, card) in the kernel's parameter block
// (__grid_constant__, so a block indexes its column's fields in place):
// no copy to the device. Each block decodes one (column, 4,096-row tile):
//   * the mask: thread t expands 16 mask bits into 16 bytes, one 16-byte
//     store, so a warp writes 512 contiguous bytes;
//   * the values: thread t takes groups of G = 16 / sizeof(value) rows
//     (group s * 256 + t of the tile), reads each row's code from word
//     i·w/32 at shift (i·w) mod 32 (neighbouring lanes read neighbouring
//     words, served by L1) and writes the group as one 16-byte store, so
//     every store instruction of a warp covers whole 128-byte lines; it
//     holds no codes between store steps, which keeps the registers of a
//     thread, and so the blocks an SM keeps in flight, where the stores
//     need them;
//   * a delta tile scans its group sums (a warp scan per store step, then
//     the S·8 warp totals in index order by warp 0) and takes its
//     column's prefix by decoupled look-back (lookback.cuh) over the
//     tiles before it in the same column, then reads its codes a second
//     time (L1 hits) to write each row's running sum. Tiles then take
//     their ids from an atomic counter, in column order, so a delta tile
//     waits only on tiles already running; pack and dict tiles never
//     wait. Without a delta column the tile is the block index and
//     nothing is zeroed.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4096;               // rows a block
constexpr int MAX_COLS = 16;             // columns a launch
constexpr int MAX_TOTALS = TILE / (THREADS * 2) * WARPS;

enum { KIND_PACK = 0, KIND_DICT = 1, KIND_DELTA = 2 };

// chunk/compress.py `_DecodeArgs` mirrors it
struct DecodeArgs {
  const unsigned* words[MAX_COLS];
  const unsigned* mask_words[MAX_COLS];
  const void* aux[MAX_COLS];             // dictvals (dict), base (delta)
  void* vals[MAX_COLS];
  unsigned char* mask[MAX_COLS];
  long long ref[MAX_COLS];
  int kind[MAX_COLS];
  int width[MAX_COLS];
  int dtype[MAX_COLS];                   // 0 int64, 1 int32
  int card[MAX_COLS];
  long long cap;
  int n_cols;
  int reserved;
};

struct Tiles {
  unsigned* counter;                     // null: the tile is blockIdx.x
  lookback::Status st;
  long long per_col;                     // tiles a column
  int dslot[MAX_COLS];                   // delta ordinal, -1 for others
};

__device__ __forceinline__ void decode_mask(const unsigned* mw,
                                            unsigned char* mask,
                                            long long row0, long long cap) {
  const long long r = row0 + 16 * threadIdx.x;
  if (r >= cap) return;
  const unsigned bits = (__ldg(mw + (r >> 5)) >> (r & 16)) & 0xffffu;
  unsigned q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)      // 4 bits → 4 bytes of 0 or 1
    q[i] = (((bits >> (4 * i)) & 0xfu) * 0x00204081u) & 0x01010101u;
  if (r + 16 <= cap) {
    *reinterpret_cast<uint4*>(mask + r) = make_uint4(q[0], q[1], q[2], q[3]);
  } else {
    for (int e = 0; r + e < cap; ++e)
      mask[r + e] = static_cast<unsigned char>((bits >> e) & 1u);
  }
}

template <typename OutT, int G>
__device__ __forceinline__ void store_group(OutT* out, int r, int cap,
                                            const OutT (&v)[G]) {
  if (r + G <= cap) {
    uint4 u;
    memcpy(&u, v, sizeof(u));
    *reinterpret_cast<uint4*>(out + r) = u;
  } else {
#pragma unroll
    for (int e = 0; e < G; ++e)
      if (r + e < cap) out[r + e] = v[e];
  }
}

template <typename OutT>
__device__ void decode_values(const DecodeArgs& a, const Tiles& tl, int col,
                              long long rt, long long* s_tot) {
  constexpr int G = 16 / sizeof(OutT);           // rows a 16-byte store
  constexpr int S = TILE / (THREADS * G);        // stores a thread
  constexpr int NE = S * WARPS;                  // warp totals a tile
  constexpr int EPL = NE / 32;                   // of them a lane of warp 0
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = static_cast<int>(a.cap);
  const int row0 = static_cast<int>(rt) * TILE + threadIdx.x * G;
  const int w = a.width[col];
  OutT* out = static_cast<OutT*>(a.vals[col]);
  OutT v[G];
  if (w == 0) {                                  // every value is ref
#pragma unroll
    for (int e = 0; e < G; ++e) v[e] = static_cast<OutT>(a.ref[col]);
#pragma unroll
    for (int s = 0; s < S; ++s)
      store_group<OutT, G>(out, row0 + s * THREADS * G, cap, v);
    return;
  }
  // row r's code: word r >> (5 - lw), shift (r << lw) & 31 (w = 2^lw)
  const unsigned* words = a.words[col];
  const int lw = __ffs(w) - 1;
  const unsigned m = w == 32 ? 0xffffffffu : ((1u << w) - 1u);
  auto code = [&](int r) -> unsigned {
    return r < cap ? (__ldg(words + (r >> (5 - lw))) >>
                      ((static_cast<unsigned>(r) << lw) & 31u)) & m
                   : 0u;
  };
  const int kind = a.kind[col];
  if (kind == KIND_DELTA) {
    // pass 1: each group's code sum, scanned over the warp a store step
    long long ex[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      long long g = 0;
#pragma unroll
      for (int e = 0; e < G; ++e) g += code(row0 + s * THREADS * G + e);
      ex[s] = lookback::warp_inclusive(g, lane);
      if (lane == 31) s_tot[s * WARPS + warp] = ex[s];
      const long long up = __shfl_up_sync(lookback::FULL, ex[s], 1);
      ex[s] = lane == 0 ? 0 : up;                // exclusive in the warp
    }
    __syncthreads();
    if (warp == 0) {
      // totals in row order: store step s, then warp
      long long t[EPL];
      long long ls = 0;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        t[e] = s_tot[lane * EPL + e];
        ls += t[e];
      }
      const long long li = lookback::warp_inclusive(ls, lane);
      const long long agg = __shfl_sync(lookback::FULL, li, 31);
      const long long first = tl.dslot[col] * tl.per_col;
      const long long pre =
          lookback::tile_prefix(tl.st, first, first + rt, agg, lane);
      long long run = *static_cast<const long long*>(a.aux[col]) + pre +
                      li - ls;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        s_tot[lane * EPL + e] = run;             // exclusive, base added
        run += t[e];
      }
    }
    __syncthreads();
    // pass 2: the codes again (L1 hits), each row's running sum
#pragma unroll
    for (int s = 0; s < S; ++s) {
      long long run = s_tot[s * WARPS + warp] + ex[s];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        run += code(row0 + s * THREADS * G + e);
        v[e] = static_cast<OutT>(run);
      }
      store_group<OutT, G>(out, row0 + s * THREADS * G, cap, v);
    }
    return;
  }
  const OutT* dict = static_cast<const OutT*>(a.aux[col]);
  const unsigned top = static_cast<unsigned>(a.card[col] - 1);
  const long long ref = a.ref[col];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const unsigned c = code(row0 + s * THREADS * G + e);
      v[e] = kind == KIND_DICT
                 ? __ldg(dict + (c < top ? c : top))
                 : static_cast<OutT>(static_cast<long long>(c) + ref);
    }
    store_group<OutT, G>(out, row0 + s * THREADS * G, cap, v);
  }
}

__global__ void __launch_bounds__(THREADS)
    decode_columns(const __grid_constant__ DecodeArgs a,
                   const __grid_constant__ Tiles tl) {
  __shared__ long long s_tot[MAX_TOTALS];
  __shared__ unsigned s_tile;
  unsigned id = blockIdx.x;
  if (tl.counter != nullptr) {
    if (threadIdx.x == 0) s_tile = atomicAdd(tl.counter, 1u);
    __syncthreads();
    id = s_tile;
  }
  const int col = static_cast<int>(id / tl.per_col);
  const long long rt = id - col * tl.per_col;
  decode_mask(a.mask_words[col], a.mask[col], rt * TILE, a.cap);
  if (a.dtype[col] == 0)
    decode_values<long long>(a, tl, col, rt, s_tot);
  else
    decode_values<int>(a, tl, col, rt, s_tot);
}

long long tiles_of(long long cap) { return (cap + TILE - 1) / TILE; }

// Scratch for n_delta delta columns (chunk/compress.py
// decode_scratch_bytes mirrors it): the zeroed part, a 16-byte tile
// counter and a 4-byte flag a delta tile rounded up to 16 bytes, then
// the delta tiles' aggregates and inclusive prefixes, 8 bytes each.
long long zeroed_bytes(int n_delta, long long cap) {
  return 16 + (4 * n_delta * tiles_of(cap) + 15) / 16 * 16;
}

long long scratch_bytes(int n_delta, long long cap) {
  return n_delta ? zeroed_bytes(n_delta, cap) +
                       16LL * n_delta * tiles_of(cap)
                 : 0;
}

}  // namespace

extern "C" {

// args: a host DecodeArgs (1..MAX_COLS columns of one cap, 0 <= cap <
// 2^31 - TILE; each column's words hold ceil(cap·w/32) words, its mask words
// ceil(cap/32), dict columns card values of the output type, delta
// columns one int64 base; outputs 16-byte aligned). scratch: at least
// scratch_bytes(delta columns, cap) bytes of the stream's scratch (may be
// null without a delta column). One memset (delta columns only) and one
// launch.
int tt_unpack_decode(const void* args, void* scratch,
                     long long scratch_len, void* stream) {
  DecodeArgs a;
  memcpy(&a, args, sizeof(a));
  if (a.n_cols < 1 || a.n_cols > MAX_COLS || a.cap < 0 ||
      a.cap > (1LL << 31) - 1 - TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  Tiles tl;
  int n_delta = 0;
  for (int c = 0; c < a.n_cols; ++c) {
    const int w = a.width[c];
    if (a.kind[c] < 0 || a.kind[c] > 2 || w < 0 || w > 32 ||
        (w != 0 && 32 % w != 0) || a.dtype[c] < 0 || a.dtype[c] > 1 ||
        (a.kind[c] == KIND_DICT && w != 0 && a.card[c] < 1))
      return static_cast<int>(cudaErrorInvalidValue);
    tl.dslot[c] = (a.kind[c] == KIND_DELTA && w != 0) ? n_delta++ : -1;
  }
  for (int c = a.n_cols; c < MAX_COLS; ++c) tl.dslot[c] = -1;
  if (scratch_len < scratch_bytes(n_delta, a.cap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launch
  if (a.cap == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tl.per_col = tiles_of(a.cap);
  tl.counter = nullptr;
  tl.st = lookback::Status{nullptr, nullptr, nullptr};
  if (n_delta) {
    unsigned char* sc = static_cast<unsigned char*>(scratch);
    const long long z = zeroed_bytes(n_delta, a.cap);
    tl.counter = reinterpret_cast<unsigned*>(sc);
    tl.st.flags = reinterpret_cast<unsigned*>(sc + 16);
    tl.st.agg = reinterpret_cast<long long*>(sc + z);
    tl.st.incl = tl.st.agg + n_delta * tl.per_col;
    cudaMemsetAsync(sc, 0, z, st);
  }
  decode_columns<<<static_cast<unsigned>(a.n_cols * tl.per_col), THREADS, 0,
                   st>>>(a, tl);
  return static_cast<int>(cudaGetLastError());
}

int tt_unpack_max_cols(void) { return MAX_COLS; }

int tt_unpack_args_bytes(void) { return static_cast<int>(sizeof(DecodeArgs)); }

}  // extern "C"
