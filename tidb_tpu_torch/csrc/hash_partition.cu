// K23 hash_partition — one rank's rows scattered into fixed-capacity
// destination buckets: stage 1 of the staged exchange. The same file holds
// K24 rank_exchange and K26 hash_dest (see the end of this comment).
//
// Replaces: tidb_tpu/executor/device_emit.py:516 emit_partition, fed by
// tidb_tpu/parallel/collective.py:16-43 (_mix64, shard_of, mix_key_code)
// in tidb_tpu/executor/dist_fragment.py:602 _PartitionProgram._finish.
// The reference sorts (dest, row) pairs with lax.sort, ranks each row
// within its destination by a segment_min over the sorted order, and
// scatters every payload column into n_shards * bucket_cap zeroed slots.
// Here the rank comes from counts, not a sort:
//
//   hp_hist     one block per 1,024 rows: each row's key columns mix into
//               one code (canon = valid ? (int64) v : 0, part = canon*2 +
//               valid, code = code*1000003 + part, wrapping), the
//               splitmix64 finalizer spreads it, dest = h % n_shards (n_shards
//               for a dead row, stored as one byte); the block counts its
//               rows per destination (warp __match_any_sync, one shared
//               add per group of lanes) into hist[dest][block];
//   hp_scan     one block per destination: an exclusive scan over the
//               blocks turns hist[dest][*] into each block's first rank;
//               the total is counts[dest], and need = max(counts) by
//               atomicMax;
//   hp_scatter  re-reads the dest bytes: a row's rank is its block's base,
//               plus the rows of lower warps of the block with the same
//               dest (per-warp counts in shared memory, prefixed across
//               the 32 warps), plus the lower lanes of its __match_any_sync
//               group. Source order within a destination is kept (stable).
//               A live row with rank < bucket_cap writes every payload
//               column (grouped by itemsize: 1, 2, 4, 8 bytes) and
//               sent_live at slot dest*bucket_cap + rank; the rest are
//               dropped, and counts/need report the true per-bucket size.
//
// More than MAX_KEYS key columns fold in hp_mix passes through an int64
// code scratch; more than MAX_COLS payload columns of one itemsize take
// further hp_scatter launches (ranks recomputed from the dest bytes).
//
// What bounds it on an H100: bytes — each key column, the live mask and
// each payload column read once, the dest byte written and read back,
// and every one of the n_shards * bucket_cap slots of each output written
// once (the wrapper zero-fills them; at the generous bucket sizes of the
// staged exchange the fill is most of the bytes). The 64-bit multiplies
// and the 64-bit modulus are a few dozen integer operations a row.
//
// K24 rank_exchange — the monolithic program's all_to_all, fused into the
// scatter. Replaces tidb_tpu/parallel/collective.py:46 exchange (a bucket
// scatter, then lax.all_to_all swapping bucket d of shard s with bucket s
// of shard d). Every rank lives on one card, so the swap is an address:
// source rank s runs hx_hist (over its given destinations) and hp_scan
// as K23 does, then hp_xscatter writes a row of bucket d straight into
// destination d's receive buffers at slot s * bucket_cap + rank — one
// pointer per (column, destination), plus one receive-live pointer per
// destination. The caller zero-fills
// every receive buffer once, before the first source runs, and hands
// every source the same `need`: each source's hp_scan atomicMaxes its
// per-destination totals into it (the reference's pmax), which relies on
// the sources running in stream order. As the reference's exchange, it
// takes an int32 destination per row (K26 computes it; rows out of
// [0, n_shards) are dropped as dead ones). The rank keeps K23's stable
// (source row) order.
//
// K26 hash_dest — shard_of(mix_key_code(keys), n_shards), or
// shard_of(code) of one int64 code a row, as int32 per row, with no
// scatter and no live mask: K23's hp_hist key mix without the
// histogram. Replaces the exchanges' destinations (tidb_tpu/executor/
// dist_fragment.py:203, tidb_tpu/parallel/dist_query.py:103,106) and
// the owner hash over the gathered partials (dist_fragment.py:245-249,
// dist_query.py:48).
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int TILE = 1024;          // rows per block, one per thread
constexpr int WARPS = TILE / 32;
constexpr int MAX_SHARDS = 64;
constexpr int MAX_KEYS = 16;        // key columns per pass
constexpr int MAX_COLS = 16;        // payload columns per itemsize per launch

// key value types (ops/partition.py _KEY_TYPES)
enum KeyType { K_U8 = 0, K_I8 = 1, K_I16 = 2, K_I32 = 3, K_I64 = 4,
               K_F32 = 5, K_F64 = 6 };

struct Keys {
  const void* vals[MAX_KEYS];
  const unsigned char* valid[MAX_KEYS];
  int type[MAX_KEYS];
  int n;
};

struct Cols {
  const void* src[4][MAX_COLS];     // by itemsize 1, 2, 4, 8
  void* dst[4][MAX_COLS];
  int n[4];
};

__device__ __forceinline__ long long f64_to_i64(double x) {
  // the JAX package's astype(int64) truncates; NaN and out-of-range
  // values take the port's one definition (ops/partition.py key_canon)
  if (isnan(x)) return 0;
  if (x >= 9223372036854775808.0) return 0x7fffffffffffffffLL;
  if (x < -9223372036854775808.0) return static_cast<long long>(
      0x8000000000000000ULL);
  return static_cast<long long>(x);
}

__device__ __forceinline__ long long key_value(const void* p, int type,
                                               long long i) {
  switch (type) {
    case K_U8: return static_cast<const unsigned char*>(p)[i];
    case K_I8: return static_cast<const signed char*>(p)[i];
    case K_I16: return static_cast<const short*>(p)[i];
    case K_I32: return static_cast<const int*>(p)[i];
    case K_I64: return static_cast<const long long*>(p)[i];
    case K_F32: return f64_to_i64(static_cast<const float*>(p)[i]);
    default: return f64_to_i64(static_cast<const double*>(p)[i]);
  }
}

__device__ __forceinline__ unsigned long long fold_keys(
    const Keys& keys, long long i, bool has_code, unsigned long long code) {
  for (int k = 0; k < keys.n; ++k) {
    const bool m = keys.valid[k][i] != 0;
    const unsigned long long canon =
        m ? static_cast<unsigned long long>(key_value(keys.vals[k],
                                                      keys.type[k], i))
          : 0ULL;
    const unsigned long long part = canon * 2ULL + (m ? 1ULL : 0ULL);
    code = has_code ? code * 1000003ULL + part : part;
    has_code = true;
  }
  return code;
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

__global__ void __launch_bounds__(TILE)
    hp_mix(Keys keys, long long n, const long long* __restrict__ code_in,
           long long* __restrict__ code_out) {
  const long long i = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  if (i >= n) return;
  const bool has = code_in != nullptr;
  const unsigned long long c =
      fold_keys(keys, i, has, has ? static_cast<unsigned long long>(code_in[i])
                                  : 0ULL);
  code_out[i] = static_cast<long long>(c);
}

// Stores row i's destination d (n_shards for a dead or absent row) and
// the block's per-destination counts. Every thread of the block calls it.
__device__ __forceinline__ void block_hist(int d, long long i, long long n,
                                           int n_shards, long long nblocks,
                                           unsigned char* __restrict__ dest,
                                           int* __restrict__ hist) {
  __shared__ int cnt[MAX_SHARDS + 1];
  for (int t = threadIdx.x; t <= n_shards; t += TILE) cnt[t] = 0;
  __syncthreads();
  if (i < n) dest[i] = static_cast<unsigned char>(d);
  const unsigned grp = __match_any_sync(0xffffffffu, d);
  const int lane = threadIdx.x & 31;
  if (d < n_shards && (__ffs(grp) - 1) == lane)
    atomicAdd(&cnt[d], __popc(grp));
  __syncthreads();
  for (int t = threadIdx.x; t < n_shards; t += TILE)
    hist[static_cast<long long>(t) * nblocks + blockIdx.x] = cnt[t];
}

// K23: a live row's destination is the hash of its keys
__global__ void __launch_bounds__(TILE)
    hp_hist(Keys keys, const long long* __restrict__ code_in,
            const unsigned char* __restrict__ live, long long n,
            int n_shards, long long nblocks, unsigned char* __restrict__ dest,
            int* __restrict__ hist) {
  const long long i = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  int d = n_shards;
  if (i < n && live[i] != 0) {
    const bool has = code_in != nullptr;
    const unsigned long long code = fold_keys(
        keys, i, has,
        has ? static_cast<unsigned long long>(code_in[i]) : 0ULL);
    d = static_cast<int>(mix64(code) %
                         static_cast<unsigned long long>(n_shards));
  }
  block_hist(d, i, n, n_shards, nblocks, dest, hist);
}

// K24: a live row's destination is given (dead outside [0, n_shards))
__global__ void __launch_bounds__(TILE)
    hx_hist(const int* __restrict__ dest_in,
            const unsigned char* __restrict__ live, long long n,
            int n_shards, long long nblocks, unsigned char* __restrict__ dest,
            int* __restrict__ hist) {
  const long long i = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  int d = n_shards;
  if (i < n && live[i] != 0) {
    const int x = dest_in[i];
    d = x >= 0 && x < n_shards ? x : n_shards;
  }
  block_hist(d, i, n, n_shards, nblocks, dest, hist);
}

// block d: hist[d][0..nblocks) ← exclusive prefix; counts[d] ← total
__global__ void __launch_bounds__(TILE)
    hp_scan(int* __restrict__ hist, long long nblocks,
            int* __restrict__ counts, int* __restrict__ need) {
  typedef cub::BlockScan<int, TILE> Scan;
  __shared__ typename Scan::TempStorage tmp;
  int* row = hist + static_cast<long long>(blockIdx.x) * nblocks;
  int carry = 0;
  for (long long base = 0; base < nblocks; base += TILE) {
    const long long j = base + threadIdx.x;
    const int v = j < nblocks ? row[j] : 0;
    int ex, agg;
    Scan(tmp).ExclusiveSum(v, ex, agg);
    if (j < nblocks) row[j] = carry + ex;
    carry += agg;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = carry;
    atomicMax(need, carry);
  }
}

template <typename T>
__device__ __forceinline__ void copy_cols(const Cols& cols, int g,
                                          long long i, long long slot) {
  for (int c = 0; c < cols.n[g]; ++c)
    static_cast<T*>(cols.dst[g][c])[slot] =
        static_cast<const T*>(cols.src[g][c])[i];
}

// The rank of row i within its destination (K23's order: the block's
// base, the rows of lower warps with the same dest, the lower lanes of
// its __match_any_sync group), or -1 for a dead row. Every thread of the
// block must call it (it synchronizes the block).
__device__ __forceinline__ long long bucket_rank(
    const unsigned char* __restrict__ dest, long long i, long long n,
    int n_shards, long long nblocks, const int* __restrict__ base, int* d_out) {
  __shared__ int warp_cnt[WARPS][MAX_SHARDS + 1];
  for (int t = threadIdx.x; t < WARPS * (MAX_SHARDS + 1); t += TILE)
    (&warp_cnt[0][0])[t] = 0;
  __syncthreads();
  const int d = i < n ? dest[i] : n_shards;
  const unsigned grp = __match_any_sync(0xffffffffu, d);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (d < n_shards && (__ffs(grp) - 1) == lane) warp_cnt[warp][d] = __popc(grp);
  __syncthreads();
  for (int t = threadIdx.x; t < n_shards; t += TILE) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_cnt[w][t];
      warp_cnt[w][t] = run;
      run += c;
    }
  }
  __syncthreads();
  *d_out = d;
  if (d >= n_shards) return -1;
  return static_cast<long long>(base[static_cast<long long>(d) * nblocks +
                                     blockIdx.x]) +
         warp_cnt[warp][d] + __popc(grp & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(TILE)
    hp_scatter(const unsigned char* __restrict__ dest, long long n,
               int n_shards, long long nblocks, const int* __restrict__ base,
               long long bucket_cap, Cols cols,
               unsigned char* __restrict__ sent_live) {
  const long long i = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  int d;
  const long long rank = bucket_rank(dest, i, n, n_shards, nblocks, base, &d);
  if (rank < 0 || rank >= bucket_cap) return;
  const long long slot = static_cast<long long>(d) * bucket_cap + rank;
  copy_cols<unsigned char>(cols, 0, i, slot);
  copy_cols<unsigned short>(cols, 1, i, slot);
  copy_cols<unsigned int>(cols, 2, i, slot);
  copy_cols<unsigned long long>(cols, 3, i, slot);
  if (sent_live != nullptr) sent_live[slot] = 1;
}

// K24's payload: MAX_XPTRS destination pointers a launch, column-major
// (dst[c * n_shards + d] is column c's receive buffer on destination d)
constexpr int MAX_XPTRS = 256;
constexpr int MAX_XCOLS = 32;

struct XCols {
  const void* src[MAX_XCOLS];
  void* dst[MAX_XPTRS];
  int size[MAX_XCOLS];
  int n;
};

struct XLive {
  unsigned char* dst[MAX_SHARDS];
};

__global__ void __launch_bounds__(TILE)
    hp_xscatter(const unsigned char* __restrict__ dest, long long n,
                int n_shards, long long nblocks, const int* __restrict__ base,
                long long bucket_cap, long long src_rank, XCols cols,
                XLive recv_live, int write_live) {
  const long long i = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  int d;
  const long long rank = bucket_rank(dest, i, n, n_shards, nblocks, base, &d);
  if (rank < 0 || rank >= bucket_cap) return;
  const long long slot = src_rank * bucket_cap + rank;
  for (int c = 0; c < cols.n; ++c) {
    void* out = cols.dst[c * n_shards + d];
    const void* in = cols.src[c];
    switch (cols.size[c]) {
      case 1:
        static_cast<unsigned char*>(out)[slot] =
            static_cast<const unsigned char*>(in)[i];
        break;
      case 2:
        static_cast<unsigned short*>(out)[slot] =
            static_cast<const unsigned short*>(in)[i];
        break;
      case 4:
        static_cast<unsigned int*>(out)[slot] =
            static_cast<const unsigned int*>(in)[i];
        break;
      default:
        static_cast<unsigned long long*>(out)[slot] =
            static_cast<const unsigned long long*>(in)[i];
    }
  }
  if (write_live) recv_live.dst[d][slot] = 1;
}

__global__ void __launch_bounds__(TILE)
    hd_dest(Keys keys, const long long* __restrict__ code_in, long long n,
            int n_shards, int* __restrict__ dest) {
  const long long i = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  if (i >= n) return;
  const bool has = code_in != nullptr;
  const unsigned long long code =
      fold_keys(keys, i, has, has ? static_cast<unsigned long long>(code_in[i])
                                  : 0ULL);
  dest[i] = static_cast<int>(mix64(code) %
                             static_cast<unsigned long long>(n_shards));
}

int group_of(int itemsize) {
  switch (itemsize) {
    case 1: return 0;
    case 2: return 1;
    case 4: return 2;
    case 8: return 3;
    default: return -1;
  }
}

// Folds all but the last MAX_KEYS key columns into the int64 `code`
// scratch (hp_mix passes) and fills `keys` with the rest. `code_in` is a
// caller's precomputed code (n_keys may then be 0) or null; → the code
// the last pass continues from (null when there is none), or a bad value
// through *bad.
const long long* fold_passes(int n_keys, const void* key_vals,
                             const void* key_valid, const void* key_types,
                             const long long* code_in, long long n,
                             unsigned grid, cudaStream_t st, void* code,
                             Keys* keys, bool* bad) {
  const unsigned long long* kv = static_cast<const unsigned long long*>(
      key_vals);
  const unsigned long long* km = static_cast<const unsigned long long*>(
      key_valid);
  const int* kt = static_cast<const int*>(key_types);
  *bad = false;
  for (int k = 0; k < n_keys; ++k)
    if (kt[k] < K_U8 || kt[k] > K_F64) *bad = true;
  if (n_keys > MAX_KEYS && code == nullptr) *bad = true;
  if (*bad) return nullptr;
  long long* code_buf = static_cast<long long*>(code);
  int k0 = 0;
  while (n_keys - k0 > MAX_KEYS) {
    Keys pass;
    pass.n = MAX_KEYS;
    for (int k = 0; k < MAX_KEYS; ++k) {
      pass.vals[k] = reinterpret_cast<const void*>(kv[k0 + k]);
      pass.valid[k] = reinterpret_cast<const unsigned char*>(km[k0 + k]);
      pass.type[k] = kt[k0 + k];
    }
    if (grid > 0) hp_mix<<<grid, TILE, 0, st>>>(pass, n, code_in, code_buf);
    code_in = code_buf;
    k0 += MAX_KEYS;
  }
  keys->n = n_keys - k0;
  for (int k = 0; k < keys->n; ++k) {
    keys->vals[k] = reinterpret_cast<const void*>(kv[k0 + k]);
    keys->valid[k] = reinterpret_cast<const unsigned char*>(km[k0 + k]);
    keys->type[k] = kt[k0 + k];
  }
  return code_in;
}

}  // namespace

extern "C" {

// key_vals / key_valid: n_keys device pointers in a HOST array (uint64);
// key_types: n_keys host ints (KeyType); live: n bools; col_src / col_dst:
// n_cols device pointers in host arrays, col_size: n_cols host ints (1, 2,
// 4 or 8); sent_live: n_shards * bucket_cap bools and every col_dst
// n_shards * bucket_cap items, zero-filled by the caller; counts: n_shards
// int32 (out); need: one int32, zeroed by the caller (out); dest: n bytes
// scratch; hist: n_shards * ceil(n / 1024) int32 scratch (at least one);
// code: n int64 scratch when n_keys > 16, else may be null.
int tt_hash_partition(int n_keys, const void* key_vals, const void* key_valid,
                      const void* key_types, const void* live, long long n,
                      int n_shards, long long bucket_cap, int n_cols,
                      const void* col_src, const void* col_dst,
                      const void* col_size, void* sent_live, void* counts,
                      void* need, void* dest, void* hist, void* code,
                      void* stream) {
  if (n_keys < 1 || n_shards < 1 || n_shards > MAX_SHARDS || n < 0 ||
      bucket_cap < 0 || n_cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long* cs = static_cast<const unsigned long long*>(
      col_src);
  const unsigned long long* cd = static_cast<const unsigned long long*>(
      col_dst);
  const int* csz = static_cast<const int*>(col_size);
  for (int c = 0; c < n_cols; ++c)
    if (group_of(csz[c]) < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = (n + TILE - 1) / TILE;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launches
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(nblocks);
  Keys keys;
  bool bad;
  const long long* code_in = fold_passes(n_keys, key_vals, key_valid,
                                         key_types, nullptr, n, grid, st,
                                         code, &keys, &bad);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* dst = static_cast<unsigned char*>(dest);
  int* h = static_cast<int*>(hist);
  if (grid > 0)
    hp_hist<<<grid, TILE, 0, st>>>(keys, code_in,
                                   static_cast<const unsigned char*>(live), n,
                                   n_shards, nblocks, dst, h);
  hp_scan<<<n_shards, TILE, 0, st>>>(h, nblocks, static_cast<int*>(counts),
                                     static_cast<int*>(need));
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  // payload columns by itemsize, MAX_COLS of each per scatter launch; the
  // first launch also writes sent_live
  int next[4] = {0, 0, 0, 0};
  bool first = true;
  while (true) {
    Cols cols;
    int taken = 0;
    for (int g = 0; g < 4; ++g) cols.n[g] = 0;
    for (int c = 0; c < n_cols; ++c) {
      const int g = group_of(csz[c]);
      // the columns of group g in order; skip those an earlier launch took
      int seen = 0;
      for (int p = 0; p < c; ++p) seen += group_of(csz[p]) == g;
      if (seen < next[g] || cols.n[g] == MAX_COLS) continue;
      cols.src[g][cols.n[g]] = reinterpret_cast<const void*>(cs[c]);
      cols.dst[g][cols.n[g]] = reinterpret_cast<void*>(cd[c]);
      ++cols.n[g];
      ++taken;
    }
    if (!first && taken == 0) break;
    hp_scatter<<<grid, TILE, 0, st>>>(
        dst, n, n_shards, nblocks, h, bucket_cap, cols,
        first ? static_cast<unsigned char*>(sent_live) : nullptr);
    first = false;
    for (int g = 0; g < 4; ++g) next[g] += cols.n[g];
  }
  return static_cast<int>(cudaGetLastError());
}

// K24. dest_in: n int32 destinations (device; a row out of [0,
// n_shards) is dead); live: n bools; with n = 0 both may be null (an
// empty tensor's). src_rank: this source's index; col_src: n_cols device
// pointers (host array), col_size: n_cols host ints (1, 2, 4 or 8);
// col_dst: n_cols * n_shards device pointers (host array), column-major
// — column c's receive buffer on destination d, n_shards * bucket_cap
// items; live_dst: n_shards device pointers to the receive-live buffers.
// Every receive buffer is zero-filled by the caller before the first
// source. counts: n_shards int32 (out, this source's true bucket sizes);
// need: one int32 shared by every source, zeroed before the first (out:
// the largest bucket of any source so far); dest, hist: scratch as
// tt_hash_partition's.
int tt_rank_exchange(const void* dest_in, const void* live, long long n,
                     int n_shards, long long bucket_cap, long long src_rank,
                     int n_cols, const void* col_src, const void* col_size,
                     const void* col_dst, const void* live_dst, void* counts,
                     void* need, void* dest, void* hist, void* stream) {
  if (n_shards < 1 || n_shards > MAX_SHARDS || n < 0 || bucket_cap < 0 ||
      n_cols < 0 || src_rank < 0 || src_rank >= n_shards ||
      (n > 0 && (dest_in == nullptr || live == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long* cs = static_cast<const unsigned long long*>(
      col_src);
  const unsigned long long* cd = static_cast<const unsigned long long*>(
      col_dst);
  const unsigned long long* ld = static_cast<const unsigned long long*>(
      live_dst);
  const int* csz = static_cast<const int*>(col_size);
  for (int c = 0; c < n_cols; ++c)
    if (group_of(csz[c]) < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = (n + TILE - 1) / TILE;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launches
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(nblocks);
  unsigned char* dst = static_cast<unsigned char*>(dest);
  int* h = static_cast<int*>(hist);
  if (grid > 0)
    hx_hist<<<grid, TILE, 0, st>>>(static_cast<const int*>(dest_in),
                                   static_cast<const unsigned char*>(live), n,
                                   n_shards, nblocks, dst, h);
  hp_scan<<<n_shards, TILE, 0, st>>>(h, nblocks, static_cast<int*>(counts),
                                     static_cast<int*>(need));
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  XLive lv;
  for (int d = 0; d < n_shards; ++d)
    lv.dst[d] = reinterpret_cast<unsigned char*>(ld[d]);
  const int per_launch = MAX_XPTRS / n_shards < MAX_XCOLS
                             ? MAX_XPTRS / n_shards : MAX_XCOLS;
  int c0 = 0;
  do {
    XCols cols;
    cols.n = n_cols - c0 < per_launch ? n_cols - c0 : per_launch;
    for (int c = 0; c < cols.n; ++c) {
      cols.src[c] = reinterpret_cast<const void*>(cs[c0 + c]);
      cols.size[c] = csz[c0 + c];
      for (int d = 0; d < n_shards; ++d)
        cols.dst[c * n_shards + d] = reinterpret_cast<void*>(
            cd[static_cast<long long>(c0 + c) * n_shards + d]);
    }
    hp_xscatter<<<grid, TILE, 0, st>>>(dst, n, n_shards, nblocks, h,
                                       bucket_cap, src_rank, cols, lv,
                                       c0 == 0 ? 1 : 0);
    c0 += cols.n;
  } while (c0 < n_cols);
  return static_cast<int>(cudaGetLastError());
}

// K26. dest: n int32 (out) = shard_of(fold(code_in, keys)); the key
// arguments as tt_hash_partition's (n_keys may be 0 with a code_in);
// code: n int64 scratch when n_keys > 16, else may be null. Any n_shards
// of at least one.
int tt_hash_dest(int n_keys, const void* key_vals, const void* key_valid,
                 const void* key_types, const void* code_in, long long n,
                 int n_shards, void* dest, void* code, void* stream) {
  if (n_keys < 0 || n_shards < 1 || n < 0 ||
      (n > 0 && n_keys == 0 && code_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = (n + TILE - 1) / TILE;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launches
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(nblocks);
  Keys keys;
  bool bad;
  const long long* code0 = fold_passes(
      n_keys, key_vals, key_valid, key_types,
      static_cast<const long long*>(code_in), n, grid, st, code, &keys, &bad);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0)
    hd_dest<<<grid, TILE, 0, st>>>(keys, code0, n, n_shards,
                                   static_cast<int*>(dest));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
