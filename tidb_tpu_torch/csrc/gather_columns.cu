// K18 gather_columns — row gathers of several (value, mask) columns through
// one index vector, and the inverse of a permutation.
//
// Replaces: every row gather of tidb_tpu/executor/device_emit.py and
// tidb_tpu/executor/tree_fragment.py that takes rows through an index
// vector inside the traced program, `jnp.take(v, idx, axis=-1)` beside
// `jnp.take(m, idx) & keep` or `& (iota < n)`: emit_distinct's pair output
// through rep[:pc], the ROLLUP and factorize branches' key_out through
// rep, emit_merge's key_out, emit_finalize's and emit_root's output gathers
// (LIMIT, TopN, Sort), the join finishes' build and probe columns through
// match_idx / b_idx / p_idx, device_cache.py's aligned build columns
// through midx, the window argument gathers through the sort permutation,
// and the window results' way back to row order (`.at[perm].set(v)`),
// here a gather through the layout's inverse permutation, which one
// scatter of the slot numbers makes.
//   gather:  out_v[c][s]   = in_v[c][idx[s]]
//            out_m[c][s]   = in_m[c][idx[s]] && cut(s)
//   inverse: inv[perm[s]]  = s   (int32)
// where cut(s) = (n_valid ? s < *n_valid : 1) && (keep ? keep[s] : 1) and a
// null in_m reads as true. n_valid is read on the device, so the caller
// never syncs for it. A gather index outside [0, n) gives a zero value and
// a false mask; an index of perm outside [0, n) writes nothing. A column
// whose mask output is null writes no mask (a wide decimal's limb planes
// after the first, an aggregate state). Each 1-D column or limb plane is
// one entry ("plane") of the argument block.
//
// What bounds it on an H100: not bytes (per slot the index read once and
// per column one value of 1, 2, 4 or 8 bytes and one mask byte moved each
// way) but random accesses. Each gathered element is its own 32-byte L2
// sector; the card serves about 100 G of them a second from L2-resident
// sources, fewer from sources L2 cannot hold
// (tidb_tpu_torch/tools/scan_timing.py). Random stores into an output L2
// cannot hold run at about half the random loads' rate on an NVIDIA H100
// 80GB HBM3 at 700 W (a window result scattered back over 6,001,215
// rows: 0.49 ms, its gather through the inverse 0.24 ms; scan_timing.py),
// so the window scatters only the int32 slot numbers (the inverse), once a
// layout, and gathers every result of the layout through them.
//
// Design:
//   * each thread takes SLOTS = 4 consecutive slots: one 16-byte load of
//     their int32 indices (two for int64) where the index vector is
//     16-byte aligned, and the keep bytes of the four slots;
//   * gather: the planes go in groups of GROUP = 4; every value and mask
//     of the group is loaded for the four slots (read-only, `__ldg`, from
//     `__restrict__` sources) before any of them is stored, so a thread
//     keeps up to 32 gathers in flight; the four values of a plane leave as
//     one store (4 bytes of 1-byte values, 8 of 2-byte, 16 of 4-byte, two
//     16-byte stores of 8-byte values) and the four mask bytes as one
//     32-bit store, all streaming (evict-first) so the outputs do not push
//     the sources out of L2; an output not aligned for those stores (a
//     limb plane of an odd slot count) is stored slot by slot;
//   * inverse: a thread stores its four slot numbers one by one at their
//     rows;
//   * the planes go in passes whose gathered sources (values and masks)
//     stay within the header's `pass_bytes`, so that each pass's random
//     loads hit L2 (one column of a 2,097,152-row build is 18 MB; four of
//     them together would not fit the card's 50 MB): the grid sweeps every
//     slot quad of one pass before the next, re-reading the index and
//     keep vectors in order (4 + 1 bytes a slot a pass);
//   * a plane's width is uniform across the grid, so its dispatch is a
//     branch every warp takes the same way;
//   * one C call launches the planes 64 at a time; calls of at most 4
//     planes pass a 4-plane parameter block, the others a 64-plane one;
//     the grid is every SM at full residency
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), looping over the
//     passes and within each over the slot quads; a tail of fewer than 4
//     slots goes slot by slot;
//   * the host side packs one flat argument block of 64-bit words with one
//     `struct.pack` (ops/gather.py), read here as `Header` then `Plane`s.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_COLS = 64;
constexpr int SLOTS = 4;        // consecutive slots a thread takes
constexpr int GROUP = 4;        // planes whose loads go out together
typedef unsigned long long u64;

// one launch's planes, sized for C planes (the kernel parameter)
template <int C>
struct Cols {
  const void* src[C];
  const unsigned char* msrc[C];   // null: every row valid
  void* dst[C];
  unsigned char* mdst[C];         // null: no mask written
  int bytes[C];
  int first[C + 1];               // pass k: planes first[k]..first[k+1]-1
  int npass;
};

// the cut and keep of one launch (the kernel parameter)
struct Cut {
  const int* n_valid;             // null: no cut
  const unsigned char* keep;      // null: no keep mask
};

template <bool IDX64>
__device__ __forceinline__ void load_idx(const void* __restrict__ idx,
                                         long long s0, long long m, bool vec,
                                         long long* r) {
  if (vec) {
    if (IDX64) {
      const longlong2* p = reinterpret_cast<const longlong2*>(
          static_cast<const long long*>(idx) + s0);
      const longlong2 a = __ldcs(p), b = __ldcs(p + 1);
      r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
    } else {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(
          static_cast<const int*>(idx) + s0));
      r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const long long s = s0 + j;
    r[j] = s >= m ? -1
                  : (IDX64 ? static_cast<const long long*>(idx)[s]
                           : static_cast<long long>(
                                 static_cast<const int*>(idx)[s]));
  }
}

// the cut of slots s0..s0+3 (slot < m, below n_valid, keep), one bit a
// byte, little-endian in one word
__device__ __forceinline__ unsigned cut_word(const Cut& k, long long s0,
                                             long long m, long long nv) {
  unsigned w = 0u;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const long long s = s0 + j;
    bool b = s < m && s < nv;
    if (k.keep != nullptr && b) b = __ldcs(k.keep + s) != 0;
    w |= (b ? 1u : 0u) << (8 * j);
  }
  return w;
}

template <typename T>
__device__ __forceinline__ void load4(const void* __restrict__ src,
                                      const long long* r, const bool* ok,
                                      u64* v) {
  const T* __restrict__ p = static_cast<const T*>(src);
#pragma unroll
  for (int j = 0; j < SLOTS; ++j)
    v[j] = ok[j] ? static_cast<u64>(__ldg(p + r[j])) : 0ull;
}

__device__ __forceinline__ void load_values(const void* __restrict__ src,
                                            int bytes, const long long* r,
                                            const bool* ok, u64* v) {
  switch (bytes) {
    case 1: load4<unsigned char>(src, r, ok, v); break;
    case 2: load4<unsigned short>(src, r, ok, v); break;
    case 4: load4<unsigned int>(src, r, ok, v); break;
    default: load4<unsigned long long>(src, r, ok, v);
  }
}

// the gathered mask bytes of slots s0..s0+3 under the cut word
__device__ __forceinline__ unsigned load_mask(
    const unsigned char* __restrict__ msrc, const long long* r,
    const bool* ok, unsigned cut) {
  unsigned w = 0u;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    bool b = ok[j] && ((cut >> (8 * j)) & 1u);
    if (msrc != nullptr && b) b = __ldg(msrc + r[j]) != 0;
    w |= (b ? 1u : 0u) << (8 * j);
  }
  return w;
}

__device__ __forceinline__ void store_one(void* dst, int bytes, long long s,
                                          u64 v) {
  switch (bytes) {
    case 1: static_cast<unsigned char*>(dst)[s] =
                static_cast<unsigned char>(v); break;
    case 2: static_cast<unsigned short*>(dst)[s] =
                static_cast<unsigned short>(v); break;
    case 4: static_cast<unsigned*>(dst)[s] = static_cast<unsigned>(v); break;
    default: static_cast<u64*>(dst)[s] = v;
  }
}

// whether four values of `bytes` from a multiple-of-4 slot of dst can
// leave as the vector stores below
__device__ __forceinline__ bool vec_ok(const void* dst, int bytes) {
  const unsigned a = bytes >= 4 ? 16u : 4u * static_cast<unsigned>(bytes);
  return (reinterpret_cast<uintptr_t>(dst) & (a - 1u)) == 0u;
}

__device__ __forceinline__ void store_values(void* dst, int bytes,
                                             long long s0, long long m,
                                             bool full, const u64* v) {
  if (!full || !vec_ok(dst, bytes)) {
    for (int j = 0; j < SLOTS && s0 + j < m; ++j)
      store_one(dst, bytes, s0 + j, v[j]);
    return;
  }
  switch (bytes) {
    case 1:
      __stcs(static_cast<unsigned*>(dst) + s0 / 4,
             static_cast<unsigned>(v[0] | (v[1] << 8) | (v[2] << 16) |
                                   (v[3] << 24)));
      break;
    case 2:
      __stcs(static_cast<u64*>(dst) + s0 / 4,
             v[0] | (v[1] << 16) | (v[2] << 32) | (v[3] << 48));
      break;
    case 4:
      __stcs(reinterpret_cast<uint4*>(static_cast<unsigned*>(dst) + s0),
             make_uint4(static_cast<unsigned>(v[0]),
                        static_cast<unsigned>(v[1]),
                        static_cast<unsigned>(v[2]),
                        static_cast<unsigned>(v[3])));
      break;
    default: {
      ulonglong2* p = reinterpret_cast<ulonglong2*>(static_cast<u64*>(dst) +
                                                    s0);
      __stcs(p, make_ulonglong2(v[0], v[1]));
      __stcs(p + 1, make_ulonglong2(v[2], v[3]));
    }
  }
}

__device__ __forceinline__ void store_mask(unsigned char* mdst, long long s0,
                                           long long m, bool full,
                                           unsigned w) {
  if (full && (reinterpret_cast<uintptr_t>(mdst) & 3u) == 0u) {
    __stcs(reinterpret_cast<unsigned*>(mdst + s0), w);
    return;
  }
  for (int j = 0; j < SLOTS && s0 + j < m; ++j)
    mdst[s0 + j] = static_cast<unsigned char>((w >> (8 * j)) & 1u);
}

template <int C, bool IDX64>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(Cols<C> K, const void* __restrict__ idx, int idx_vec,
                  long long m, long long n_src, Cut cut) {
  const long long nv = cut.n_valid ? static_cast<long long>(*cut.n_valid)
                                   : m;
  const long long quads = (m + SLOTS - 1) / SLOTS;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (int p = 0; p < K.npass; ++p) {
    const int lo = K.first[p], hi = K.first[p + 1];
    for (long long q = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
         q < quads; q += step) {
      const long long s0 = q * SLOTS;
      const bool full = s0 + SLOTS <= m;
      long long r[SLOTS];
      load_idx<IDX64>(idx, s0, m, full && idx_vec, r);
      bool ok[SLOTS];
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) ok[j] = r[j] >= 0 && r[j] < n_src;
      const unsigned cw = cut_word(cut, s0, m, nv);
      // the 4-plane instantiation takes every plane of its pass in one
      // unrolled group: the planes' indices are then constants and the
      // argument block is read without indexing
      for (int c0 = C == GROUP ? 0 : lo; c0 < hi; c0 += GROUP) {
        u64 v[GROUP][SLOTS];
        unsigned mk[GROUP];
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const int c = c0 + g;
          if (c >= lo && c < hi) {
            load_values(K.src[c], K.bytes[c], r, ok, v[g]);
            if (K.mdst[c] != nullptr)
              mk[g] = load_mask(K.msrc[c], r, ok, cw);
          }
        }
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const int c = c0 + g;
          if (c >= lo && c < hi) {
            store_values(K.dst[c], K.bytes[c], s0, m, full, v[g]);
            if (K.mdst[c] != nullptr)
              store_mask(K.mdst[c], s0, m, full, mk[g]);
          }
        }
      }
    }
  }
}

// the inverse of a permutation: a thread's four slot numbers stored at
// their rows
template <bool IDX64>
__global__ void __launch_bounds__(THREADS)
    inverse_kernel(const void* __restrict__ perm, int idx_vec, long long m,
                   long long n, int* __restrict__ inv) {
  const long long quads = (m + SLOTS - 1) / SLOTS;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long q = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       q < quads; q += step) {
    const long long s0 = q * SLOTS;
    long long r[SLOTS];
    load_idx<IDX64>(perm, s0, m, s0 + SLOTS <= m && idx_vec, r);
#pragma unroll
    for (int j = 0; j < SLOTS; ++j)
      if (s0 + j < m && r[j] >= 0 && r[j] < n)
        inv[r[j]] = static_cast<int>(s0 + j);
  }
}

// SMs x resident blocks of `kernel`, found once a kernel
template <typename F>
int most_blocks(F kernel, int* most) {
  if (*most == 0) {
    int dev = 0, sms = 132, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS, 0);
    *most = sms * (per > 0 ? per : 1);
  }
  return *most;
}

int grid_of(long long quads, int most) {
  const long long b = (quads + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b > most ? most : static_cast<int>(b));
}

}  // namespace

// The argument block of one call (ops/gather.py `_pack`): a Header, then
// ncols Planes, every field a 64-bit word.
struct Header {
  const void* idx;                // m int32 (flags bit 0 clear) or int64
  const void* n_valid;            // a device int32 scalar, or null
  const void* keep;               // m bools, or null
  long long m;                    // slots (the index vector's length)
  long long n;                    // rows of each source
  long long flags;                // bit 0: int64 index
  long long ncols;                // planes, >= 1
  long long pass_bytes;           // the gathered sources' bytes a pass
                                  // may hold (0: one pass)
};

struct Plane {
  const void* src;
  const void* msrc;               // null: every row valid
  void* dst;
  void* mdst;                     // null: no mask written
  long long bytes;                // 1, 2, 4 or 8
};

namespace {

template <int C, bool IDX64>
void launch(const Header& h, const Plane* p, int k, cudaStream_t st) {
  Cols<C> K;
  K.npass = 0;
  long long held = 0;
  for (int c = 0; c < C; ++c) {
    const bool on = c < k;
    K.src[c] = on ? p[c].src : nullptr;
    K.msrc[c] = on ? static_cast<const unsigned char*>(p[c].msrc) : nullptr;
    K.dst[c] = on ? p[c].dst : nullptr;
    K.mdst[c] = on ? static_cast<unsigned char*>(p[c].mdst) : nullptr;
    K.bytes[c] = on ? static_cast<int>(p[c].bytes) : 1;
    if (!on) continue;
    // the gathered side of this plane: its values and the mask it moves
    const long long b = h.n * (p[c].bytes + (p[c].mdst != nullptr ? 1 : 0));
    if (K.npass == 0 || (h.pass_bytes > 0 && held + b > h.pass_bytes)) {
      K.first[K.npass++] = c;
      held = 0;
    }
    held += b;
  }
  K.first[K.npass] = k;
  const Cut cut{static_cast<const int*>(h.n_valid),
                static_cast<const unsigned char*>(h.keep)};
  const long long quads = (h.m + SLOTS - 1) / SLOTS;
  const int vec = (reinterpret_cast<uintptr_t>(h.idx) & 15u) == 0u;
  static int most = 0;
  const int grid = grid_of(quads, most_blocks(gather_kernel<C, IDX64>,
                                              &most));
  gather_kernel<C, IDX64><<<grid, THREADS, 0, st>>>(K, h.idx, vec, h.m, h.n,
                                                   cut);
}

template <bool IDX64>
void launch_all(const Header& h, const Plane* p, cudaStream_t st) {
  for (long long lo = 0; lo < h.ncols; lo += MAX_COLS) {
    const long long left = h.ncols - lo;
    const int k = static_cast<int>(left < MAX_COLS ? left : MAX_COLS);
    if (k <= GROUP)
      launch<GROUP, IDX64>(h, p + lo, k, st);
    else
      launch<MAX_COLS, IDX64>(h, p + lo, k, st);
  }
}

}  // namespace

extern "C" {

// args: one Header and its Planes (host memory). One launch per 64
// planes; no launch when m == 0.
int tt_gather_columns(const void* args, void* stream) {
  const Header& h = *static_cast<const Header*>(args);
  const Plane* p = reinterpret_cast<const Plane*>(&h + 1);
  if (h.ncols < 1 || h.m < 0 || h.n < 0 || (h.flags & ~1ll) != 0 ||
      h.idx == nullptr || h.pass_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (long long c = 0; c < h.ncols; ++c) {
    const long long b = p[c].bytes;
    if ((b != 1 && b != 2 && b != 4 && b != 8) || p[c].dst == nullptr ||
        p[c].src == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();  // clear any stale error before our launches
  if (h.m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h.flags & 1)
    launch_all<true>(h, p, st);
  else
    launch_all<false>(h, p, st);
  return static_cast<int>(cudaGetLastError());
}

// inv[perm[s]] = s for the m int32 (idx64 0) or int64 slots of perm into
// n int32 rows. One launch; none when m == 0.
int tt_inverse_permutation(const void* perm, int idx64, long long m,
                           long long n, void* inv, void* stream) {
  if (perm == nullptr || inv == nullptr || m < 0 || n < 0 ||
      (idx64 != 0 && idx64 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launch
  if (m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long quads = (m + SLOTS - 1) / SLOTS;
  const int vec = (reinterpret_cast<uintptr_t>(perm) & 15u) == 0u;
  int* out = static_cast<int*>(inv);
  if (idx64) {
    static int most = 0;
    inverse_kernel<true><<<grid_of(quads, most_blocks(inverse_kernel<true>,
                                                      &most)),
                           THREADS, 0, st>>>(perm, vec, m, n, out);
  } else {
    static int most = 0;
    inverse_kernel<false><<<grid_of(quads, most_blocks(inverse_kernel<false>,
                                                       &most)),
                            THREADS, 0, st>>>(perm, vec, m, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// the bytes of an argument block of `planes` planes, which the wrapper's
// packed block must match
int tt_gather_args_bytes(int planes) {
  return static_cast<int>(sizeof(Header) + planes * sizeof(Plane));
}

}  // extern "C"
