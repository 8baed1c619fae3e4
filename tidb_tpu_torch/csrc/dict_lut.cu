// K21 dict_lut — one value per row from a per-dictionary lookup table,
// indexed by the row's dictionary code.
//
// Replaces: the device branches of tidb_tpu/expression/__init__.py that
// end in `xp.take(table, codes.astype(int32), mode="clip")`: the unary
// string functions (`_make_string_fn_kernel`, :858), the string functions
// with constant co-arguments (`_make_string_extra_kernel`, :961), CONCAT
// (`_concat`, :1020), LIKE (`_like`, :1134) and REGEXP (`_regexp_like`,
// :1161); and tidb_tpu/executor/tree_fragment.py `KeyRemap.eval` (:315),
// the probe-dictionary → build-dictionary remap of a string equi-join key
// (clip, take, then -1 where the code was out of range). The host
// prepares each table over the dictionary once per statement; the device
// work is the gather. Evaluated eagerly through torch it is three
// launches (astype, clamp, index; KeyRemap five), each over the slab.
//
//   clip mode: out[i] = lut[min(max(codes[i], 0), n_lut - 1)]
//   fill mode: out[i] = 0 <= codes[i] < n_lut ? lut[codes[i]] : fill
//
// codes are int32 or int64 (the decoded codes as they come, no astype
// pass); the table is 1 (bool), 4 or 8 bytes an entry, and the output has
// the table's type. n_lut == 0 reads no table: fill mode writes `fill`
// everywhere; clip mode is refused (jnp.take raises there too).
//
// What bounds it on an H100: bytes — a code read and a value written per
// row (at n = 8,388,608, int32 codes and int64 values are 100.7 MB,
// 0.030 ms at 3.35 TB/s), plus the table once. The table spans five
// orders of magnitude (l_shipmode's 7 entries, o_comment's 1,500,303),
// so two regimes:
//   - a table of at most 48 KB is staged into shared memory by every
//     block once, and the gathers hit shared memory;
//   - a larger one is read through the read-only path (__ldg); at 12 MB
//     (1.5M int64 entries) it stays resident in the 50 MB L2, so a random
//     gather costs an L2 sector, not an HBM one.
// One row per thread in a grid-stride loop; the grid is capped so a block
// stages its table once for many rows.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long SMEM_MAX = 48 * 1024;   // no opt-in attribute needed
constexpr int SMS = 132;

template <typename C, typename T, bool FILL>
__device__ __forceinline__ T lookup(const T* tab, C code, long long n_lut,
                                    T fill) {
  const long long c = static_cast<long long>(code);
  if (FILL) return (c >= 0 && c < n_lut) ? tab[c] : fill;
  const long long k = c < 0 ? 0 : (c >= n_lut ? n_lut - 1 : c);
  return tab[k];
}

template <typename C, typename T, bool FILL>
__global__ void lut_shared(const C* __restrict__ codes,
                           const T* __restrict__ lut, long long n_lut,
                           T fill, T* __restrict__ out, long long n) {
  extern __shared__ unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  for (long long k = threadIdx.x; k < n_lut; k += blockDim.x)
    tab[k] = lut[k];
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step)
    out[i] = lookup<C, T, FILL>(tab, codes[i], n_lut, fill);
}

template <typename C, typename T, bool FILL>
__global__ void lut_global(const C* __restrict__ codes,
                           const T* __restrict__ lut, long long n_lut,
                           T fill, T* __restrict__ out, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const long long c = static_cast<long long>(__ldg(codes + i));
    T v;
    if (FILL) {
      v = (c >= 0 && c < n_lut) ? __ldg(lut + c) : fill;
    } else {
      const long long k = c < 0 ? 0 : (c >= n_lut ? n_lut - 1 : c);
      v = __ldg(lut + k);
    }
    out[i] = v;
  }
}

// every row gets `fill`: fill mode over an empty table
template <typename T>
__global__ void lut_fill(T fill, T* __restrict__ out, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step)
    out[i] = fill;
}

int grid_for(long long n, int blocks_per_sm) {
  long long b = (n + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(SMS) * blocks_per_sm;
  if (b > cap) b = cap;
  return b < 1 ? 1 : static_cast<int>(b);
}

template <typename C, typename T, bool FILL>
void launch(const void* codes, const void* lut, long long n_lut,
            long long fill, void* out, long long n, cudaStream_t st) {
  const C* c = static_cast<const C*>(codes);
  const T* t = static_cast<const T*>(lut);
  T* o = static_cast<T*>(out);
  const T f = static_cast<T>(fill);
  if (n_lut == 0) {
    lut_fill<T><<<grid_for(n, 8), THREADS, 0, st>>>(f, o, n);
    return;
  }
  const long long bytes = n_lut * static_cast<long long>(sizeof(T));
  if (bytes <= SMEM_MAX) {
    // as many resident blocks as the SM's shared memory (about 227 KB)
    // holds, at most 8 (2,048 threads)
    long long per_sm = (227 * 1024) / (bytes > 0 ? bytes : 1);
    if (per_sm > 8) per_sm = 8;
    if (per_sm < 1) per_sm = 1;
    lut_shared<C, T, FILL><<<grid_for(n, static_cast<int>(per_sm)),
                             THREADS, static_cast<size_t>(bytes), st>>>(
        c, t, n_lut, f, o, n);
  } else {
    lut_global<C, T, FILL><<<grid_for(n, 8), THREADS, 0, st>>>(
        c, t, n_lut, f, o, n);
  }
}

template <typename C, typename T>
void launch_mode(int mode, const void* codes, const void* lut,
                 long long n_lut, long long fill, void* out, long long n,
                 cudaStream_t st) {
  if (mode == 1)
    launch<C, T, true>(codes, lut, n_lut, fill, out, n, st);
  else
    launch<C, T, false>(codes, lut, n_lut, fill, out, n, st);
}

template <typename C>
void launch_lut(int lut_bytes, int mode, const void* codes, const void* lut,
                long long n_lut, long long fill, void* out, long long n,
                cudaStream_t st) {
  switch (lut_bytes) {
    case 1:
      launch_mode<C, uint8_t>(mode, codes, lut, n_lut, fill, out, n, st);
      break;
    case 4:
      launch_mode<C, int32_t>(mode, codes, lut, n_lut, fill, out, n, st);
      break;
    default:
      launch_mode<C, long long>(mode, codes, lut, n_lut, fill, out, n, st);
  }
}

}  // namespace

extern "C" {

// codes: n int32 (code_bytes 4) or int64 (8) dictionary codes; lut: n_lut
// entries of lut_bytes (1 bool, 4 int32, 8 int64); mode 0 clip, 1 fill;
// fill: the fill-mode value for a code outside [0, n_lut), cast to the
// table's type; out: n entries of lut_bytes.
int tt_dict_lut(const void* codes, int code_bytes, const void* lut,
                int lut_bytes, long long n_lut, int mode, long long fill,
                void* out, long long n, void* stream) {
  if ((code_bytes != 4 && code_bytes != 8) ||
      (lut_bytes != 1 && lut_bytes != 4 && lut_bytes != 8) ||
      (mode != 0 && mode != 1) || n < 0 || n_lut < 0 ||
      (mode == 0 && n_lut == 0 && n > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launch
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (code_bytes == 4)
      launch_lut<int32_t>(lut_bytes, mode, codes, lut, n_lut, fill, out, n,
                          st);
    else
      launch_lut<long long>(lut_bytes, mode, codes, lut, n_lut, fill, out,
                            n, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// the largest table, in bytes, that the kernel stages in shared memory
int tt_dict_lut_smem_bytes() { return static_cast<int>(SMEM_MAX); }

}  // extern "C"
