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
// everywhere (every code lies outside [0, 0)); clip mode is refused
// (jnp.take raises there too).
//
// What bounds it on an H100: bytes — a code read and a value written per
// row (at n = 8,388,608, int32 codes and int64 values are 100.7 MB,
// 0.030 ms at 3.35 TB/s), plus the table once; for a table read at random
// through L2, the card's random-load rate (~90-100 G loads a second, so
// ~85-95 µs for 8,388,608 rows). The design:
//   - warp steps: a warp takes 512 rows a step for a bool table, 128
//     otherwise; a lane loads the codes of its one or two groups of
//     16 / sizeof(T) rows (16-byte loads; 8 for two int32 codes), makes
//     all its gathers, then stores each group with one 16-byte store, and
//     each of the warp's stores covers 512 contiguous bytes (whole
//     lines, no sector written in halves). The rows before the codes'
//     first 16-byte boundary (`head`, a codes view at an odd offset) and
//     after the last whole step (`tail`) are scalar rows. The caller
//     places the output so that row `head` is 16-byte aligned too
//     (ops/dict_lut.lut_plan);
//   - a table of at most SMEM_MAX bytes (200 KB: 25,600 int64 entries) is
//     staged in shared memory, once by each block of a persistent grid of
//     SMs x resident blocks (the dynamic shared-memory limit raised past
//     48 KB once per kernel and device); a larger one is gathered through
//     L2 (__ldg);
//   - streaming hints with a staged table only: codes read evict-first
//     (__ldcs), outputs stored evict-first (__stcs). Timed both ways on an
//     H100, they helped a staged table and cost an L2-gathered one 1-5%
//     (the 12 MB table stays in L2 without them), so that regime takes
//     default caching;
//   - 32-bit index arithmetic (n_lut < 2^31), grid-stride over steps.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr long long SMEM_MAX = 200 * 1024;
constexpr int RESERVED_SMEM = 1024;          // the runtime's share a block

// A warp step: 32 lanes x G store groups of RG rows each. A store group is
// one 16-byte store of RG = 16 / sizeof(T) rows; a lane's group j holds
// rows j * 32 * RG + lane * RG .. + RG - 1 of the step, so each of the
// warp's stores covers 512 contiguous bytes. G = 2 for int64 tables (4
// rows a lane), else 1 (16 rows for bool, 4 for int32).
template <typename T>
struct Step {
  static constexpr int RG = 16 / sizeof(T);
  static constexpr int G = sizeof(T) == 8 ? 2 : 1;
  static constexpr int ROWS = 32 * RG * G;
};

// int64 codes as clamped 32-bit: below 0 → -1, at or above 2^31 - 1 →
// INT32_MAX (n_lut < 2^31, so both sides keep their meaning)
__device__ __forceinline__ int narrow(long long c) {
  return c < 0 ? -1 : (c > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(c));
}

template <bool HINTS, typename V>
__device__ __forceinline__ V load_vec(const V* p) {
  return HINTS ? __ldcs(p) : __ldg(p);
}

// RG codes from an address aligned to their size (16 bytes, or 8 for two
// int32 codes)
template <int RG, bool HINTS>
__device__ __forceinline__ void load_codes(const int* p, int (&c)[RG]) {
  if (RG == 2) {
    const int2 x = load_vec<HINTS>(reinterpret_cast<const int2*>(p));
    c[0] = x.x;
    c[1] = x.y;
    return;
  }
#pragma unroll
  for (int j = 0; j < RG / 4; ++j) {
    const int4 x = load_vec<HINTS>(reinterpret_cast<const int4*>(p) + j);
    c[4 * j] = x.x;
    c[4 * j + 1] = x.y;
    c[4 * j + 2] = x.z;
    c[4 * j + 3] = x.w;
  }
}

template <int RG, bool HINTS>
__device__ __forceinline__ void load_codes(const long long* p,
                                           int (&c)[RG]) {
#pragma unroll
  for (int j = 0; j < RG / 2; ++j) {
    const longlong2 x =
        load_vec<HINTS>(reinterpret_cast<const longlong2*>(p) + j);
    c[2 * j] = narrow(x.x);
    c[2 * j + 1] = narrow(x.y);
  }
}

template <typename C>
__device__ __forceinline__ int code_at(const C* p) {
  if (sizeof(C) == 4) return static_cast<int>(*p);
  return narrow(static_cast<long long>(*p));
}

// SHARED: the staged table; else the table through L2 (and L1)
template <typename T, bool FILL, bool SHARED>
__device__ __forceinline__ T lookup(const T* tab, int c, int n_lut, T fill) {
  if (FILL) {
    if (c < 0 || c >= n_lut) return fill;
  } else {
    c = c < 0 ? 0 : (c >= n_lut ? n_lut - 1 : c);
  }
  return SHARED ? tab[c] : __ldg(tab + c);
}

template <bool HINTS, typename V>
__device__ __forceinline__ void store_vec(V* p, V v) {
  if (HINTS)
    __stcs(p, v);
  else
    *p = v;
}

// RG values to a 16-byte aligned address: one 16-byte store
template <int RG, bool HINTS>
__device__ __forceinline__ void store_group(unsigned char* p,
                                            const unsigned char (&v)[RG]) {
  unsigned u[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    u[q] = static_cast<unsigned>(v[4 * q]) |
           static_cast<unsigned>(v[4 * q + 1]) << 8 |
           static_cast<unsigned>(v[4 * q + 2]) << 16 |
           static_cast<unsigned>(v[4 * q + 3]) << 24;
  store_vec<HINTS>(reinterpret_cast<uint4*>(p),
                   make_uint4(u[0], u[1], u[2], u[3]));
}

template <int RG, bool HINTS>
__device__ __forceinline__ void store_group(int* p, const int (&v)[RG]) {
  store_vec<HINTS>(reinterpret_cast<int4*>(p),
                   make_int4(v[0], v[1], v[2], v[3]));
}

template <int RG, bool HINTS>
__device__ __forceinline__ void store_group(long long* p,
                                            const long long (&v)[RG]) {
  longlong2 w;
  w.x = v[0];
  w.y = v[1];
  store_vec<HINTS>(reinterpret_cast<longlong2*>(p), w);
}

// Rows [0, head) and [head + steps * ROWS, n) are scalar, one a thread;
// warp step k covers rows head + k * ROWS .. + ROWS - 1, its codes and
// outputs aligned (codes + head and out + head on 16-byte boundaries).
// The streaming hints go with the staged table (HINTS = SHARED).
template <typename C, typename T, bool FILL, bool SHARED>
__global__ void __launch_bounds__(THREADS, 2)
    lut_rows(const C* __restrict__ codes, const T* __restrict__ lut,
             int n_lut, T fill, T* __restrict__ out, int head,
             long long steps, int tail) {
  constexpr int RG = Step<T>::RG;
  constexpr int G = Step<T>::G;
  constexpr int ROWS = Step<T>::ROWS;
  constexpr bool HINTS = SHARED;
  extern __shared__ uint4 smem[];
  if (SHARED) {
    // the table once into shared memory: 16-byte copies where it is
    // aligned, then entry by entry
    const int bytes = n_lut * static_cast<int>(sizeof(T));
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(lut) & 15) == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(lut);
      const int vecs = bytes >> 4;
#pragma unroll 4
      for (int k = threadIdx.x; k < vecs; k += THREADS)
        smem[k] = __ldg(src + k);
      done = (vecs << 4) / static_cast<int>(sizeof(T));
    }
    T* s = reinterpret_cast<T*>(smem);
    for (int k = done + threadIdx.x; k < n_lut; k += THREADS)
      s[k] = __ldg(lut + k);
    __syncthreads();
  }
  const T* tab = SHARED ? reinterpret_cast<const T*>(smem) : lut;
  const long long g = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (g < head)
    out[g] = lookup<T, FILL, SHARED>(tab, code_at(codes + g), n_lut, fill);
  if (g < tail) {
    const long long r = head + steps * ROWS + g;
    out[r] = lookup<T, FILL, SHARED>(tab, code_at(codes + r), n_lut, fill);
  }
  const int lane = threadIdx.x & 31;
  const C* cs = codes + head + lane * RG;
  T* os = out + head + lane * RG;
  const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
  for (long long k = g >> 5; k < steps; k += warps) {
    int c[G][RG];
#pragma unroll
    for (int j = 0; j < G; ++j)
      load_codes<RG, HINTS>(cs + k * ROWS + j * 32 * RG, c[j]);
    T v[G][RG];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < RG; ++e)
        v[j][e] = lookup<T, FILL, SHARED>(tab, c[j][e], n_lut, fill);
#pragma unroll
    for (int j = 0; j < G; ++j)
      store_group<RG, HINTS>(os + k * ROWS + j * 32 * RG, v[j]);
  }
}

int device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

int sm_count(int dev) {
  static int sms[16] = {0};
  const bool cached = dev >= 0 && dev < 16;
  if (cached && sms[dev]) return sms[dev];
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  v = v > 0 ? v : 132;
  if (cached) sms[dev] = v;
  return v;
}

// per kernel and device, once: the dynamic shared-memory limit raised to
// SMEM_MAX (a function attribute holds for the device it was set on) and
// the blocks an SM holds with no shared memory (its registers' and
// threads' limit)
template <typename C, typename T, bool FILL, bool SHARED>
cudaError_t resident_blocks(int dev, int* per_sm) {
  static int blocks[16] = {0};
  const bool cached = dev >= 0 && dev < 16;
  if (cached && blocks[dev]) {
    *per_sm = blocks[dev];
    return cudaSuccess;
  }
  auto kernel = lut_rows<C, T, FILL, SHARED>;
  cudaError_t e = cudaSuccess;
  if (SHARED)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_MAX));
  int b = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, THREADS, 0);
  if (e != cudaSuccess) return e;
  *per_sm = b > 0 ? b : 1;
  if (cached) blocks[dev] = *per_sm;
  return cudaSuccess;
}

template <typename C, typename T, bool FILL, bool SHARED>
cudaError_t launch(const void* codes, const void* lut, int n_lut,
                   long long fill, void* out, int head, long long steps,
                   int tail, cudaStream_t st) {
  const int dev = device();
  int per_sm = 1;
  const cudaError_t e = resident_blocks<C, T, FILL, SHARED>(dev, &per_sm);
  if (e != cudaSuccess) return e;
  const int bytes = SHARED ? n_lut * static_cast<int>(sizeof(T)) : 0;
  if (SHARED) {
    // the SM's 228 KB over the table and the runtime's share, a block
    const int fit = (228 * 1024) / (bytes + RESERVED_SMEM);
    if (fit < per_sm) per_sm = fit;
  }
  long long grid = static_cast<long long>(sm_count(dev)) * per_sm;
  const long long want = (steps + THREADS / 32 - 1) / (THREADS / 32);
  if (want < grid) grid = want;
  if (grid < 1) grid = 1;
  lut_rows<C, T, FILL, SHARED>
      <<<static_cast<unsigned>(grid), THREADS, static_cast<size_t>(bytes),
         st>>>(static_cast<const C*>(codes), static_cast<const T*>(lut),
               n_lut, static_cast<T>(fill), static_cast<T*>(out), head, steps,
               tail);
  return cudaGetLastError();
}

template <typename C, typename T, bool FILL>
cudaError_t launch_regime(const void* codes, const void* lut, int n_lut,
                          long long fill, void* out, int head,
                          long long steps, int tail, cudaStream_t st) {
  if (static_cast<long long>(n_lut) * sizeof(T) <= SMEM_MAX)
    return launch<C, T, FILL, true>(codes, lut, n_lut, fill, out, head, steps,
                                    tail, st);
  return launch<C, T, FILL, false>(codes, lut, n_lut, fill, out, head, steps,
                                   tail, st);
}

template <typename C, typename T>
cudaError_t launch_mode(int mode, const void* codes, const void* lut,
                        int n_lut, long long fill, void* out, int head,
                        long long steps, int tail, cudaStream_t st) {
  if (mode == 1)
    return launch_regime<C, T, true>(codes, lut, n_lut, fill, out, head,
                                     steps, tail, st);
  return launch_regime<C, T, false>(codes, lut, n_lut, fill, out, head, steps,
                                    tail, st);
}

template <typename C>
cudaError_t launch_lut(int lut_bytes, int mode, const void* codes,
                       const void* lut, int n_lut, long long fill, void* out,
                       int head, long long steps, int tail, cudaStream_t st) {
  switch (lut_bytes) {
    case 1:
      return launch_mode<C, uint8_t>(mode, codes, lut, n_lut, fill, out, head,
                                     steps, tail, st);
    case 4:
      return launch_mode<C, int32_t>(mode, codes, lut, n_lut, fill, out, head,
                                     steps, tail, st);
    default:
      return launch_mode<C, long long>(mode, codes, lut, n_lut, fill, out,
                                       head, steps, tail, st);
  }
}

}  // namespace

extern "C" {

// codes: n int32 or int64 dictionary codes; lut: n_lut (< 2^31) entries
// of 1 (bool), 4 (int32) or 8 (int64) bytes; fill: the fill-mode value
// for a code outside [0, n_lut), cast to the table's type; out: n entries
// of the table's size. flags (ops/dict_lut.lut_plan): bits 0-3 the code
// bytes, 4-7 the table's, bit 8 fill mode (else clip), bits 12-15 `head`, the scalar rows before the warp steps: codes + head and
// out + head must be 16-byte aligned when a whole step follows (512 rows
// for a bool table, 128 otherwise).
int tt_dict_lut(const void* codes, const void* lut, long long n_lut,
                long long fill, void* out, long long n, int flags,
                void* stream) {
  const int code_bytes = flags & 15, lut_bytes = (flags >> 4) & 15;
  const int mode = (flags >> 8) & 1;
  const int head = (flags >> 12) & 15;
  if ((code_bytes != 4 && code_bytes != 8) ||
      (lut_bytes != 1 && lut_bytes != 4 && lut_bytes != 8) || n < 0 ||
      n_lut < 0 || n_lut >= (1LL << 31) ||
      (mode == 0 && n_lut == 0 && n > 0) || head * code_bytes >= 16 ||
      head > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = lut_bytes == 1 ? Step<uint8_t>::ROWS
                                  : (lut_bytes == 4 ? Step<int32_t>::ROWS
                                                    : Step<long long>::ROWS);
  const long long steps = (n - head) / rows;
  const int tail = static_cast<int>(n - head - steps * rows);
  if (steps > 0 &&
      (((reinterpret_cast<uintptr_t>(codes) + head * code_bytes) & 15) ||
       ((reinterpret_cast<uintptr_t>(out) + head * lut_bytes) & 15)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaGetLastError();  // clear any stale error before our launch
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nl = static_cast<int>(n_lut);
  return static_cast<int>(
      code_bytes == 4
          ? launch_lut<int32_t>(lut_bytes, mode, codes, lut, nl, fill, out,
                                head, steps, tail, st)
          : launch_lut<long long>(lut_bytes, mode, codes, lut, nl, fill, out,
                                  head, steps, tail, st));
}

// the largest table, in bytes, that the kernel stages in shared memory
int tt_dict_lut_smem_bytes() { return static_cast<int>(SMEM_MAX); }

}  // extern "C"
