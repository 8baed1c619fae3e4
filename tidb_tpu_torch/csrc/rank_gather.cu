// K25 rank_gather — the monolithic program's tiled all_gather: every
// rank's piece of every column copied into one gathered buffer per column.
//
// Replaces: tidb_tpu/parallel/collective.py:151 broadcast_build and :158
// gather_partials (lax.all_gather(tiled=True) of the build columns, or of
// the partial keys, states and slot_live). On one card every rank reads
// the same gathered buffer, so the gather is one copy per (column, rank)
// piece: rank r's piece of a column lands at that column's offset r * n.
//
//   rg_copy  blockIdx.y picks one piece of the launch's item table (source
//            pointer, destination pointer, byte count); the blocks of x
//            stride over its bytes with the widest access that the two
//            addresses and the length allow (16, 8, 4, 2 or 1 bytes), so
//            1-, 2-, 4- and 8-byte items all move as aligned words.
//
// One launch takes MAX_ITEMS pieces (a column of 4 ranks is 4 pieces), so
// the gathers of the port's plans are one launch; more pieces take more.
//
// What bounds it on an H100: bytes — every source byte read once and every
// gathered byte written once.
//
// C interface, bound with ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ITEMS = 128;
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS_X = 4096;

struct Items {
  const unsigned char* src[MAX_ITEMS];
  unsigned char* dst[MAX_ITEMS];
  long long nbytes[MAX_ITEMS];
};

template <typename T>
__device__ __forceinline__ void copy_words(const unsigned char* src,
                                           unsigned char* dst, long long nb) {
  const long long n = nb / static_cast<long long>(sizeof(T));
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < n; j += stride)
    d[j] = s[j];
}

__global__ void __launch_bounds__(THREADS) rg_copy(Items items) {
  const int it = blockIdx.y;
  const unsigned char* src = items.src[it];
  unsigned char* dst = items.dst[it];
  const long long nb = items.nbytes[it];
  const unsigned long long a = reinterpret_cast<unsigned long long>(src) |
                               reinterpret_cast<unsigned long long>(dst) |
                               static_cast<unsigned long long>(nb);
  if ((a & 15) == 0)
    copy_words<uint4>(src, dst, nb);
  else if ((a & 7) == 0)
    copy_words<unsigned long long>(src, dst, nb);
  else if ((a & 3) == 0)
    copy_words<unsigned int>(src, dst, nb);
  else if ((a & 1) == 0)
    copy_words<unsigned short>(src, dst, nb);
  else
    copy_words<unsigned char>(src, dst, nb);
}

}  // namespace

extern "C" {

// src / dst: n_items device pointers in HOST arrays (uint64); nbytes:
// n_items host int64 byte counts. The destinations must not overlap the
// sources or each other.
int tt_rank_gather(int n_items, const void* src, const void* dst,
                   const void* nbytes, void* stream) {
  if (n_items < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long* s = static_cast<const unsigned long long*>(src);
  const unsigned long long* d = static_cast<const unsigned long long*>(dst);
  const long long* nb = static_cast<const long long*>(nbytes);
  for (int i = 0; i < n_items; ++i)
    if (nb[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launches
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i0 = 0; i0 < n_items; i0 += MAX_ITEMS) {
    const int k = n_items - i0 < MAX_ITEMS ? n_items - i0 : MAX_ITEMS;
    Items items;
    long long most = 0;
    for (int i = 0; i < k; ++i) {
      items.src[i] = reinterpret_cast<const unsigned char*>(s[i0 + i]);
      items.dst[i] = reinterpret_cast<unsigned char*>(d[i0 + i]);
      items.nbytes[i] = nb[i0 + i];
      if (nb[i0 + i] > most) most = nb[i0 + i];
    }
    if (most == 0) continue;
    long long bx = (most / 16 + THREADS - 1) / THREADS;
    if (bx < 1) bx = 1;
    if (bx > MAX_BLOCKS_X) bx = MAX_BLOCKS_X;
    rg_copy<<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(k)),
              THREADS, 0, st>>>(items);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
