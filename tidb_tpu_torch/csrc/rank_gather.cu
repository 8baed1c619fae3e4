// K25 rank_gather — the monolithic program's tiled all_gather: every
// rank's piece of every column copied into one gathered buffer per column.
//
// Replaces: tidb_tpu/parallel/collective.py:151 broadcast_build and :158
// gather_partials (lax.all_gather(tiled=True) of the build columns, or of
// the partial keys, states and slot_live). On one card every rank reads
// the same gathered buffer, so the gather is one copy per (column, rank)
// piece: rank r's piece of a column lands at that column's offset
// off_r = n_0 + ... + n_{r-1}; a 2-D column (L rows, rows on the last
// axis) copies row l of rank r from src_r + l·n_r·size to out + (l·total
// + off_r)·size.
//
//   rg_copy  one launch takes a table of up to MAX_SEGS segments by value
//            (a segment is one rank's piece of one column: its source,
//            its row-0 destination, bytes a row, the column's row pitch,
//            its rows, and its first chunk). Every row of every segment
//            is cut into chunks of CHUNK bytes, numbered flatly across
//            the table; a grid sized to the SMs strides over the chunks,
//            and a block finds a chunk's segment by binary search over
//            the segments' first chunks (in shared memory), so big and
//            small pieces share the blocks. A chunk moves with the widest
//            access its segment's addresses, row length and pitch allow
//            (16, 8, 4, 2 or 1 bytes): 4 loads a thread in flight, then
//            4 stores.
//
// The host (ops/rank_gather.py gather_plan, cached by shape) builds one
// descriptor per column and expands it to segments, splits them into
// tables of MAX_SEGS, and numbers each table's chunks from 0; a call
// passes that table as it is, with the pieces' and the outputs' pointers
// beside it, and the entry fills in each segment's two addresses. More
// segments take more launches.
//
// What bounds it on an H100: bytes — every source byte read once and every
// gathered byte written once.
//
// C interface, bound with ctypes; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int CHUNK = THREADS * 16 * UNROLL;   // 16 KB
constexpr int MAX_SEGS = 80;                   // 3,856 B of parameters
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_DEVICES = 64;

// one segment as the kernel reads it
struct Seg {
  unsigned long long src;    // rank r's piece, row 0
  unsigned long long dst;    // out + off_r·size (row 0)
  long long row_bytes;       // n_r·size
  long long pitch;           // total·size: the column's row stride in out
  long long start;           // the segment's first chunk in its table
  int rows;                  // L (1 for a 1-D column)
  int row_chunks;            // ceil(row_bytes / CHUNK)
};

// one segment as the host plans it: 48 bytes ("<qqqqiiii")
struct Rec {
  long long dst_off;         // off_r·size
  long long row_bytes;
  long long pitch;
  long long start;
  int col;                   // index into the output pointers
  int rows;
  int row_chunks;
  int pad;
};

struct Table {
  Seg seg[MAX_SEGS];
  long long n_chunks;
  int n_segs;
};

template <typename T>
__device__ __forceinline__ void copy_chunk(const unsigned char* src,
                                           unsigned char* dst, int nb) {
  const int n = nb / static_cast<int>(sizeof(T));
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (int i0 = threadIdx.x; i0 < n; i0 += UNROLL * THREADS) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) v[u] = s[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) d[i] = v[u];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    rg_copy(const __grid_constant__ Table t) {
  __shared__ long long start[MAX_SEGS];
  const int ns = t.n_segs;
  for (int i = threadIdx.x; i < ns; i += THREADS) start[i] = t.seg[i].start;
  __syncthreads();
  for (long long c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    // the last segment whose first chunk is at or before c (every segment
    // of a table has at least one chunk)
    int lo = 0, hi = ns - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (start[mid] <= c)
        lo = mid;
      else
        hi = mid - 1;
    }
    const Seg& g = t.seg[lo];
    const long long k = c - start[lo];
    const long long row = k / g.row_chunks;
    const long long part = k - row * g.row_chunks;
    const long long left = g.row_bytes - part * CHUNK;
    const int nb = left < CHUNK ? static_cast<int>(left) : CHUNK;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(g.src) + row * g.row_bytes +
        part * CHUNK;
    unsigned char* dst = reinterpret_cast<unsigned char*>(g.dst) +
                         row * g.pitch + part * CHUNK;
    const unsigned long long a =
        g.src | g.dst | static_cast<unsigned long long>(g.row_bytes) |
        (g.rows > 1 ? static_cast<unsigned long long>(g.pitch) : 0ull);
    if ((a & 15) == 0)
      copy_chunk<uint4>(src, dst, nb);
    else if ((a & 7) == 0)
      copy_chunk<unsigned long long>(src, dst, nb);
    else if ((a & 3) == 0)
      copy_chunk<unsigned int>(src, dst, nb);
    else if ((a & 1) == 0)
      copy_chunk<unsigned short>(src, dst, nb);
    else
      copy_chunk<unsigned char>(src, dst, nb);
  }
}

int grid_limit() {
  static int sms[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 132 * BLOCKS_PER_SM;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132 * BLOCKS_PER_SM;
  return sms[dev] * BLOCKS_PER_SM;
}

}  // namespace

extern "C" {

int tt_rank_gather_chunk() { return CHUNK; }

int tt_rank_gather_max_segs() { return MAX_SEGS; }

// table: n_segs host records of 48 bytes (struct Rec), in tables of
// MAX_SEGS consecutive records, each table's `start` a prefix of its
// segments' chunks (rows · row_chunks each, at least 1) from 0; src:
// n_segs device pointers (each segment's piece), out: the columns' output
// pointers (indexed by a record's col), both in host arrays of uint64.
// The destinations must not overlap the sources or each other.
int tt_rank_gather(int n_segs, const void* table, const void* src,
                   const void* out, void* stream) {
  if (n_segs < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Rec* recs = static_cast<const Rec*>(table);
  const unsigned long long* s = static_cast<const unsigned long long*>(src);
  const unsigned long long* o = static_cast<const unsigned long long*>(out);
  cudaGetLastError();  // clear any stale error before our launches
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int limit = grid_limit();
  for (int i0 = 0; i0 < n_segs; i0 += MAX_SEGS) {
    const int k = n_segs - i0 < MAX_SEGS ? n_segs - i0 : MAX_SEGS;
    Table t;
    long long next = 0;
    for (int i = 0; i < k; ++i) {
      const Rec& r = recs[i0 + i];
      if (r.start != next || r.rows < 1 || r.row_bytes < 1 || r.col < 0 ||
          r.row_chunks != (r.row_bytes + CHUNK - 1) / CHUNK ||
          (r.rows > 1 && r.pitch < r.row_bytes))
        return static_cast<int>(cudaErrorInvalidValue);
      t.seg[i] = Seg{s[i0 + i], o[r.col] + static_cast<unsigned long long>(
                                               r.dst_off),
                     r.row_bytes, r.pitch, r.start, r.rows, r.row_chunks};
      next += static_cast<long long>(r.rows) * r.row_chunks;
    }
    t.n_segs = k;
    t.n_chunks = next;
    const long long grid = next < limit ? next : limit;
    rg_copy<<<static_cast<unsigned>(grid), THREADS, 0, st>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
