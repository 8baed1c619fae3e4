// K22 member_compact — the live rows of B members over one slab, as
// member-major row ids.
//
// Replaces: tidb_tpu/executor/microbatch.py _demux's per-member
// `np.nonzero(live[k])[0]` over the batched program's [B, cap] live mask
// (device_emit.py:558 emit_batched's output), which the reference runs on
// the host after fetching every lane of every column. Here the ids are
// made on the card, K18 gathers every output column through them, and
// only live rows cross to the host. B = 1 is the individual filter
// path's compaction (the reference's `live` fetched whole and indexed on
// the host).
//
//   live [B, cap] bool → counts [B] int64, offsets [B + 1] int64
//   (offsets[k] = the live rows of members before k), ids [total] int32:
//   ids[offsets[k] + j] is the row of member k's j-th live row, in
//   ascending row order.
//
// What bounds it on an H100: bytes — the mask read once (one byte a row,
// B x cap bytes), each id written once (4 bytes a live row); the mask of
// a tile with live rows is read a second time by the scatter.
//
// Design. A tile is 128 KB of one member's mask in eight rounds of 16 KB
// (64 KB and 32 KB tiles measured slower: more look-backs):
// 256 threads, each lane four 16-byte loads a round, warp-striped (load
// k of lane l reads chunk k * 32 + l of its warp's 2 KB of the round),
// so every warp load covers 512 consecutive bytes. A member's tiles sit
// on the 16-byte grid below its first row, so only its first and last
// chunks carry bytes of another member or of no tensor (masked off; a
// 16-byte chunk that holds one byte of the mask lies inside its
// allocation). No tile straddles two
// members, and the tiles in member-major order are the scan order. A
// bool byte counts when it is non-zero (a carry trick sets bit 7 of
// every non-zero byte of a word; __popc counts them).
//   mc_count:   one block a tile, its id from an atomic counter (tile
//               order is launch order: a tile waits only on tiles already
//               running); the tile's count is reduced in the block and
//               published, and a decoupled look-back (Merrill and
//               Garland, 2016) over the earlier tiles' status gives its
//               exclusive prefix. The scan is segmented by member: a
//               state is (total, rows since the member's first tile,
//               whether it holds a member's first tile), so the member's
//               last tile writes its offsets[k] and counts[k] (and the
//               last tile offsets[B]); each tile also writes each of its
//               rounds' live rows and first output slot. Status protocol
//               as K13's scan_onepass: a flag word and payload slots a
//               tile, the payload written first and the flag with
//               st.release.gpu after it; a reader takes the flag with
//               ld.acquire.gpu, then the payload with ld.relaxed.gpu. The
//               flags and the tile counter are zeroed by one memset a
//               call.
//   (the count entry copies offsets[B] back to the host and waits: one
//   sync a call, then the wrapper allocates ids)
//   mc_scatter: one block a round (16 KB); a round whose count is 0
//               returns before touching its mask. Otherwise each lane
//               ranks its chunks' live rows (a warp scan of the chunk
//               counts, a block scan of the warp totals), stages each
//               load's row ids in its warp's shared memory in row order
//               and the warp writes them out as consecutive 4-byte
//               stores.
// No atomics but the tile counter: the order is the rows' own.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VECS = 4;                        // 16-byte loads a lane a round
constexpr int WARP_BYTES = 32 * VECS * 16;     // 2,048 rows a warp a round
constexpr int ROUND_BYTES = THREADS * VECS * 16;   // 16,384 rows a round
constexpr int ROUNDS = 8;
constexpr long long TILE = ROUND_BYTES * ROUNDS;   // 131,072 rows a tile
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ST_AGG = 1u;    // the tile's count is out
constexpr unsigned ST_INCL = 2u;   // its inclusive prefix is out
constexpr unsigned ST_HEAD = 4u;   // it is its member's first tile

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

// bit 7 of each byte of w set where the byte is non-zero
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// the bytes of word i of a 16-byte chunk whose offsets fall in [lo, hi),
// as a byte mask
__device__ __forceinline__ unsigned word_mask(int i, int lo, int hi) {
  unsigned m = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = 4 * i + j;
    if (o >= lo && o < hi) m |= 0xffu << (8 * j);
  }
  return m;
}

// Tile geometry. Member k's rows start at byte p_k = live + k * cap; its
// tiles start at the 16-byte boundary at or below p_k, `mtiles` a member.
struct Geometry {
  const unsigned char* live;
  long long cap;
  long long mtiles;
  int members;
};

// the chunk of load `v` of this lane in round `r` of tile (member, t):
// → its address and the in-member row of its first byte
__device__ __forceinline__ long long chunk_row(const Geometry& g,
                                               long long member,
                                               long long t, int r, int warp,
                                               int lane, int v,
                                               const uint4** chunk) {
  const uintptr_t pk = reinterpret_cast<uintptr_t>(g.live) +
                       static_cast<uintptr_t>(member * g.cap);
  const uintptr_t a = (pk & ~static_cast<uintptr_t>(15)) +
                      static_cast<uintptr_t>(t * TILE) +
                      static_cast<uintptr_t>(r * ROUND_BYTES +
                                             warp * WARP_BYTES +
                                             (v * 32 + lane) * 16);
  *chunk = reinterpret_cast<const uint4*>(a);
  return static_cast<long long>(a) - static_cast<long long>(pk);
}

// the four words of a chunk whose first byte is in-member row r, bytes
// outside [0, cap) cleared; a chunk with no byte in range is not read
__device__ __forceinline__ void load_chunk(const uint4* p, long long r,
                                           long long cap, unsigned w[4]) {
  if (r + 16 <= 0 || r >= cap) {
    w[0] = w[1] = w[2] = w[3] = 0u;
    return;
  }
  const uint4 x = __ldg(p);
  w[0] = nonzero_bytes(x.x);
  w[1] = nonzero_bytes(x.y);
  w[2] = nonzero_bytes(x.z);
  w[3] = nonzero_bytes(x.w);
  if (r < 0 || r + 16 > cap) {
    const int lo = r < 0 ? static_cast<int>(-r) : 0;
    const int hi = r + 16 > cap ? static_cast<int>(cap - r) : 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] &= word_mask(i, lo, hi);
  }
}

// ---- the segmented look-back --------------------------------------------

struct State {
  long long total;   // live rows of every tile folded in
  long long seg;     // live rows since the last member start folded in
  int head;          // a member's first tile is folded in
};

// a precedes b
__device__ __forceinline__ State op(const State& a, const State& b) {
  return State{a.total + b.total, b.head ? b.seg : a.seg + b.seg,
               a.head | b.head};
}

// the scratch: a 16-byte tile counter and a flag word a tile (zeroed by
// the entry's memset), then three int64 payload slots a tile (the tile's
// count, and the total and segment count of its inclusive prefix) and
// two int64 a round (its first output slot and its count). Laid
// out for the largest tile count of (members, cap), whatever the
// mask's alignment (ops/compact.py scratch_bytes mirrors it).
struct Status {
  unsigned* counter;
  unsigned* flags;
  long long* agg;
  long long* incl_total;
  long long* incl_seg;
  long long* round_first;   // a round's first output slot
  long long* round_count;   // a round's live rows
};

long long max_mtiles(long long cap) { return (cap + 15 + TILE - 1) / TILE; }

long long max_tiles(int members, long long cap) {
  const long long t = members * max_mtiles(cap);
  return t < 1 ? 1 : t;
}

long long zeroed_bytes(long long tiles) {
  return 16 + (4 * tiles + 15) / 16 * 16;
}

long long scratch_bytes(int members, long long cap) {
  const long long t = max_tiles(members, cap);
  return zeroed_bytes(t) + (3 + 2 * ROUNDS) * 8 * t;
}

Status status_of(void* scratch, int members, long long cap) {
  const long long t = max_tiles(members, cap);
  unsigned char* z = static_cast<unsigned char*>(scratch);
  long long* pay = reinterpret_cast<long long*>(z + zeroed_bytes(t));
  return Status{reinterpret_cast<unsigned*>(z),
                reinterpret_cast<unsigned*>(z + 16),
                pay,
                pay + t,
                pay + 2 * t,
                pay + 3 * t,
                pay + (3 + ROUNDS) * t};
}

// the exclusive prefix of `tile` (> 0), by warp 0: lane l reads tile
// t0 - l, waits for its flag, and the window's states up to the nearest
// inclusive prefix fold into one (the earlier tile on the left)
__device__ State look_back(const Status& st, long long tile, int lane) {
  State excl{0, 0, 0};
  for (long long t0 = tile - 1;; t0 -= 32) {
    const long long t = t0 - lane;
    unsigned f = ST_INCL | ST_HEAD;       // before tile 0: an empty prefix
    if (t >= 0) {
      do {
        f = load_acquire(st.flags + t);
      } while (f == 0u);
    }
    State v{0, 0, 0};
    if (t >= 0) {
      if (f & ST_INCL) {
        v.total = load_relaxed(st.incl_total + t);
        v.seg = load_relaxed(st.incl_seg + t);
      } else {
        v.total = v.seg = load_relaxed(st.agg + t);
      }
      v.head = (f & (ST_INCL | ST_HEAD)) ? 1 : 0;
    }
    const unsigned incl = __ballot_sync(FULL, (f & ST_INCL) != 0u);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    if (lane > stop) v = State{0, 0, 0};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      State y;
      y.total = __shfl_down_sync(FULL, v.total, d);
      y.seg = __shfl_down_sync(FULL, v.seg, d);
      y.head = __shfl_down_sync(FULL, v.head, d);
      if (lane + d < 32) v = op(y, v);
    }
    State w;
    w.total = __shfl_sync(FULL, v.total, 0);
    w.seg = __shfl_sync(FULL, v.seg, 0);
    w.head = __shfl_sync(FULL, v.head, 0);
    excl = op(w, excl);
    if (incl) break;
  }
  return excl;
}

__global__ void __launch_bounds__(THREADS)
    mc_count(Geometry g, Status st, long long* __restrict__ offsets,
             long long* __restrict__ counts) {
  __shared__ int s_tile;
  __shared__ int s_warp[ROUNDS][WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(st.counter, 1u));
  __syncthreads();
  const long long tile = s_tile;
  const long long member = tile / g.mtiles;
  const long long t = tile - member * g.mtiles;
  int c[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    c[r] = 0;
#pragma unroll
    for (int v = 0; v < VECS; ++v) {
      const uint4* p;
      const long long row = chunk_row(g, member, t, r, warp, lane, v, &p);
      unsigned w[4];
      load_chunk(p, row, g.cap, w);
      c[r] += __popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int x = __reduce_add_sync(FULL, c[r]);
    if (lane == 0) s_warp[r][warp] = x;
  }
  __syncthreads();
  if (warp != 0) return;
  int rc[ROUNDS];
  int tc = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    rc[r] = __reduce_add_sync(FULL, lane < WARPS ? s_warp[r][lane] : 0);
    tc += rc[r];
  }
  const int head = t == 0;
  const unsigned hflag = head ? ST_HEAD : 0u;
  State incl{tc, tc, head};
  if (tile == 0) {
    if (lane == 0) {
      st.agg[0] = tc;
      st.incl_total[0] = tc;
      st.incl_seg[0] = tc;
      store_release(st.flags, ST_INCL | hflag);
    }
  } else {
    if (lane == 0) {
      st.agg[tile] = tc;
      store_release(st.flags + tile, ST_AGG | hflag);
    }
    incl = op(look_back(st, tile, lane), incl);
    if (lane == 0) {
      st.incl_total[tile] = incl.total;
      st.incl_seg[tile] = incl.seg;
      store_release(st.flags + tile, ST_INCL | hflag);
    }
  }
  if (lane == 0) {
    long long first = incl.total - tc;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      st.round_first[tile * ROUNDS + r] = first;
      st.round_count[tile * ROUNDS + r] = rc[r];
      first += rc[r];
    }
  }
  if (lane == 0 && t == g.mtiles - 1) {
    offsets[member] = incl.total - incl.seg;
    counts[member] = incl.seg;
    if (member == g.members - 1) offsets[g.members] = incl.total;
  }
}

__global__ void __launch_bounds__(THREADS)
    mc_scatter(Geometry g, const long long* __restrict__ round_first,
               const long long* __restrict__ round_count,
               int* __restrict__ ids) {
  __shared__ int s_warp[WARPS];
  __shared__ int s_rows[WARPS][32 * 16];
  const long long s = blockIdx.x;        // tile * ROUNDS + round
  if (round_count[s] == 0) return;       // the whole block: no mask read
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = s / ROUNDS;
  const int r = static_cast<int>(s - tile * ROUNDS);
  const long long member = tile / g.mtiles;
  const long long t = tile - member * g.mtiles;
  unsigned w[VECS][4];
  long long row0[VECS];
  int cnt[VECS], incl[VECS];
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    const uint4* p;
    row0[v] = chunk_row(g, member, t, r, warp, lane, v, &p);
    load_chunk(p, row0[v], g.cap, w[v]);
    cnt[v] = __popc(w[v][0]) + __popc(w[v][1]) + __popc(w[v][2]) +
             __popc(w[v][3]);
    incl[v] = cnt[v];
  }
  // every load's lane counts scanned at once (inclusive)
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int v = 0; v < VECS; ++v) {
      const int y = __shfl_up_sync(FULL, incl[v], d);
      if (lane >= d) incl[v] += y;
    }
  }
  int wtotal = 0;
#pragma unroll
  for (int v = 0; v < VECS; ++v) wtotal += __shfl_sync(FULL, incl[v], 31);
  if (lane == 0) s_warp[warp] = wtotal;
  __syncthreads();
  long long dst = round_first[s];
  for (int i = 0; i < warp; ++i) dst += s_warp[i];
  int* rows = s_rows[warp];
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    const int total = __shfl_sync(FULL, incl[v], 31);
    if (total == 0) continue;            // warp-uniform
    int pos = incl[v] - cnt[v];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned bits = w[v][i];
      while (bits) {
        const int b = __ffs(bits) - 1;   // bit 7 of byte b >> 3
        rows[pos++] = static_cast<int>(row0[v] + 4 * i + (b >> 3));
        bits &= bits - 1u;
      }
    }
    __syncwarp();
    for (int j = lane; j < total; j += 32) ids[dst + j] = rows[j];
    __syncwarp();
    dst += total;
  }
}

bool bad_shape(const void* live, int members, long long cap) {
  return (live == nullptr && cap > 0) || members < 1 || members > 65535 ||
         cap < 0 || cap > 0x7fffffffLL ||
         static_cast<long long>(members) * max_mtiles(cap) * ROUNDS >
             0x7fffffffLL;
}

// the tiles of this mask: a member's rows from its 16-byte boundary
Geometry geometry_of(const void* live, int members, long long cap) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(live) & 15) == 0 && (cap & 15) == 0;
  const long long mt = aligned ? (cap + TILE - 1) / TILE : max_mtiles(cap);
  return Geometry{static_cast<const unsigned char*>(live), cap, mt,
                  members};
}

}  // namespace

extern "C" {

int tt_member_tile() { return static_cast<int>(TILE); }

long long tt_member_scratch_bytes(int members, long long cap) {
  return scratch_bytes(members, cap);
}

// live: members x cap bools (row-major, any byte alignment); scratch:
// tt_member_scratch_bytes(members, cap) bytes, its status zeroed here;
// offsets: members + 1 int64 (out); counts: members int64 (out); total:
// one host int64 (out), offsets[members] copied back once the count pass
// is done (the call waits for the stream).
int tt_member_count(const void* live, int members, long long cap,
                    void* scratch, void* offsets, void* counts,
                    long long* total, void* stream) {
  if (bad_shape(live, members, cap) || scratch == nullptr ||
      total == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launches
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap == 0) {
    cudaMemsetAsync(offsets, 0, 8 * (members + 1), s);
    cudaMemsetAsync(counts, 0, 8 * members, s);
    *total = 0;
    return static_cast<int>(cudaGetLastError());
  }
  const Geometry g = geometry_of(live, members, cap);
  cudaMemsetAsync(scratch, 0, zeroed_bytes(max_tiles(members, cap)), s);
  mc_count<<<static_cast<unsigned>(members * g.mtiles), THREADS, 0, s>>>(
      g, status_of(scratch, members, cap), static_cast<long long*>(offsets),
      static_cast<long long*>(counts));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyAsync(total, static_cast<long long*>(offsets) + members, 8,
                      cudaMemcpyDeviceToHost, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaStreamSynchronize(s));
}

// scratch: as tt_member_count left it; ids: offsets[members] int32 (out).
int tt_member_scatter(const void* live, int members, long long cap,
                      const void* scratch, void* ids, void* stream) {
  if (bad_shape(live, members, cap) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (cap == 0) return 0;
  const Geometry g = geometry_of(live, members, cap);
  const Status st = status_of(const_cast<void*>(scratch), members, cap);
  mc_scatter<<<static_cast<unsigned>(members * g.mtiles * ROUNDS), THREADS,
               0, static_cast<cudaStream_t>(stream)>>>(
      g, st.round_first, st.round_count, static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
