// K20 civil_date — calendar parts of DATE days and DATETIME microseconds,
// and DATE_ADD by months, in registers.
//
// Replaces: tidb_tpu/expression/__init__.py `_date_part` (:1408),
// `_civil_from_days` / `_days_from_civil` (:1854-1879), the month /
// quarter / year branch of `_date_add_interval` (:1897-1950), and
// `dayofweek`, `weekday`, `dayofyear`, `quarter`, `week`, `last_day`,
// `_time_part` (:1947-2035). The reference writes each as a chain of
// integer jnp ops that XLA fuses into one pass per slab; evaluated
// eagerly in torch the same chain is 20-40 launches, each over a
// full-slab int64 temporary.
//
//   civil_part:      v (int32 days, int64 days or int64 µs) → one part
//                    per row: year, month, day, dayofyear, quarter, week
//                    (mode 0), last_day (int32 days), dayofweek, weekday,
//                    hour, minute, second; every other part int64. Time
//                    parts of a days input are 0, as the reference's.
//   date_add_months: v + n·mult months (n per row or one for all rows,
//                    mult 1, 3 or 12), the day clamped to the target
//                    month's length; µs inputs keep their time of day.
//                    Output int32 days, or int64 µs.
//
// Exactness: the outputs equal the reference's on every input. Each
// kernel is an instance for one (input kind, part) or (input kind, count
// per row or scalar, mult), so every divisor is a constant: no software
// 64-bit division. A warp takes the 32-bit path when all its rows are in
// its proven range (`__all_sync`); otherwise the 64-bit path, whose int64
// adds and multiplies wrap as the reference's do (through uint64) and
// whose divisions floor as jnp's `//` does.
//
// The 32-bit path (proof). Let z = days + Z0, Z0 = 719468 + 146097·800:
// z counts days from (-320000)-03-01, 800 whole 400-year eras before
// Hinnant's origin 0000-03-01, so every calendar quantity keeps its
// residue mod 400 years and Hinnant's era decomposition of z holds with
// era = z / 146097 and the year Y = 400·era + yoe shifted by 320,000.
// Rows with days in [LO, HI] = [-Z0, 2^32 - 8 - Z0] =
// [-117,597,068, 4,177,370,220] have 0 <= z <= 2^32 - 8, so z, its
// quotients and z + 6 fit uint32; Y <= 11,759,120. That range holds every
// int32 day from -719,468 up (every int32 day from -117,597,068 up) and
// every day of a µs input (|floor(µs / DAY_US)| <= 106,751,992). Inside
// it the reference's int64 arithmetic never wraps, so its results are
// the exact calendar values, which the 32-bit path computes:
//   year = Y - 320000 (+1 in Jan/Feb), month, day, quarter as Hinnant;
//   dayofyear from the March-based day of year doy and the leap rule of
//   yoe (the year's residue mod 400); week (mode 0) from dayofyear and
//   the weekday (z + c) mod 7; last_day = days - day + the month's length
//   (a 32-bit result, as the reference's int32 cast); date_add_months
//   from U = 12·Y + (March-based month) + months, the target month's
//   index since (-320000)-03, whenever 0 <= U < 2^32: its first day is
//   Hinnant's days_from_civil of U / 12, U mod 12 (one evaluation, in
//   64-bit), its length from the same table and leap rule, and the day
//   is clamped to it. Rows outside, and months that leave [0, 2^32), take
//   the 64-bit path.
//
// Memory: each thread takes 4 (int32 input) or 2 (int64 input) rows with
// 16-byte loads and stores from the input's first 16-byte boundary; the
// rows before it (`head`) and after the last whole group are scalar, and
// a call whose output or month counts are not aligned with the input
// takes every row scalar. Grid-stride over the card's SMs.
//
// What bounds it on an H100: bytes (4 or 8 in and 4 or 8 out a row, 8
// more for a per-row month count). The 32-bit path is 20-45 integer
// operations a row.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr long long DAY_US = 86400000000LL;

enum Kind { DAYS32 = 0, DAYS64 = 1, MICROS = 2 };
enum Part {
  YEAR = 0, MONTH, DAY, DAYOFYEAR, QUARTER, WEEK, LAST_DAY, DAYOFWEEK,
  WEEKDAY, HOUR, MINUTE, SECOND, N_PARTS
};

// the 32-bit path's origin and range (the proof above)
constexpr long long SHIFT_ERAS = 800;
constexpr long long Z0 = 719468 + 146097 * SHIFT_ERAS;
constexpr long long LO = -Z0;
constexpr long long HI = 4294967288LL - Z0;
constexpr unsigned YEAR0 = 400 * SHIFT_ERAS;
// (days + 4) mod 7 = (z + DOW_C) mod 7; (days + 3) mod 7 = (z + WKD_C) mod 7
constexpr unsigned DOW_C = static_cast<unsigned>(((4 - Z0) % 7 + 7) % 7);
constexpr unsigned WKD_C = static_cast<unsigned>(((3 - Z0) % 7 + 7) % 7);
// March-based months of 30 days: April, June, September, November
constexpr unsigned SHORT_MONTHS = (1u << 1) | (1u << 3) | (1u << 6) |
                                  (1u << 8);

__device__ __forceinline__ long long wadd(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long wsub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long wmul(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) *
                                static_cast<unsigned long long>(b));
}

// floor(a / B), B > 0 a constant
template <long long B>
__device__ __forceinline__ long long fdiv(long long a) {
  long long q = a / B;
  if (a % B < 0) --q;
  return q;
}

template <long long B>
__device__ __forceinline__ long long fmod_pos(long long a) {
  const long long r = a % B;
  return r < 0 ? r + B : r;
}

// ---- the 32-bit path --------------------------------------------------------

// a year whose residue mod 400 is r (0 <= r <= 400) is a leap year
__device__ __forceinline__ unsigned leap(unsigned r) {
  return (r & 3u) == 0 && (r % 100u != 0 || r % 400u == 0);
}

// days of March-based month mp (0 = March) of the March-based year whose
// residue mod 400 is yoe (February belongs to the next year)
__device__ __forceinline__ unsigned month_days(unsigned mp, unsigned yoe) {
  return mp == 11 ? 28u + leap(yoe + 1) : 31u - ((SHORT_MONTHS >> mp) & 1u);
}

struct C32 {
  unsigned yoe;  // the March-based year's residue mod 400
  unsigned y;    // the March-based year, shifted by YEAR0
  unsigned doy;  // March-based day of year, 0 = March 1
  unsigned mp;   // March-based month, 0 = March
  unsigned d;    // day of month, 1-based
};

__device__ __forceinline__ C32 civil32(unsigned z) {
  C32 c;
  const unsigned era = z / 146097u;
  const unsigned doe = z - era * 146097u;
  c.yoe = (doe - doe / 1460u + doe / 36524u - doe / 146096u) / 365u;
  c.y = era * 400u + c.yoe;
  c.doy = doe - (365u * c.yoe + c.yoe / 4u - c.yoe / 100u);
  c.mp = (5u * c.doy + 2u) / 153u;
  c.d = c.doy - (153u * c.mp + 2u) / 5u + 1u;
  return c;
}

__device__ __forceinline__ unsigned dayofyear32(const C32& c) {
  return c.mp >= 10 ? c.doy - 305u : c.doy + 60u + leap(c.yoe);
}

template <int PART>
__device__ __forceinline__ long long part32(long long days) {
  const unsigned z = static_cast<unsigned>(days + Z0);
  if (PART == DAYOFWEEK) return (z + DOW_C) % 7u + 1u;
  if (PART == WEEKDAY) return (z + WKD_C) % 7u;
  const C32 c = civil32(z);
  if (PART == YEAR)
    return static_cast<long long>(c.y) - YEAR0 + (c.mp >= 10 ? 1 : 0);
  if (PART == MONTH) return c.mp < 10 ? c.mp + 3u : c.mp - 9u;
  if (PART == DAY) return c.d;
  if (PART == QUARTER) return ((c.mp < 10 ? c.mp + 3u : c.mp - 9u) + 2u) / 3u;
  if (PART == LAST_DAY)
    return static_cast<int>(static_cast<unsigned>(days) - c.d +
                            month_days(c.mp, c.yoe));
  const unsigned doy0 = dayofyear32(c) - 1u;
  if (PART == DAYOFYEAR) return doy0 + 1u;
  // WEEK, mode 0: weeks start on Sunday; week 1 holds the year's first
  // Sunday, and the days before it are week 0
  const unsigned jan1_dow = ((z + DOW_C) % 7u + 371u - doy0) % 7u;
  const unsigned first_sunday = (7u - jan1_dow) % 7u;
  return doy0 < first_sunday ? 0u : (doy0 - first_sunday) / 7u + 1u;
}

// ---- the 64-bit wrapping path (the reference's arithmetic) ------------------

struct Civil {
  long long y;
  int m;
  int d;
};

__device__ __forceinline__ Civil civil_from_days(long long days) {
  const long long z = wadd(days, 719468);
  const long long era = fdiv<146097>(z);
  const int doe = static_cast<int>(wsub(z, wmul(era, 146097)));
  const int yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const int doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const int mp = (5 * doy + 2) / 153;
  Civil c;
  c.d = doy - (153 * mp + 2) / 5 + 1;
  c.m = mp < 10 ? mp + 3 : mp - 9;
  c.y = wadd(yoe, wmul(era, 400));
  if (mp >= 10) c.y = wadd(c.y, 1);
  return c;
}

// m in [1, 12]; d any int64
__device__ __forceinline__ long long days_from_civil(long long y, int m,
                                                     long long d) {
  y = wsub(y, m <= 2 ? 1 : 0);
  const long long era = fdiv<400>(y);
  const int yoe = static_cast<int>(wsub(y, wmul(era, 400)));
  const int mp = m > 2 ? m - 3 : m + 9;
  const long long doy = wadd((153 * mp + 2) / 5, wsub(d, 1));
  const long long doe =
      wadd(static_cast<long long>(yoe * 365 + yoe / 4 - yoe / 100), doy);
  return wsub(wadd(wmul(era, 146097), doe), 719468);
}

template <int PART>
__device__ __forceinline__ long long part64(long long days) {
  if (PART == DAYOFWEEK) return fmod_pos<7>(wadd(days, 4)) + 1;
  if (PART == WEEKDAY) return fmod_pos<7>(wadd(days, 3));
  const Civil c = civil_from_days(days);
  if (PART == YEAR) return c.y;
  if (PART == MONTH) return c.m;
  if (PART == DAY) return c.d;
  if (PART == QUARTER) return (c.m + 2) / 3;
  if (PART == LAST_DAY)
    return static_cast<int>(wsub(
        days_from_civil(c.m == 12 ? wadd(c.y, 1) : c.y,
                        c.m == 12 ? 1 : c.m + 1, 1), 1));
  const long long jan1 = days_from_civil(c.y, 1, 1);
  if (PART == DAYOFYEAR) return wadd(wsub(days, jan1), 1);
  const long long jan1_dow = fmod_pos<7>(wadd(jan1, 4));  // 0 = Sunday
  const long long first_sunday = wadd(jan1, fmod_pos<7>(-jan1_dow));
  return days < first_sunday ? 0 : fdiv<7>(wsub(days, first_sunday)) + 1;
}

// ---- rows to threads --------------------------------------------------------

template <int KIND>
struct In {
  using T = long long;
};
template <>
struct In<DAYS32> {
  using T = int;
};

// rows [0, head) and [head + groups * R, n) are scalar units after the
// `groups` vector units; unit u < groups is rows head + u * R .. + R - 1.
// → the unit's rows (R or 1), its first row in *r0
template <int R>
__device__ __forceinline__ int unit_rows(long long u, long long head,
                                         long long groups, long long* r0) {
  if (u < groups) {
    *r0 = head + u * R;
    return R;
  }
  const long long s = u - groups;
  *r0 = s < head ? s : s + groups * R;
  return 1;
}

template <typename T, int R>
__device__ __forceinline__ void load_unit(const T* __restrict__ v,
                                          long long r0, int cnt,
                                          long long (&x)[R]) {
  if (cnt == 1) {
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = v[r0];
  } else if constexpr (R == 4) {
    const int4 q = *reinterpret_cast<const int4*>(v + r0);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    const longlong2 q = *reinterpret_cast<const longlong2*>(v + r0);
    x[0] = q.x;
    x[1] = q.y;
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_unit(T* __restrict__ out, long long r0,
                                           int cnt, const long long (&y)[R]) {
  if (cnt == 1) {
    out[r0] = static_cast<T>(y[0]);
  } else if constexpr (sizeof(T) == 8) {
#pragma unroll
    for (int k = 0; k < R; k += 2)
      *reinterpret_cast<longlong2*>(out + r0 + k) =
          make_longlong2(y[k], y[k + 1]);
  } else if constexpr (R == 4) {
    *reinterpret_cast<int4*>(out + r0) =
        make_int4(static_cast<int>(y[0]), static_cast<int>(y[1]),
                  static_cast<int>(y[2]), static_cast<int>(y[3]));
  } else {
    *reinterpret_cast<int2*>(out + r0) =
        make_int2(static_cast<int>(y[0]), static_cast<int>(y[1]));
  }
}

template <int KIND>
__device__ __forceinline__ bool in_range(long long days) {
  if (KIND == MICROS) return true;
  if (KIND == DAYS32) return days >= LO;
  return days >= LO && days <= HI;
}

template <int KIND>
__device__ __forceinline__ long long days_of(long long raw) {
  return KIND == MICROS ? fdiv<DAY_US>(raw) : raw;
}

template <int KIND, int PART>
__global__ void __launch_bounds__(THREADS)
    civil_part_kernel(const void* __restrict__ v, void* __restrict__ out,
                      long long n, long long head, long long groups) {
  using TI = typename In<KIND>::T;
  using TO = typename std::conditional<PART == LAST_DAY, int,
                                       long long>::type;
  constexpr int R = 16 / sizeof(TI);
  const TI* vi = static_cast<const TI*>(v);
  TO* o = static_cast<TO*>(out);
  const long long units = groups + (n - groups * R);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       u < units; u += step) {
    long long r0, x[R], y[R];
    const int cnt = unit_rows<R>(u, head, groups, &r0);
    if constexpr (PART >= HOUR && KIND != MICROS) {
#pragma unroll
      for (int k = 0; k < R; ++k) y[k] = 0;
    } else if constexpr (PART >= HOUR) {
      load_unit<TI, R>(vi, r0, cnt, x);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        // the time of day is exact (the wraps cancel): [0, DAY_US)
        const long long tod = wsub(x[k], wmul(fdiv<DAY_US>(x[k]), DAY_US));
        const unsigned s = static_cast<unsigned>(
            static_cast<unsigned long long>(tod) / 1000000ULL);
        y[k] = PART == HOUR ? s / 3600u
             : PART == MINUTE ? s / 60u % 60u : s % 60u;
      }
    } else {
      load_unit<TI, R>(vi, r0, cnt, x);
      long long days[R];
      bool ok = true;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        days[k] = days_of<KIND>(x[k]);
        ok = ok && in_range<KIND>(days[k]);
      }
      if (__all_sync(__activemask(), ok)) {
#pragma unroll
        for (int k = 0; k < R; ++k) y[k] = part32<PART>(days[k]);
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) y[k] = part64<PART>(days[k]);
      }
    }
    store_unit<TO, R>(o, r0, cnt, y);
  }
}

template <int KIND, int MULT, bool PER_ROW>
__global__ void __launch_bounds__(THREADS)
    date_add_months_kernel(const void* __restrict__ v,
                           const long long* __restrict__ n_months,
                           long long n_scalar, void* __restrict__ out,
                           long long n, long long head, long long groups) {
  using TI = typename In<KIND>::T;
  using TO = typename std::conditional<KIND == MICROS, long long, int>::type;
  constexpr int R = 16 / sizeof(TI);
  const TI* vi = static_cast<const TI*>(v);
  TO* o = static_cast<TO*>(out);
  const long long units = groups + (n - groups * R);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       u < units; u += step) {
    long long r0, x[R], y[R], months[R];
    const int cnt = unit_rows<R>(u, head, groups, &r0);
    load_unit<TI, R>(vi, r0, cnt, x);
    if constexpr (PER_ROW) {
      if (cnt == R) {
#pragma unroll
        for (int k = 0; k < R; k += 2) {
          const longlong2 q =
              *reinterpret_cast<const longlong2*>(n_months + r0 + k);
          months[k] = q.x;
          months[k + 1] = q.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) months[k] = n_months[r0];
      }
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) months[k] = n_scalar;
    }
    long long days[R], idx[R];
    C32 c[R];
    bool ok = true;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      months[k] = wmul(months[k], MULT);
      days[k] = days_of<KIND>(x[k]);
      const bool in = in_range<KIND>(days[k]);
      c[k] = civil32(static_cast<unsigned>(days[k] + Z0));
      // the target month's index since (-320000)-03: the reference's
      // total months, wrapped as it wraps, minus 2 plus 12 * YEAR0
      idx[k] = wadd(12LL * c[k].y + c[k].mp, months[k]);
      ok = ok && in &&
           (static_cast<unsigned long long>(idx[k]) >> 32) == 0;
    }
    if (__all_sync(__activemask(), ok)) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const unsigned t = static_cast<unsigned>(idx[k]);
        const unsigned ty = t / 12u, tmp = t - 12u * ty;
        const unsigned dim = month_days(tmp, ty % 400u);
        const unsigned nd = c[k].d < dim ? c[k].d : dim;
        // Hinnant's days_from_civil of (ty, tmp, 1) in z-space, once
        const long long first =
            365LL * ty + (ty / 4u - ty / 100u + ty / 400u) +
            (153u * tmp + 2u) / 5u;
        y[k] = first + nd - 1 - Z0;
      }
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const Civil cv = civil_from_days(days[k]);
        const long long tot = wadd(wadd(wmul(cv.y, 12), cv.m - 1), months[k]);
        const long long ny = fdiv<12>(tot);
        const int nm = static_cast<int>(wsub(tot, wmul(ny, 12))) + 1;
        const long long nxt = days_from_civil(nm == 12 ? wadd(ny, 1) : ny,
                                              nm == 12 ? 1 : nm + 1, 1);
        const long long dim = wsub(nxt, days_from_civil(ny, nm, 1));
        const long long nd = cv.d < dim ? cv.d : dim;
        y[k] = days_from_civil(ny, nm, nd);
      }
    }
    if constexpr (KIND == MICROS) {
#pragma unroll
      for (int k = 0; k < R; ++k)
        y[k] = wadd(wmul(y[k], DAY_US), wsub(x[k], wmul(days[k], DAY_US)));
    }
    store_unit<TO, R>(o, r0, cnt, y);
  }
}

int grid_for(long long units) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& s = sms[dev & 63];
  if (s == 0) {
    cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (s <= 0) s = 132;
  }
  long long b = (units + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(s) * BLOCKS_PER_SM;
  if (b > cap) b = cap;
  return b < 1 ? 1 : static_cast<int>(b);
}

// rows before the input's first 16-byte boundary, and the whole groups of
// R rows after them; every row scalar (head = n) where the output or the
// month counts do not line up with the input
struct Split {
  long long head;
  long long groups;
};

Split split(const void* v, int in_bytes, const void* out, int out_bytes,
            const void* months, long long n) {
  const int r = 16 / in_bytes;
  const uintptr_t pv = reinterpret_cast<uintptr_t>(v);
  long long head = static_cast<long long>((16 - (pv & 15)) & 15) / in_bytes;
  if (head > n) head = n;
  const int out_align = r * out_bytes < 16 ? r * out_bytes : 16;
  const bool lined =
      pv % in_bytes == 0 &&
      (reinterpret_cast<uintptr_t>(out) + head * out_bytes) % out_align == 0 &&
      (months == nullptr ||
       (reinterpret_cast<uintptr_t>(months) + head * 8) % 16 == 0);
  if (!lined) return Split{n, 0};
  return Split{head, (n - head) / r};
}

template <int KIND, int PART>
void launch_part(const void* v, void* out, long long n, cudaStream_t st) {
  const int ib = KIND == DAYS32 ? 4 : 8, ob = PART == LAST_DAY ? 4 : 8;
  const Split s = split(v, ib, out, ob, nullptr, n);
  const long long units = s.groups + (n - s.groups * (16 / ib));
  civil_part_kernel<KIND, PART><<<grid_for(units), THREADS, 0, st>>>(
      v, out, n, s.head, s.groups);
}

template <int KIND>
void launch_part_kind(int part, const void* v, void* out, long long n,
                      cudaStream_t st) {
  switch (part) {
    case YEAR: return launch_part<KIND, YEAR>(v, out, n, st);
    case MONTH: return launch_part<KIND, MONTH>(v, out, n, st);
    case DAY: return launch_part<KIND, DAY>(v, out, n, st);
    case DAYOFYEAR: return launch_part<KIND, DAYOFYEAR>(v, out, n, st);
    case QUARTER: return launch_part<KIND, QUARTER>(v, out, n, st);
    case WEEK: return launch_part<KIND, WEEK>(v, out, n, st);
    case LAST_DAY: return launch_part<KIND, LAST_DAY>(v, out, n, st);
    case DAYOFWEEK: return launch_part<KIND, DAYOFWEEK>(v, out, n, st);
    case WEEKDAY: return launch_part<KIND, WEEKDAY>(v, out, n, st);
    case HOUR: return launch_part<KIND, HOUR>(v, out, n, st);
    case MINUTE: return launch_part<KIND, MINUTE>(v, out, n, st);
    default: return launch_part<KIND, SECOND>(v, out, n, st);
  }
}

template <int KIND, int MULT, bool PER_ROW>
void launch_add(const void* v, const void* months, long long n_scalar,
                void* out, long long n, cudaStream_t st) {
  const int ib = KIND == DAYS32 ? 4 : 8, ob = KIND == MICROS ? 8 : 4;
  const Split s = split(v, ib, out, ob, PER_ROW ? months : nullptr, n);
  const long long units = s.groups + (n - s.groups * (16 / ib));
  date_add_months_kernel<KIND, MULT, PER_ROW>
      <<<grid_for(units), THREADS, 0, st>>>(
          v, static_cast<const long long*>(months), n_scalar, out, n, s.head,
          s.groups);
}

template <int KIND, int MULT>
void launch_add_mult(bool per_row, const void* v, const void* months,
                     long long n_scalar, void* out, long long n,
                     cudaStream_t st) {
  return per_row ? launch_add<KIND, MULT, true>(v, months, n_scalar, out, n, st)
                 : launch_add<KIND, MULT, false>(v, months, n_scalar, out, n,
                                                 st);
}

template <int KIND>
void launch_add_kind(int mult, bool per_row, const void* v,
                     const void* months, long long n_scalar, void* out,
                     long long n, cudaStream_t st) {
  switch (mult) {
    case 1: return launch_add_mult<KIND, 1>(per_row, v, months, n_scalar, out,
                                            n, st);
    case 3: return launch_add_mult<KIND, 3>(per_row, v, months, n_scalar, out,
                                            n, st);
    default: return launch_add_mult<KIND, 12>(per_row, v, months, n_scalar,
                                              out, n, st);
  }
}

}  // namespace

extern "C" {

// v: n values of the input kind; out: n int64, or n int32 for part
// LAST_DAY. flags (ops/calendar.py): bits 0-1 the input kind (0 int32
// days, 1 int64 days, 2 int64 µs), bits 4-7 the part (csrc Part order).
int tt_civil_part(const void* v, void* out, long long n, int flags,
                  void* stream) {
  const int kind = flags & 3, part = (flags >> 4) & 15;
  if (n < 0 || n >= (1LL << 40) || kind > MICROS || part >= N_PARTS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launch
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == DAYS32)
    launch_part_kind<DAYS32>(part, v, out, n, st);
  else if (kind == DAYS64)
    launch_part_kind<DAYS64>(part, v, out, n, st);
  else
    launch_part_kind<MICROS>(part, v, out, n, st);
  return static_cast<int>(cudaGetLastError());
}

// n_months: n int64 month counts (flags bit 8), or none and n_scalar for
// every row; out: n int32 days for a days input, n int64 µs for a µs
// input. flags (ops/calendar.py): bits 0-1 the input kind, bits 4-7 mult
// (1, 3 or 12), bit 8 a count per row.
int tt_date_add_months(const void* v, const void* n_months,
                       long long n_scalar, void* out, long long n, int flags,
                       void* stream) {
  const int kind = flags & 3, mult = (flags >> 4) & 15;
  const bool per_row = (flags >> 8) & 1;
  if (n < 0 || n >= (1LL << 40) || kind > MICROS ||
      (mult != 1 && mult != 3 && mult != 12) ||
      (per_row && n_months == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == DAYS32)
    launch_add_kind<DAYS32>(mult, per_row, v, n_months, n_scalar, out, n, st);
  else if (kind == DAYS64)
    launch_add_kind<DAYS64>(mult, per_row, v, n_months, n_scalar, out, n, st);
  else
    launch_add_kind<MICROS>(mult, per_row, v, n_months, n_scalar, out, n, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
