// K20 civil_date — calendar parts of DATE days and DATETIME microseconds,
// and DATE_ADD by months, one row per thread, in registers.
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
//                    mult 1, 3 or 12): Hinnant's decomposition, the month
//                    add, the day clamped to the target month's length,
//                    back to days; µs inputs keep their time of day.
//                    Output int32 days, or int64 µs.
//
// Exactness: the outputs equal the reference's on every input. Its int64
// adds and multiplies wrap, so these do too (through uint64); divisions
// floor as jnp's `//` does. 32-bit arithmetic only where the range is
// proven: the day of the 400-year era lies in [0, 146096] and the year of
// the era in [0, 399], whatever the input.
//
// What bounds it on an H100: bytes (4 or 8 in and 4 or 8 out a row). The
// arithmetic is about 40 integer operations a row (a few of them 64-bit
// divisions by constants), well under the card's integer rate per byte.
//
// C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long DAY_US = 86400000000LL;

enum Kind { DAYS32 = 0, DAYS64 = 1, MICROS = 2 };
enum Part {
  YEAR = 0, MONTH, DAY, DAYOFYEAR, QUARTER, WEEK, LAST_DAY, DAYOFWEEK,
  WEEKDAY, HOUR, MINUTE, SECOND, N_PARTS
};

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

// floor(a / b) for b > 0
__device__ __forceinline__ long long fdiv(long long a, long long b) {
  long long q = a / b;
  if (a % b < 0) --q;
  return q;
}

__device__ __forceinline__ long long fmod_pos(long long a, long long b) {
  const long long r = a % b;
  return r < 0 ? r + b : r;
}

struct Civil {
  long long y;
  int m;
  int d;
};

__device__ __forceinline__ Civil civil_from_days(long long days) {
  const long long z = wadd(days, 719468);
  const long long era = fdiv(z, 146097);
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
  const long long era = fdiv(y, 400);
  const int yoe = static_cast<int>(wsub(y, wmul(era, 400)));
  const int mp = m > 2 ? m - 3 : m + 9;
  const long long doy = wadd((153 * mp + 2) / 5, wsub(d, 1));
  const long long doe =
      wadd(static_cast<long long>(yoe * 365 + yoe / 4 - yoe / 100), doy);
  return wsub(wadd(wmul(era, 146097), doe), 719468);
}

__device__ __forceinline__ long long load(const void* v, int kind,
                                          long long i) {
  return kind == DAYS32 ? static_cast<long long>(
                              static_cast<const int*>(v)[i])
                        : static_cast<const long long*>(v)[i];
}

__device__ __forceinline__ long long part_of(long long raw, int kind,
                                             int part) {
  const bool micros = kind == MICROS;
  if (part >= HOUR) {
    if (!micros) return 0;
    const long long unit = part == HOUR ? 3600000000LL
                         : part == MINUTE ? 60000000LL : 1000000LL;
    return fmod_pos(fdiv(raw, unit), part == HOUR ? 24 : 60);
  }
  const long long days = micros ? fdiv(raw, DAY_US) : raw;
  if (part == DAYOFWEEK) return fmod_pos(wadd(days, 4), 7) + 1;
  if (part == WEEKDAY) return fmod_pos(wadd(days, 3), 7);
  const Civil c = civil_from_days(days);
  switch (part) {
    case YEAR: return c.y;
    case MONTH: return c.m;
    case DAY: return c.d;
    case QUARTER: return (c.m + 2) / 3;
    case LAST_DAY:
      return wsub(days_from_civil(c.m == 12 ? wadd(c.y, 1) : c.y,
                                  c.m == 12 ? 1 : c.m + 1, 1), 1);
    default: break;
  }
  const long long jan1 = days_from_civil(c.y, 1, 1);
  if (part == DAYOFYEAR) return wadd(wsub(days, jan1), 1);
  // WEEK, mode 0: weeks start on Sunday; week 1 holds the year's first
  // Sunday, and the days before it are week 0
  const long long jan1_dow = fmod_pos(wadd(jan1, 4), 7);  // 0 = Sunday
  const long long first_sunday = wadd(jan1, fmod_pos(-jan1_dow, 7));
  return days < first_sunday ? 0 : fdiv(wsub(days, first_sunday), 7) + 1;
}

__global__ void __launch_bounds__(THREADS)
    civil_part_kernel(const void* __restrict__ v, int kind, int part,
                      void* __restrict__ out, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const long long r = part_of(load(v, kind, i), kind, part);
    if (part == LAST_DAY)
      static_cast<int*>(out)[i] = static_cast<int>(r);
    else
      static_cast<long long*>(out)[i] = r;
  }
}

__global__ void __launch_bounds__(THREADS)
    date_add_months_kernel(const void* __restrict__ v, int kind,
                           const long long* __restrict__ n_months,
                           long long n_scalar, long long mult,
                           void* __restrict__ out, long long n) {
  const bool micros = kind == MICROS;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const long long raw = load(v, kind, i);
    const long long days = micros ? fdiv(raw, DAY_US) : raw;
    const long long months = wmul(n_months ? n_months[i] : n_scalar, mult);
    const Civil c = civil_from_days(days);
    const long long tot = wadd(wadd(wmul(c.y, 12), c.m - 1), months);
    const long long ny = fdiv(tot, 12);
    const int nm = static_cast<int>(wsub(tot, wmul(ny, 12))) + 1;
    const long long nxt = days_from_civil(nm == 12 ? wadd(ny, 1) : ny,
                                          nm == 12 ? 1 : nm + 1, 1);
    const long long dim = wsub(nxt, days_from_civil(ny, nm, 1));
    const long long nd = c.d < dim ? c.d : dim;
    const long long od = days_from_civil(ny, nm, nd);
    if (micros)
      static_cast<long long*>(out)[i] =
          wadd(wmul(od, DAY_US), wsub(raw, wmul(days, DAY_US)));
    else
      static_cast<int*>(out)[i] = static_cast<int>(od);
  }
}

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  if (b > 132 * 32) b = 132 * 32;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

extern "C" {

// v: n values of `kind` (0 int32 days, 1 int64 days, 2 int64 µs);
// out: n int64, or n int32 for part LAST_DAY.
int tt_civil_part(const void* v, int kind, int part, void* out,
                  long long n, void* stream) {
  if (n < 0 || kind < DAYS32 || kind > MICROS || part < 0 ||
      part >= N_PARTS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any stale error before our launch
  if (n == 0) return 0;
  civil_part_kernel<<<grid_for(n), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(v, kind, part,
                                                           out, n);
  return static_cast<int>(cudaGetLastError());
}

// n_months: n int64 month counts, or NULL to use n_scalar for every row;
// out: n int32 days for a days input, n int64 µs for a µs input.
int tt_date_add_months(const void* v, int kind, const void* n_months,
                       long long n_scalar, long long mult, void* out,
                       long long n, void* stream) {
  if (n < 0 || kind < DAYS32 || kind > MICROS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (n == 0) return 0;
  date_add_months_kernel<<<grid_for(n), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      v, kind, static_cast<const long long*>(n_months), n_scalar, mult, out,
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
