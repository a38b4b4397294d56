// Native one-pass index-key encoder: the build's host hot loop.
//
// A copy of the reference's geomesa_tpu/native/encode.cpp, function for
// function, so that the port builds it itself (the reference's loader is
// reached only through a package that imports JAX).
//
// It runs the per-feature key assembly of Z3IndexKeySpace.toIndexKey
// (BinnedTime split, SFC interleave, key planes) as one fused pass over
// columnar arrays, producing every device plane the port's table needs, so
// the host touches the data once:
//
//   x, y (f64), dtg (i64 ms)  ->  fp62 hi/lo planes (exact device predicates),
//                                 (bin, off) exact binned time,
//                                 z3 Morton key (+ its two u32 sort planes)
//
// Semantics are bit-identical to the numpy paths
// (geomesa_tpu_torch/index/device.py fp62, curves/normalize.py,
// curves/binnedtime.py, curves/zorder.py): the same IEEE-754 double
// operations in the same order. Parity is pinned by
// tests/test_torch_native.py.
//
// Built with g++ -O3 -shared -fPIC -std=c++17 -pthread (no external
// dependency; geomesa_tpu_torch/native/__init__.py) and bound with ctypes.
// Threaded with std::thread over up to 16 threads.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kFp62Max = (int64_t(1) << 62) - 1;

// fp62: mirrors device.py fp62() — frac = clip((x-lo)/(hi-lo), 0, 1);
// v = min(floor(ldexp(frac, 62)), 2^62-1); planes (v>>31, v&(2^31-1)).
// Branchless (min/max/ternaries lower to vector blends under -O3); the
// ldexp is an exact power-of-two scale, so a multiply matches it bitwise,
// and frac >= 0 makes int64 truncation identical to floor.
static inline int64_t fp62(double x, double lo, double hi) {
  double frac = (x - lo) / (hi - lo);
  frac = std::min(std::max(frac, 0.0), 1.0);
  int64_t v = (int64_t)(frac * 4611686018427387904.0);  // 2^62
  return std::min(v, kFp62Max);
}

// BitNormalizedDimension.normalize (normalize.py:39-43) with the lenient
// clamp applied first (sfc _check): floor((x - min) * bins/(max-min)),
// x >= max -> max_index. Post-clamp (x - mn) >= 0, so truncation == floor.
static inline int64_t norm_bits(double x, double mn, double mx,
                                double normalizer, int64_t max_index) {
  x = std::max(x, mn);
  int64_t r = (int64_t)((x - mn) * normalizer);
  return x >= mx ? max_index : r;
}

// Morton spreads — same magic masks as curves/zorder.py.
static inline uint64_t spread3(uint64_t x) {
  x &= 0x00000000001FFFFFULL;
  x = (x | (x << 32)) & 0x001F00000000FFFFULL;
  x = (x | (x << 16)) & 0x001F0000FF0000FFULL;
  x = (x | (x << 8)) & 0x100F00F00F00F00FULL;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ULL;
  x = (x | (x << 2)) & 0x1249249249249249ULL;
  return x;
}

static inline uint64_t spread2(uint64_t x) {
  x &= 0x00000000FFFFFFFFULL;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFULL;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFULL;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0FULL;
  x = (x | (x << 2)) & 0x3333333333333333ULL;
  x = (x | (x << 1)) & 0x5555555555555555ULL;
  return x;
}

static inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  q -= (int64_t)((a % b != 0) & ((a < 0) != (b < 0)));
  return q;
}

template <typename F>
void parallel_for(int64_t n, int nthreads, F&& body) {
  if (nthreads <= 1 || n < (1 << 18)) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=, &body] { body(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// period: 0 = day (offset ms), 1 = week (offset seconds). Calendar periods
// (month/year) stay on the numpy path.
//
// Outputs (all length n, caller-allocated):
//   xi/xl/yi/yl : int32 fp62 planes        bin : int16   off : int32
//   xf/yf       : float32 raw coords (aggregation columns)
//   zhi/zlo     : uint32 z3-key sort planes (z >> 31, z & 0x7FFFFFFF)
//   z           : int64 full z3 key (host range pruning)
void gm_z3_encode(const double* x, const double* y, const int64_t* ms,
                  int64_t n, int32_t period, int32_t* xi, int32_t* xl,
                  int32_t* yi, int32_t* yl, float* xf, float* yf,
                  int16_t* bin, int32_t* off,
                  uint32_t* zhi, uint32_t* zlo, int64_t* z, int32_t nthreads) {
  const int64_t period_ms = period == 0 ? 86400000LL : 604800000LL;
  const int64_t off_div = period == 0 ? 1 : 1000;
  const double max_off = period == 0 ? 86400000.0 : 604800.0;
  const double norm_lon = 2097152.0 / 360.0;   // 2^21 / (max-min)
  const double norm_lat = 2097152.0 / 180.0;
  const double norm_t = 2097152.0 / max_off;
  const int64_t max_idx = (1 << 21) - 1;

  parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      // lenient clamp (sfc _check) — fp62 clips internally already
      double px = std::min(std::max(x[i], -180.0), 180.0);
      double py = std::min(std::max(y[i], -90.0), 90.0);
      int64_t vx = fp62(px, -180.0, 180.0);
      int64_t vy = fp62(py, -90.0, 90.0);
      xi[i] = (int32_t)(vx >> 31);
      xl[i] = (int32_t)(vx & 0x7FFFFFFF);
      yi[i] = (int32_t)(vy >> 31);
      yl[i] = (int32_t)(vy & 0x7FFFFFFF);
      xf[i] = (float)x[i];
      yf[i] = (float)y[i];

      int64_t b = floordiv(ms[i], period_ms);
      int64_t o = (ms[i] - b * period_ms) / off_div;
      bin[i] = (int16_t)b;
      off[i] = (int32_t)o;

      // Z3Index._sort_keys: t = min(off, time.max), then Z3SFC.index
      double t = (double)o;
      if (t > max_off) t = max_off;
      uint64_t nx = (uint64_t)norm_bits(px, -180.0, 180.0, norm_lon, max_idx);
      uint64_t ny = (uint64_t)norm_bits(py, -90.0, 90.0, norm_lat, max_idx);
      uint64_t nt = (uint64_t)norm_bits(t, 0.0, max_off, norm_t, max_idx);
      uint64_t zz = spread3(nx) | (spread3(ny) << 1) | (spread3(nt) << 2);
      z[i] = (int64_t)zz;
      zhi[i] = (uint32_t)(zz >> 31);
      zlo[i] = (uint32_t)(zz & 0x7FFFFFFF);
    }
  });
}

// Z2 variant: 31-bit normalization, 62-bit Morton key.
void gm_z2_encode(const double* x, const double* y, int64_t n, int32_t* xi,
                  int32_t* xl, int32_t* yi, int32_t* yl, float* xf, float* yf,
                  uint32_t* zhi, uint32_t* zlo, int64_t* z, int32_t nthreads) {
  const double norm_lon = 2147483648.0 / 360.0;  // 2^31 / (max-min)
  const double norm_lat = 2147483648.0 / 180.0;
  const int64_t max_idx = (int64_t(1) << 31) - 1;

  parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double px = std::min(std::max(x[i], -180.0), 180.0);
      double py = std::min(std::max(y[i], -90.0), 90.0);
      int64_t vx = fp62(px, -180.0, 180.0);
      int64_t vy = fp62(py, -90.0, 90.0);
      xi[i] = (int32_t)(vx >> 31);
      xl[i] = (int32_t)(vx & 0x7FFFFFFF);
      yi[i] = (int32_t)(vy >> 31);
      yl[i] = (int32_t)(vy & 0x7FFFFFFF);
      xf[i] = (float)x[i];
      yf[i] = (float)y[i];

      uint64_t nx = (uint64_t)norm_bits(px, -180.0, 180.0, norm_lon, max_idx);
      uint64_t ny = (uint64_t)norm_bits(py, -90.0, 90.0, norm_lat, max_idx);
      uint64_t zz = spread2(nx) | (spread2(ny) << 1);
      z[i] = (int64_t)zz;
      zhi[i] = (uint32_t)(zz >> 31);
      zlo[i] = (uint32_t)(zz & 0x7FFFFFFF);
    }
  });
}

// fp62 planes only (extent envelope planes, standalone column encodes).
void gm_fp62(const double* x, int64_t n, double lo, double hi, int32_t* phi,
             int32_t* plo, int32_t nthreads) {
  parallel_for(n, nthreads, [&](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; ++i) {
      int64_t v = fp62(x[i], lo, hi);
      phi[i] = (int32_t)(v >> 31);
      plo[i] = (int32_t)(v & 0x7FFFFFFF);
    }
  });
}

// Morton range cover (the query-planning hot loop).
//
// ≙ sfcurve Z2.zranges / Z3.zranges as used by Z3IndexKeySpace.getRanges
// (Z3IndexKeySpace.scala:162-189): it sits on the cold-query path, so the
// Python BFS moves here. Semantics mirror curves/ranges.py _zranges exactly
// (parity pinned by tests/test_torch_native.py): level-synchronous BFS over
// the quad/octree, contained cells emit tight ranges, the budget/depth stop
// flushes the live frontier as coarse ranges, then sort + adjacent-merge.
//
// blo/bhi: (n_boxes, dims) row-major inclusive int bounds. Returns the
// merged range count written to out_lo/out_hi/out_cont, or -1 if it would
// exceed cap (the caller then runs the numpy path).
int64_t gm_zranges(const int64_t* blo, const int64_t* bhi, int64_t n_boxes,
                   int32_t dims, int32_t bits, int64_t max_ranges,
                   int32_t max_levels, int64_t* out_lo, int64_t* out_hi,
                   uint8_t* out_cont, int64_t cap) {
  if (n_boxes == 0) return 0;
  struct ZRange { int64_t lo, hi; uint8_t cont; };
  struct Cell { int64_t c[3]; };
  const int fan = 1 << dims;
  if (max_levels > bits) max_levels = bits;

  std::vector<Cell> cells(1, Cell{{0, 0, 0}});
  std::vector<Cell> live, next;
  std::vector<ZRange> out;
  out.reserve((size_t)std::min<int64_t>(max_ranges + fan, 1 << 20));

  auto emit = [&](const Cell& c, int shift, bool cont) {
    uint64_t z;
    if (dims == 2) {
      z = spread2((uint64_t)(c.c[0] << shift))
          | (spread2((uint64_t)(c.c[1] << shift)) << 1);
    } else {
      z = spread3((uint64_t)(c.c[0] << shift))
          | (spread3((uint64_t)(c.c[1] << shift)) << 1)
          | (spread3((uint64_t)(c.c[2] << shift)) << 2);
    }
    uint64_t span = (shift ? (((uint64_t)1 << (dims * shift)) - 1) : 0);
    out.push_back(ZRange{(int64_t)z, (int64_t)(z + span), (uint8_t)cont});
  };

  int level = 0;
  int64_t emitted = 0;
  while (!cells.empty()) {
    const int shift = bits - level;
    live.clear();
    for (const Cell& c : cells) {
      bool inside = false, touches = false;
      for (int64_t b = 0; b < n_boxes; ++b) {
        bool ins = true, tch = true;
        for (int d = 0; d < dims; ++d) {
          const int64_t clo = c.c[d] << shift;
          const int64_t chi = ((c.c[d] + 1) << shift) - 1;
          const int64_t lo = blo[b * dims + d], hi = bhi[b * dims + d];
          ins &= (lo <= clo) & (chi <= hi);
          tch &= (chi >= lo) & (clo <= hi);
        }
        touches |= tch;
        if (ins) { inside = true; break; }
      }
      if (inside) { emit(c, shift, true); ++emitted; }
      else if (touches) live.push_back(c);
    }
    if (live.empty()) break;
    if (level >= max_levels
        || emitted + (int64_t)live.size() * fan > max_ranges) {
      for (const Cell& c : live) emit(c, shift, false);
      break;
    }
    next.clear();
    next.reserve(live.size() * fan);
    for (const Cell& c : live) {
      for (int ch = 0; ch < fan; ++ch) {
        Cell nc{{0, 0, 0}};
        for (int d = 0; d < dims; ++d)
          nc.c[d] = (c.c[d] << 1) | ((ch >> d) & 1);
        next.push_back(nc);
      }
    }
    cells.swap(next);
    ++level;
  }

  std::sort(out.begin(), out.end(), [](const ZRange& a, const ZRange& b) {
    return a.lo < b.lo || (a.lo == b.lo && a.hi < b.hi);
  });
  int64_t m = 0;
  for (const ZRange& r : out) {
    // hi can be INT64_MAX (root emit): guard the +1 against overflow
    if (m && (out_hi[m - 1] == INT64_MAX || r.lo <= out_hi[m - 1] + 1)) {
      if (r.hi > out_hi[m - 1]) out_hi[m - 1] = r.hi;
      out_cont[m - 1] = out_cont[m - 1] && r.cont;
    } else {
      if (m == cap) return -1;
      out_lo[m] = r.lo;
      out_hi[m] = r.hi;
      out_cont[m] = r.cont;
      ++m;
    }
  }
  return m;
}

}  // extern "C"
