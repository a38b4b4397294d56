// Masked histograms for Hopper (sm_90a): count the masked rows of a table by
// the bin each row's column value falls in, as int32.
//
// Replaces the XLA programs of geomesa_tpu/aggregates/stats_scan.py — the
// device reductions of the stats scan (run_stat / observe_on_device) — one
// form each:
//
//   HIST      _masked_hist (:29): idx = clip(int32((f32(col) - lo) /
//             (hi - lo) * bins), 0, bins - 1) over an int32 or f32 column;
//   GRID      _masked_grid (:36): ix = clip(int32((x + 180) * inv_x * g),
//             0, g - 1), iy the same with 90 and inv_y, cell iy * g + ix.
//             Inside its jitted program XLA turns the division by the
//             constants 360 and 180 into a multiplication by their f32
//             reciprocals; the wrapper passes those reciprocals (inv_x,
//             inv_y) as the plain version computes them;
//   BINCOUNT  _masked_bincount (:43): code c counts at c, or at c + n when
//             c < 0 (JAX's negative index), and not at all when that is
//             still outside [0, n) (its scatter drops such updates).
//
// and out[bin] += 1 for every row whose mask byte is set. The binning is
// the reference's, one round-to-nearest f32 operation at a time (the build
// passes -fmad=false), so a row on a bin edge lands where the reference
// puts it. The f32 -> int32 convert truncates toward zero and saturates,
// NaN giving 0, as XLA's does: after the clip NaN and -inf count in bin 0
// and +inf in the last. XLA on the CPU reads a subnormal f32 as a zero of
// its sign and flushes a subnormal result to one: HIST flushes its inputs
// and each step's result (ftz), so a range under 2^-126 divides by zero as
// the reference's does (GRID's sums with 180 and 90 are never subnormal).
//
// What bounds it on the card: bytes — a mask byte a row, and 4 bytes of
// column (8 in GRID) a row whose mask is set; the bins are written once. At
// a selective mask the mask is nearly all the bytes.
//
// Design:
// - Mask reads at the mask's byte rate: a warp takes 512 rows at a time,
//   each lane their 16 mask bytes in one 16-byte load (after a scalar head
//   up to the 16-byte boundary, the mask may be a view at any offset, and
//   before a scalar tail), two such groups in flight a lane. A group with
//   no set byte costs nothing more; the table's Z3 order makes most groups
//   of a box's mask all zero or all set. A lane then takes four quads of
//   consecutive rows 128 apart (their mask bytes shuffled from the lane
//   that loaded them), so a quad's column loads are 16 bytes a lane and
//   512 contiguous bytes a warp where the column is aligned with the mask
//   (else a row at a time); a quad with no set byte reads no column.
// - HIST without a division where hi > lo (finite, bins <= EDGE_MAX): the
//   reference's bin is a non-decreasing function of the f32 value (each
//   rounded step is monotone), so each CTA first finds its bins - 1 edges,
//   the least f32 value reaching each bin, by bisection over the f32 bit
//   patterns with the reference's own formula (from a bracket around the
//   value the bins' spacing gives), into shared memory. A row multiplies
//   by the reciprocal of hi - lo, whose product is the quotient's within
//   2^-21.5 (relative), so its bin g is the reference's or a neighbour;
//   one branch-free step over the edges (down when v < edge[g], up when
//   v >= edge[g + 1]) gives the reference's bin for every value, NaN and
//   +-inf included.
//   hi <= lo (or a range that is not finite, that flushes to zero, or
//   whose reciprocal is not a normal f32) keeps the reference's division a
//   row.
// - Counts: up to REG_BINS bins, each thread counts in registers (a
//   compare and an add a (row, bin)), summed over its warp at the end; up
//   to SHARED_BINS each CTA in shared memory; beyond that into the output.
//   A thread adds a run of equal bins with one atomic. The CTA's bins go
//   into the output once; the output is zero on entry (the wrapper's fill,
//   the call's second activity). Integer counts make the result exact in
//   any order.
// - The grid: as many CTAs as fit on the device at once, fewer when the
//   table is small (each thread at least two mask vectors).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_BINS = 4;               // thread-register counts
constexpr int SHARED_BINS = 12 * 1024;    // 48 KB of int32 bins a CTA
constexpr int EDGE_MAX = 4096;            // HIST bins found by their edges
constexpr int MAX_DEVICES = 64;

enum Form { HIST_I32 = 0, HIST_F32 = 1, GRID = 2, BINCOUNT = 3 };
enum Agg { AGG_REG = 0, AGG_SHARED = 1, AGG_GLOBAL = 2 };

struct Params {
  const uint32_t* a;      // the column: int32 / f32 (HIST), xf (GRID), codes
  const uint32_t* b;      // yf (GRID)
  const uint8_t* mask;    // one byte a row, 0 or 1 (torch bool)
  long long n;            // rows
  long long head;         // scalar rows before the vectors
  long long nvec;         // 16-row vectors from `head`
  long long nscalar;      // head + the tail after the vectors
  int vec;                // the columns are 16-byte aligned with the mask
  int edges;              // HIST through its edges (hi > lo)
  int narrow;             // HIST edges: a bin under 2^-100, flushed guess
  float lo, hi;           // HIST range (f32)
  float inv_r;            // HIST: 1 / (hi - lo), the first guess's factor
  float inv_x, inv_y;     // GRID reciprocals of 360 and 180 (f32)
  int bins;               // HIST bins, GRID side g, BINCOUNT vocabulary size
  int nbins;              // output bins (g * g in GRID)
  int* out;               // nbins int32, zero on entry
};

// XLA's f32 -> int32 convert (cvt.rzi.s32.f32 truncates, saturates, and
// gives 0 for NaN), then the reference's clip to [0, bins - 1]
__device__ __forceinline__ int clip_bin(float v, int bins) {
  const int i = (int)v;
  return i < 0 ? 0 : (i > bins - 1 ? bins - 1 : i);
}

// v, or a zero of its sign where v is subnormal (XLA's flush on the CPU)
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

// the reference's HIST bin of v, with its division, each step flushed
// (p.lo and p.hi are flushed by the launch)
__device__ __forceinline__ int hist_div(const Params& p, float v) {
  const float frac = ftz(__fdiv_rn(ftz(__fsub_rn(ftz(v), p.lo)),
                                   ftz(__fsub_rn(p.hi, p.lo))));
  return clip_bin(ftz(__fmul_rn(frac, (float)p.bins)), p.bins);
}

// f32 bit patterns in the order of their values (-0 just below +0)
__device__ __forceinline__ unsigned ord(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// the least non-NaN f32 value whose HIST bin is k or more (1 <= k < bins:
// +inf's bin is bins - 1, so it exists): bracketed around the value the
// bins' spacing gives (a bracket doubled until the bin is below k at its
// low end and k or more at its high end), then bisected
__device__ float hist_edge(const Params& p, int k) {
  const long long NEG = ord(__uint_as_float(0xff800000u));   // -inf
  const long long POS = ord(__uint_as_float(0x7f800000u));   // +inf
  const float guess = __fadd_rn(
      p.lo, __fmul_rn(__fsub_rn(p.hi, p.lo),
                      __fdiv_rn((float)k, (float)p.bins)));
  long long g = guess != guess ? 0 : (long long)ord(guess);
  g = g < NEG ? NEG : (g > POS ? POS : g);
  long long step = 1, lo = g, hi = g;
  while (lo > NEG && hist_div(p, unord((unsigned)lo)) >= k) {
    lo = g - step < NEG ? NEG : g - step;
    step <<= 1;
  }
  if (hist_div(p, unord((unsigned)lo)) >= k) return unord((unsigned)lo);
  step = 1;
  while (hist_div(p, unord((unsigned)hi)) < k) {   // f(+inf) >= k ends it
    hi = g + step > POS ? POS : g + step;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (hist_div(p, unord((unsigned)mid)) >= k) hi = mid; else lo = mid;
  }
  return unord((unsigned)hi);
}

// the bin of a row (set in the mask) from its column words, or -1 when the
// row counts nowhere; e: the HIST edges (e[0] = -inf)
template <int FORM>
__device__ __forceinline__ int bin_of(const Params& p, const float* e,
                                      uint32_t a, uint32_t b) {
  if (FORM == HIST_I32 || FORM == HIST_F32) {
    const float v = FORM == HIST_I32 ? __int2float_rn((int)a)
                                     : __uint_as_float(a);
    if (!p.edges) return hist_div(p, v);
    // the reciprocal's product is within 2^-21.5 (relative) of the
    // quotient's, so its bin is the reference's or a neighbour: one step
    // over the edges (e[0] = -inf, e[bins] = NaN: neither moves past the
    // ends; NaN moves nowhere) gives the reference's, with no branch.
    // Where a bin is narrower than 2^-100 (p.narrow, the same for every
    // row) the guess flushes each step as hist_div does: an unflushed
    // subnormal could land bins away from the flushed quotient's bin
    // once a bin is narrower than 2^-126; a wider bin moves under 2^-26
    // of a bin, and the guess skips the flushes
    const int g = p.narrow
        ? clip_bin(ftz(__fmul_rn(ftz(__fmul_rn(ftz(__fsub_rn(ftz(v), p.lo)),
                                              p.inv_r)),
                                 (float)p.bins)), p.bins)
        : clip_bin(__fmul_rn(__fmul_rn(__fsub_rn(v, p.lo), p.inv_r),
                             (float)p.bins), p.bins);
    return g - (v < e[g]) + (v >= e[g + 1]);
  } else if (FORM == GRID) {
    const float g = (float)p.bins;
    const float x = __uint_as_float(a);
    const float y = __uint_as_float(b);
    const int ix = clip_bin(__fmul_rn(__fmul_rn(__fadd_rn(x, 180.0f), p.inv_x),
                                      g), p.bins);
    const int iy = clip_bin(__fmul_rn(__fmul_rn(__fadd_rn(y, 90.0f), p.inv_y),
                                      g), p.bins);
    return iy * p.bins + ix;
  } else {
    int c = (int)a;
    if (c < 0) c += p.bins;
    return (c >= 0 && c < p.bins) ? c : -1;
  }
}

// The rows' walk, coalesced: a warp takes groups of 512 rows (group g from
// head + 512 g); lane l loads the 16 mask bytes from head + 512 g + 16 l in
// one 16-byte load, and in step q (0..3) takes the quad of 4 rows from
// head + 512 g + 128 q + 4 l, whose mask bytes are word l & 3 of lane
// 8 q + (l >> 2)'s vector — so the column loads of a step are 512
// contiguous bytes a warp.
// A group with no set byte costs its mask load alone; a quad past the
// vectors (the last group) is not the warp's. Every lane of the warp runs
// it; f(bin) for every set row of the warp's quads (-1: counted nowhere).
// Two groups' mask vectors are in flight a lane.
__device__ __forceinline__ unsigned quad_word(const uint4& mv, int q) {
  const int lane = threadIdx.x & 31;
  const int src = 8 * q + (lane >> 2);
  const unsigned x = __shfl_sync(FULL, mv.x, src);
  const unsigned y = __shfl_sync(FULL, mv.y, src);
  const unsigned z = __shfl_sync(FULL, mv.z, src);
  const unsigned w = __shfl_sync(FULL, mv.w, src);
  const int k = lane & 3;
  return k == 0 ? x : (k == 1 ? y : (k == 2 ? z : w));
}

__device__ __forceinline__ uint4 mask_vector(const Params& p, long long v) {
  return __ldg(reinterpret_cast<const uint4*>(p.mask + p.head + 16 * v));
}

template <int FORM>
__device__ __forceinline__ void quad_bins(const Params& p, const float* e,
                                          long long i0, unsigned w,
                                          int (&bin)[4]) {
  uint32_t av[4] = {0, 0, 0, 0}, bv[4] = {0, 0, 0, 0};
  if (p.vec) {
    const uint4 a4 = __ldg(reinterpret_cast<const uint4*>(p.a + i0));
    av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
    if (FORM == GRID) {
      const uint4 b4 = __ldg(reinterpret_cast<const uint4*>(p.b + i0));
      bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int v = -1;
    if ((w >> (8 * r)) & 0xffu) {
      uint32_t a = av[r], b = bv[r];
      if (!p.vec) {
        a = __ldg(p.a + i0 + r);
        if (FORM == GRID) b = __ldg(p.b + i0 + r);
      }
      v = bin_of<FORM>(p, e, a, b);
    }
    bin[r] = v;
  }
}

template <int FORM, class F>
__device__ __forceinline__ void each_set_row(const Params& p, const float* e,
                                             F&& f) {
  const int lane = threadIdx.x & 31;
  const long long wid = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long nw = ((long long)gridDim.x * THREADS) >> 5;
  const long long ngroups = (p.nvec + 31) >> 5;
  auto group = [&](long long g, const uint4& mv) {
    if (!__any_sync(FULL, (mv.x | mv.y | mv.z | mv.w) != 0)) return;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned w = quad_word(mv, q);
      if (!w || 32 * g + 8 * q + (lane >> 2) >= p.nvec) continue;
      int bin[4];
      quad_bins<FORM>(p, e, p.head + 512 * g + 128 * q + 4 * lane, w, bin);
      f(bin[0]);
      f(bin[1]);
      f(bin[2]);
      f(bin[3]);
    }
  };
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (long long g0 = wid; g0 < ngroups; g0 += 2 * nw) {
    const long long g1 = g0 + nw;
    const long long v0 = 32 * g0 + lane, v1 = 32 * g1 + lane;
    const uint4 m0 = v0 < p.nvec ? mask_vector(p, v0) : z;
    const uint4 m1 = v1 < p.nvec ? mask_vector(p, v1) : z;
    group(g0, m0);
    if (g1 < ngroups) group(g1, m1);
  }
}

// scalar row t (< nscalar): the head, then the tail
__device__ __forceinline__ long long scalar_row(const Params& p,
                                                long long t) {
  return t < p.head ? t : p.head + 16 * p.nvec + (t - p.head);
}

template <int FORM>
__device__ __forceinline__ int scalar_bin(const Params& p, const float* e,
                                          long long i) {
  if (!p.mask[i]) return -1;
  return bin_of<FORM>(p, e, __ldg(p.a + i),
                      FORM == GRID ? __ldg(p.b + i) : 0u);
}

// a thread's run of equal bins, added with one atomic when it ends
struct Runs {
  int bin = -1;
  int cnt = 0;
  __device__ __forceinline__ void add(int* h, int b) {
    if (b < 0) return;
    if (b == bin) {
      ++cnt;
      return;
    }
    if (cnt) atomicAdd(&h[bin], cnt);
    bin = b;
    cnt = 1;
  }
  __device__ __forceinline__ void flush(int* h) {
    if (cnt) atomicAdd(&h[bin], cnt);
    cnt = 0;
    bin = -1;
  }
};

template <int FORM, int AGG>
__global__ void __launch_bounds__(THREADS) masked_hist_kernel(
    const __grid_constant__ Params p) {
  constexpr bool HIST = FORM == HIST_I32 || FORM == HIST_F32;
  extern __shared__ __align__(16) int sh[];
  // AGG_REG / AGG_SHARED: the CTA's bins; HIST with edges: the edges after
  const int held = AGG == AGG_GLOBAL ? 0 : p.nbins;
  float* e = reinterpret_cast<float*>(sh + held);
  for (int k = threadIdx.x; k < held; k += THREADS) sh[k] = 0;
  if (HIST && p.edges) {
    if (threadIdx.x == 0) {
      e[0] = __uint_as_float(0xff800000u);      // -inf
      e[p.bins] = __uint_as_float(0x7fffffffu); // NaN: no bin above the last
    }
    for (int k = 1 + threadIdx.x; k < p.bins; k += THREADS)
      e[k] = hist_edge(p, k);
  }
  __syncthreads();
  int* dst = AGG == AGG_GLOBAL ? p.out : sh;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (AGG == AGG_REG) {
    // a thread's counts in registers, summed over the warp at the end
    unsigned c[REG_BINS] = {};
    each_set_row<FORM>(p, e, [&](int b) {
#pragma unroll
      for (int k = 0; k < REG_BINS; ++k) c[k] += b == k;
    });
    if (t < p.nscalar) {
      const int b = scalar_bin<FORM>(p, e, scalar_row(p, t));
#pragma unroll
      for (int k = 0; k < REG_BINS; ++k) c[k] += b == k;
    }
#pragma unroll
    for (int k = 0; k < REG_BINS; ++k) {
      unsigned v = c[k];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
      if ((threadIdx.x & 31) == 0 && v) atomicAdd(&sh[k], (int)v);
    }
  } else {
    Runs r;
    each_set_row<FORM>(p, e, [&](int b) { r.add(dst, b); });
    if (t < p.nscalar) r.add(dst, scalar_bin<FORM>(p, e, scalar_row(p, t)));
    r.flush(dst);
  }
  if (AGG != AGG_GLOBAL) {
    __syncthreads();
    for (int k = threadIdx.x; k < p.nbins; k += THREADS) {
      const int v = sh[k];
      if (v) atomicAdd(&p.out[k], v);
    }
  }
}

// CTAs as many as fit on the device at once with `smem` bytes of shared
// memory (asked once a device, kernel and 4 KB step of shared memory)
template <int FORM, int AGG>
cudaError_t resident(int dev, size_t smem, int* out) {
  constexpr int STEPS = (SHARED_BINS * 4 + EDGE_MAX * 4) / 4096 + 1;
  static std::mutex mu;
  static int known[MAX_DEVICES][STEPS];
  const int step = (int)((smem + 4095) / 4096);
  std::lock_guard<std::mutex> hold(mu);
  if (!known[dev][step]) {
    int sms = 0, per = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, masked_hist_kernel<FORM, AGG>, THREADS,
             (size_t)step * 4096)) != cudaSuccess)
      return err;
    known[dev][step] = sms * (per > 0 ? per : 1);
  }
  *out = known[dev][step];
  return cudaSuccess;
}

template <int FORM, int AGG>
cudaError_t launch(const Params& p, int dev, size_t smem, cudaStream_t st) {
  int grid = 0;
  cudaError_t err = resident<FORM, AGG>(dev, smem, &grid);
  if (err != cudaSuccess) return err;
  // every thread at least two mask vectors
  const long long want = (p.nvec + 2LL * THREADS - 1) / (2LL * THREADS);
  if (want < grid) grid = want < 1 ? 1 : (int)want;
  masked_hist_kernel<FORM, AGG><<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_form(const Params& p, int dev, cudaStream_t st) {
  const bool HIST = FORM == HIST_I32 || FORM == HIST_F32;
  const size_t edges =
      HIST && p.edges ? sizeof(float) * ((size_t)p.bins + 1) : 0;
  if (p.nbins <= REG_BINS)
    return launch<FORM, AGG_REG>(p, dev, sizeof(int) * p.nbins + edges, st);
  if (p.nbins <= SHARED_BINS)
    return launch<FORM, AGG_SHARED>(p, dev, sizeof(int) * p.nbins + edges,
                                    st);
  return launch<FORM, AGG_GLOBAL>(p, dev, edges, st);
}

}  // namespace

// Adds into `out` (nbins int32, zero on entry) the count of the n > 0 rows
// whose mask byte is set, by bin: form 0/1 HIST over an int32/f32 column a
// with (lo, hi, bins); 2 GRID over xf = a, yf = b with side bins and the
// reciprocals inv_x, inv_y (nbins = bins * bins); 3 BINCOUNT over int32
// codes a with a vocabulary of bins. One launch on `stream` of device
// `device` (the current device); returns the first CUDA error.
extern "C" int masked_hist_launch(int form, const void* a, const float* b,
                                  const uint8_t* mask, long long n, float lo,
                                  float hi, float inv_x, float inv_y,
                                  int bins, int nbins, int* out, int device,
                                  void* stream) {
  if (n <= 0 || nbins <= 0 || device < 0 || device >= MAX_DEVICES ||
      ((uintptr_t)a & 3) || ((uintptr_t)b & 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  p.a = static_cast<const uint32_t*>(a);
  p.b = reinterpret_cast<const uint32_t*>(b);
  p.mask = mask;
  p.n = n;
  long long head = (long long)((16u - ((uintptr_t)mask & 15u)) & 15u);
  if (head > n) head = n;
  p.head = head;
  p.nvec = (n - head) / 16;
  p.nscalar = head + (n - head - 16 * p.nvec);
  p.vec = (((uintptr_t)(p.a + head) & 15) == 0) &&
          (form != GRID || (((uintptr_t)(p.b + head) & 15) == 0));
  // the reference reads a subnormal bound as a zero of its sign
  lo = fabsf(lo) < FLT_MIN ? copysignf(0.0f, lo) : lo;
  hi = fabsf(hi) < FLT_MIN ? copysignf(0.0f, hi) : hi;
  p.lo = lo;
  p.hi = hi;
  float r = hi - lo;
  r = fabsf(r) < FLT_MIN ? copysignf(0.0f, r) : r;
  const bool finite = lo - lo == 0.0f && hi - hi == 0.0f && r - r == 0.0f;
  // the guess is within a bin of the reference's only where 1 / (hi - lo)
  // is a normal f32: a range under 2^-126 flushes to zero, one over about
  // 8.5e37 makes it subnormal; those ranges keep the division
  const double inv_r = 1.0 / (double)r;
  p.edges = (form == HIST_I32 || form == HIST_F32) && hi > lo && r > 0.0f &&
            finite && inv_r >= FLT_MIN && inv_r <= FLT_MAX &&
            bins <= EDGE_MAX;
  p.inv_r = p.edges ? (float)inv_r : 0.0f;
  p.narrow = p.edges && (double)r / bins < std::ldexp(1.0, -100);
  p.inv_x = inv_x;
  p.inv_y = inv_y;
  p.bins = bins;
  p.nbins = nbins;
  p.out = out;
  switch (form) {
    case HIST_I32: return (int)launch_form<HIST_I32>(p, device, st);
    case HIST_F32: return (int)launch_form<HIST_F32>(p, device, st);
    case GRID: return (int)launch_form<GRID>(p, device, st);
    case BINCOUNT: return (int)launch_form<BINCOUNT>(p, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* masked_hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
