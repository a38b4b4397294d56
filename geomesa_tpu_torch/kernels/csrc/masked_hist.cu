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
// and out[bin] += 1 for every row whose mask byte is set. The arithmetic is
// the reference's, one round-to-nearest f32 operation at a time (__fsub_rn,
// an IEEE __fdiv_rn, __fmul_rn; the build passes -fmad=false), so a row on
// a bin edge lands where the reference puts it. The f32 -> int32 convert
// truncates toward zero and saturates, NaN giving 0, as XLA's does: after the
// clip NaN and -inf count in bin 0 and +inf in the last.
//
// What bounds it on the card: per row one mask byte, and 4 bytes of column
// (8 in GRID) per row whose mask is set, are read; the bins are written once. A few f32 operations a row
// put it far below the operation bound, so it is bound by bytes (at the
// H100's 3.35 TB/s) — and, where many rows share a bin (a 20-bin histogram
// of a clustered column), by the serialization of atomic adds to one bin.
//
// Design (simple and right first):
// - A warp takes 128 consecutive rows at a time, each lane 4 rows 32 apart
//   (every load coalesced, four loads in flight a lane); the column is read
//   only where the mask byte is set. The warps stride over the table.
// - The lanes that hit one bin are found by __match_any_sync and their
//   leader adds the group's size with one atomic.
// - Shared route (the bins fit a CTA's shared memory, 48 KB): each CTA
//   counts into its own copy in shared memory and adds its nonzero bins into
//   the int32 output once. Global route (a large vocabulary): the atomics go
//   to the output directly. The output is zero on entry (the wrapper's).
// - Integer counts make the result exact whatever the order of the adds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                 // rows a lane takes a round
constexpr unsigned FULL = 0xffffffffu;
constexpr int SHARED_BINS = 12 * 1024;    // 48 KB of int32 bins a CTA

enum Form { HIST_I32 = 0, HIST_F32 = 1, GRID = 2, BINCOUNT = 3 };

struct Params {
  const void* a;          // the column: int32 / f32 (HIST), xf (GRID), codes
  const float* b;         // yf (GRID)
  const uint8_t* mask;    // one byte a row, 0 or 1 (torch bool)
  long long n;            // rows
  float lo, hi;           // HIST range (f32)
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

// the bin of row i (set in the mask), or -1 when the row counts nowhere
template <int FORM>
__device__ __forceinline__ int bin_of(const Params& p, long long i) {
  if (FORM == HIST_I32 || FORM == HIST_F32) {
    const float v = FORM == HIST_I32
        ? __int2float_rn(static_cast<const int*>(p.a)[i])
        : static_cast<const float*>(p.a)[i];
    const float frac = __fdiv_rn(__fsub_rn(v, p.lo), __fsub_rn(p.hi, p.lo));
    return clip_bin(__fmul_rn(frac, (float)p.bins), p.bins);
  } else if (FORM == GRID) {
    const float g = (float)p.bins;
    const float x = static_cast<const float*>(p.a)[i];
    const float y = p.b[i];
    const int ix = clip_bin(__fmul_rn(__fmul_rn(__fadd_rn(x, 180.0f), p.inv_x),
                                      g), p.bins);
    const int iy = clip_bin(__fmul_rn(__fmul_rn(__fadd_rn(y, 90.0f), p.inv_y),
                                      g), p.bins);
    return iy * p.bins + ix;
  } else {
    int c = static_cast<const int*>(p.a)[i];
    if (c < 0) c += p.bins;
    return (c >= 0 && c < p.bins) ? c : -1;
  }
}

template <int FORM, bool SHARED>
__global__ void __launch_bounds__(THREADS) masked_hist_kernel(Params p) {
  extern __shared__ int sh[];
  if (SHARED) {
    for (int k = threadIdx.x; k < p.nbins; k += THREADS) sh[k] = 0;
    __syncthreads();
  }
  int* dst = SHARED ? sh : p.out;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int SPAN = 32 * UNROLL;                  // rows a warp's round
  const long long stride = (long long)gridDim.x * (THREADS / 32) * SPAN;
  // every lane of a warp runs the same rounds (the match needs them all)
  for (long long base = ((long long)blockIdx.x * (THREADS / 32) + warp) * SPAN;
       base < p.n; base += stride) {
    uint8_t m[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * 32 + lane;
      m[u] = i < p.n ? p.mask[i] : 0;
    }
    int b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      b[u] = m[u] ? bin_of<FORM>(p, base + u * 32 + lane) : -1;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!__any_sync(FULL, b[u] >= 0)) continue;
      const unsigned peers = __match_any_sync(FULL, b[u]);
      if (b[u] >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&dst[b[u]], __popc(peers));
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int k = threadIdx.x; k < p.nbins; k += THREADS) {
      const int v = sh[k];
      if (v) atomicAdd(&p.out[k], v);
    }
  }
}

template <int FORM>
cudaError_t launch(const Params& p, int sms, cudaStream_t st) {
  const long long rounds = (p.n + 32 * UNROLL - 1) / (32 * UNROLL);
  const long long warps_needed = rounds < 1 ? 1 : rounds;
  long long blocks = (warps_needed + THREADS / 32 - 1) / (THREADS / 32);
  const long long cap = (long long)sms * 8;
  if (blocks > cap) blocks = cap;
  if (p.nbins <= SHARED_BINS) {
    const size_t smem = sizeof(int) * (size_t)p.nbins;
    masked_hist_kernel<FORM, true><<<(int)blocks, THREADS, smem, st>>>(p);
  } else {
    masked_hist_kernel<FORM, false><<<(int)blocks, THREADS, 0, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Adds into `out` (nbins int32, zero on entry) the count of the n > 0 rows
// whose mask byte is set, by bin: form 0/1 HIST over an int32/f32 column a
// with (lo, hi, bins); 2 GRID over xf = a, yf = b with side bins and the
// reciprocals inv_x, inv_y (nbins = bins * bins); 3 BINCOUNT over int32
// codes a with a vocabulary of bins. One launch; returns the first CUDA
// error.
extern "C" int masked_hist_launch(int form, const void* a, const float* b,
                                  const uint8_t* mask, long long n, float lo,
                                  float hi, float inv_x, float inv_y,
                                  int bins, int nbins, int* out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.a = a;
  p.b = b;
  p.mask = mask;
  p.n = n;
  p.lo = lo;
  p.hi = hi;
  p.inv_x = inv_x;
  p.inv_y = inv_y;
  p.bins = bins;
  p.nbins = nbins;
  p.out = out;
  switch (form) {
    case HIST_I32: return (int)launch<HIST_I32>(p, sms, st);
    case HIST_F32: return (int)launch<HIST_F32>(p, sms, st);
    case GRID: return (int)launch<GRID>(p, sms, st);
    case BINCOUNT: return (int)launch<BINCOUNT>(p, sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* masked_hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
