// Masked density scatter for Hopper (sm_90a): snap each live candidate onto
// an (H, W) raster over a bbox and add its weight (or one) to its cell.
//
// Replaces the XLA program of geomesa_tpu/index/scan.py:_grid_scatter (the
// reference's density scatter, called by ScanKernels' density_compact and
// density_blocks modes, the fused program's density mode and
// aggregates/density.py:density_kernel). For candidate i with mask bit m[i]:
//
//     fx = (x - xmin) / (xmax - xmin),  fy = (y - ymin) / (ymax - ymin)
//     counts when m[i] and 0 <= fx < 1 and 0 <= fy < 1, in cell
//     (clip(int(fy * H), 0, H-1), clip(int(fx * W), 0, W-1))
//
// and count = the number of candidates with m[i] set (inside the bbox or
// not: the reference's jnp.sum(m)). Candidate i reads row
// starts[i / bsz] + i % bsz of the x/y (and weight) planes (the pruned
// branch's gathered blocks, the last one clamped), or row i without starts.
//
// What bounds it on the card: per candidate it reads 1 mask byte; per live
// candidate 8 bytes of coordinates (12 with a weight); the raster is written
// once. A handful of f32 operations a row puts it far below the operation
// bound, so it is bound by bytes (at the H100's 3.35 TB/s) — and, where many
// rows land in few cells, by the serialization of atomic updates to a cell.
//
// Design:
// - Each thread takes chunks of 16 consecutive candidates and reads their
//   mask bytes with one 16-byte load (bytewise where the mask is not 16-byte
//   aligned or at the ragged tail); a chunk with no live byte costs that one
//   read. Only live candidates read coordinates, through the block starts.
// - Unit weights count in uint32 cells and convert to f32 at the end,
//   clamped at 2^24: the reference adds f32 ones one at a time, and such a
//   sum stops at 2^24 = 16,777,216, so the clamp gives its grid byte for
//   byte at every count, while f32 partial sums of several CTAs added past
//   2^24 would round differently.
// - Weighted grids add f32 weights (int32 weights convert with round to
//   nearest, as astype(float32) does); the order of the additions is the
//   atomics' order, so a cell agrees with the reference's sequential sum to
//   within the summation error bound, not bit for bit.
// - Shared route (the raster fits the CTA's shared memory; the wrapper
//   decides from H*W): each CTA keeps a private raster in shared memory and
//   flushes its nonzero cells with one global atomic each. Global route
//   (e.g. the reference's default 256x256 = 256 KiB, past the 227 KB a CTA
//   can hold): atomics go straight to the device raster.
//
// Snap parity: every step is one round-to-nearest f32 operation in the
// reference's order (__fsub_rn, an IEEE __fdiv_rn, __fmul_rn by W as an f32)
// and the build passes -fmad=false; fast math or a reciprocal would move
// rows that lie on cell edges.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16;                 // candidates a thread reads at once
constexpr unsigned UNIT_CLAMP = 1u << 24;  // where f32 sums of ones stop

enum WeightKind { W_NONE = 0, W_I32 = 1, W_F32 = 2 };

struct Params {
  const float* xf;
  const float* yf;
  const void* weight;
  const uint8_t* mask;
  const long long* starts;
  long long bsz;
  long long n;
  const float* bbox;  // [xmin, ymin, xmax, ymax] f32, on the device
  int width;
  int height;
  float* grid;        // (H, W) f32: weighted sums (weighted kinds)
  unsigned* counts;   // (H, W) uint32: unit counts (W_NONE)
  int* count;         // live candidates
  int vec;            // mask 16-byte aligned
};

template <int WK>
__device__ __forceinline__ void add_cell(void* hist, int cell,
                                         const Params& p, long long row) {
  if (WK == W_NONE) {
    atomicAdd(static_cast<unsigned*>(hist) + cell, 1u);
  } else {
    float w = WK == W_I32
        ? __int2float_rn(static_cast<const int*>(p.weight)[row])
        : static_cast<const float*>(p.weight)[row];
    atomicAdd(static_cast<float*>(hist) + cell, w);
  }
}

template <bool SHARED, int WK, bool STARTS>
__global__ void __launch_bounds__(THREADS)
grid_scatter_kernel(const Params p) {
  extern __shared__ unsigned char smem[];
  const int cells = p.width * p.height;
  void* hist;
  if (SHARED) {
    unsigned* s = reinterpret_cast<unsigned*>(smem);
    for (int c = threadIdx.x; c < cells; c += THREADS) s[c] = 0u;
    __syncthreads();
    hist = smem;
  } else {
    hist = WK == W_NONE ? static_cast<void*>(p.counts)
                        : static_cast<void*>(p.grid);
  }
  const float xmin = p.bbox[0], ymin = p.bbox[1];
  const float dx = __fsub_rn(p.bbox[2], xmin);
  const float dy = __fsub_rn(p.bbox[3], ymin);
  const float fw = (float)p.width, fh = (float)p.height;

  int live_total = 0;
  const long long nchunks = (p.n + CHUNK - 1) / CHUNK;
  for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
       c < nchunks; c += (long long)gridDim.x * THREADS) {
    const long long i0 = c * CHUNK;
    const int kmax = p.n - i0 < CHUNK ? (int)(p.n - i0) : CHUNK;
    // (every index into words is a constant after unrolling, so the array
    // lives in registers)
    uint32_t words[4];
    if (p.vec && kmax == CHUNK) {
      const uint4 v = *reinterpret_cast<const uint4*>(p.mask + i0);
      words[0] = v.x; words[1] = v.y; words[2] = v.z; words[3] = v.w;
    } else {
      words[0] = words[1] = words[2] = words[3] = 0u;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        if (k < kmax)
          words[k >> 2] |= (uint32_t)(p.mask[i0 + k] != 0) << (8 * (k & 3));
    }
    // torch bools are bytes of 0 or 1: the popcount is the live count
    const int live = __popc(words[0]) + __popc(words[1]) + __popc(words[2])
                     + __popc(words[3]);
    if (live == 0) continue;
    live_total += live;
    long long blk = 0, off = i0, base = 0;
    if (STARTS) {
      blk = i0 / p.bsz;
      off = i0 - blk * p.bsz;
      base = p.starts[blk];
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (STARTS && off == p.bsz && k < kmax) {
        ++blk;
        off = 0;
        base = p.starts[blk];
      }
      if ((words[k >> 2] >> (8 * (k & 3))) & 0xffu) {
        const long long row = STARTS ? base + off : i0 + k;
        const float fx = __fdiv_rn(__fsub_rn(p.xf[row], xmin), dx);
        const float fy = __fdiv_rn(__fsub_rn(p.yf[row], ymin), dy);
        if (fx >= 0.f && fx < 1.f && fy >= 0.f && fy < 1.f) {
          int ix = __float2int_rz(__fmul_rn(fx, fw));
          int iy = __float2int_rz(__fmul_rn(fy, fh));
          ix = min(max(ix, 0), p.width - 1);
          iy = min(max(iy, 0), p.height - 1);
          add_cell<WK>(hist, iy * p.width + ix, p, row);
        }
      }
      ++off;
    }
  }

  // the count of live candidates: a warp sum, one atomic a warp
  for (int s = 16; s > 0; s >>= 1)
    live_total += __shfl_down_sync(0xffffffffu, live_total, s);
  if ((threadIdx.x & 31) == 0 && live_total) atomicAdd(p.count, live_total);

  if (SHARED) {
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += THREADS) {
      if (WK == W_NONE) {
        const unsigned v = reinterpret_cast<unsigned*>(smem)[c];
        if (v) atomicAdd(p.counts + c, v);
      } else {
        const float v = reinterpret_cast<float*>(smem)[c];
        if (v != 0.f) atomicAdd(p.grid + c, v);
      }
    }
  }
}

// unit weights: uint32 counts → the f32 grid, clamped where f32 sums of ones
// stop
__global__ void finish_counts_kernel(const unsigned* counts, float* grid,
                                     int cells) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < cells) {
    const unsigned v = counts[c];
    grid[c] = (float)(v < UNIT_CLAMP ? v : UNIT_CLAMP);
  }
}

template <bool SHARED, int WK, bool STARTS>
cudaError_t launch(const Params& p, size_t smem, int sms, cudaStream_t st) {
  auto kernel = grid_scatter_kernel<SHARED, WK, STARTS>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long nchunks = (p.n + CHUNK - 1) / CHUNK;
  const long long want = (nchunks + THREADS - 1) / THREADS;
  const long long fit = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  kernel<<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool SHARED, int WK>
cudaError_t launch_starts(const Params& p, size_t smem, int sms,
                          cudaStream_t st) {
  return p.starts ? launch<SHARED, WK, true>(p, smem, sms, st)
                  : launch<SHARED, WK, false>(p, smem, sms, st);
}

template <bool SHARED>
cudaError_t launch_weights(const Params& p, int wkind, size_t smem, int sms,
                           cudaStream_t st) {
  switch (wkind) {
    case W_NONE: return launch_starts<SHARED, W_NONE>(p, smem, sms, st);
    case W_I32: return launch_starts<SHARED, W_I32>(p, smem, sms, st);
    case W_F32: return launch_starts<SHARED, W_F32>(p, smem, sms, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Zeroes the outputs, scatters and, for unit weights, converts the counts.
// counts: H*W uint32 scratch (unit weights; may be null otherwise).
// shared: 1 for the shared-memory route. Returns the first CUDA error.
extern "C" int grid_scatter_launch(const float* xf, const float* yf,
                                   const void* weight, int wkind,
                                   const uint8_t* mask,
                                   const long long* starts, long long bsz,
                                   long long n, const float* bbox, int width,
                                   int height, int shared, float* grid,
                                   unsigned* counts, int* count,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int cells = width * height;
  cudaError_t err = cudaMemsetAsync(grid, 0, sizeof(float) * cells, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (wkind == W_NONE) {
    err = cudaMemsetAsync(counts, 0, sizeof(unsigned) * cells, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    Params p;
    p.xf = xf;
    p.yf = yf;
    p.weight = weight;
    p.mask = mask;
    p.starts = starts;
    p.bsz = bsz;
    p.n = n;
    p.bbox = bbox;
    p.width = width;
    p.height = height;
    p.grid = grid;
    p.counts = counts;
    p.count = count;
    p.vec = ((uintptr_t)mask & 15u) == 0;
    err = shared
        ? launch_weights<true>(p, wkind, sizeof(unsigned) * (size_t)cells,
                               sms, st)
        : launch_weights<false>(p, wkind, 0, sms, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (wkind == W_NONE) {
    finish_counts_kernel<<<(cells + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        counts, grid, cells);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" const char* grid_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
