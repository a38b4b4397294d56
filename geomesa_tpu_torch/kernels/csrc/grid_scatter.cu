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
// rows land in few cells (Z-ordered rows of clustered points do), by the
// serialization of atomic updates to a cell. Measured on the H100 (PERF.md)
// it stays at a third of its byte bound at the flagship 64x64 density: the
// instructions a live row takes (two IEEE divisions, the row arithmetic,
// the aggregation) bound it, not bytes, atomics or occupancy.
//
// Design:
// - A warp takes units of 512 consecutive candidates: each lane reads 16
//   mask bytes with one 16-byte load (bytewise where the mask is not 16-byte
//   aligned or at the ragged tail) and packs them to 16 bits. A unit with
//   no live byte costs that read; the next unit's mask and block starts
//   are loaded while this one is processed. The unit's live candidates are
//   packed in order into the warp's slots in shared memory (a scan of the
//   lanes' counts), and walked in rounds of 32 consecutive live
//   candidates, lane l taking the round's l-th: a warp's x/y loads, read
//   through the block starts, cover the rows between the round's first
//   and last live candidate, and no lane of a round is idle but in the
//   unit's last. The rounds go in batches of FLIGHT whose loads are all
//   issued before the batch's first atomic.
// - Hits on one cell within a round are aggregated and added with one
//   atomic: unit counts by __match_any_sync on the cell index (the leader
//   adds the group's size); weighted sums on the shared route by a
//   segmented reduction over the runs of lanes that share a cell, on the
//   global route by __match_any_sync and a serial sum (see add_cells).
// - Shared route (the raster fits a CTA's shared memory; the wrapper
//   decides from H*W): each CTA keeps nsub private rasters in shared memory
//   (as many as fit in SUB_BUDGET, at most one a warp: two at 64x64, each
//   shared by four warps; more cost occupancy and gain nothing) and
//   flushes their sums' nonzero cells with one global atomic each. Global
//   route (e.g. the reference's default 256x256 = 256 KiB, past the 227 KB
//   a CTA can hold): atomics go straight to the device accumulators.
// - One launch a call: the accumulators, the live count and two CTA
//   counters live in a scratch the wrapper keeps per stream, zero between
//   calls, which the kernel converts into the f32 grid and the count and
//   zeroes again: no memset and no second kernel. Up to LAST_CTA_CELLS
//   cells the last CTA to take a ticket does it alone. Past that (256x256:
//   65,536 cells, too many for one CTA to finish quickly) every CTA does a
//   share of it past a grid barrier; that launch is cooperative, so every
//   CTA is resident (a plain launch is some microseconds cheaper, so small
//   rasters keep it), and the last CTA out resets the barrier.
// - Unit weights count in uint32 cells and convert to f32 at the end,
//   clamped at 2^24: the reference adds f32 ones one at a time, and such a
//   sum stops at 2^24 = 16,777,216, so the clamp gives its grid byte for
//   byte at every count.
// - Weighted grids add f32 weights (int32 weights convert with round to
//   nearest, as astype(float32) does). The order of the additions is the
//   warps' pre-sums, the sub-raster sums and the atomics' order, not the
//   reference's sequential order; every order of the n additions of a cell
//   stays within gamma(n - 1) * sum|w| of the exact sum, so a cell agrees
//   with the reference within the stated 2 * gamma(n - 1) * sum|w|, not bit
//   for bit.
//
// Snap parity: every step is one round-to-nearest f32 operation in the
// reference's order (__fsub_rn, an IEEE __fdiv_rn, __fmul_rn by W as an f32)
// and the build passes -fmad=false; fast math or a reciprocal would move
// rows that lie on cell edges.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UNIT = 32 * 16;               // candidates a warp takes at once
constexpr int FLIGHT = 4;                   // rounds whose loads fly together
constexpr unsigned UNIT_CLAMP = 1u << 24;   // where f32 sums of ones stop
constexpr int SUB_BUDGET = 32 * 1024;       // shared bytes for sub-rasters
// rasters up to this many cells are finished by the last CTA alone; larger
// ones by every CTA past a grid barrier
constexpr int LAST_CTA_CELLS = 16 * 1024;

enum WeightKind { W_NONE = 0, W_I32 = 1, W_F32 = 2 };

struct Params {
  const float* xf;
  const float* yf;
  const void* weight;
  const uint8_t* mask;
  const long long* starts;
  const int* nlive;     // null, or the live slots of starts: only their
                        // candidates are read
  long long bsz;
  long long n;
  const float* bbox;    // [xmin, ymin, xmax, ymax] f32, on the device
  int width;
  int height;
  int nsub;             // shared route: private rasters a CTA
  int vec;              // mask 16-byte aligned
  int grid_vec;         // grid 16-byte aligned
  float* grid;          // (H, W) f32 output
  int* count;           // live candidates, output
  unsigned* ticket;     // scratch, zero between calls: CTAs done
  unsigned* live;       //   live candidates so far
  unsigned* out;        //   CTAs past the grid barrier
  unsigned* acc;        //   H*W cells: uint32 counts or f32 sums, 16-byte
                        //   aligned
};

// the 4 bytes of w (0 or 1 each: torch bools) as 4 bits
__device__ __forceinline__ unsigned nib(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// an accumulator's grid value: unit counts clamped where f32 sums of ones
// stop; weighted sums as they are
template <int WK>
__device__ __forceinline__ float finish_cell(unsigned v) {
  return WK == W_NONE ? (float)(v < UNIT_CLAMP ? v : UNIT_CLAMP)
                      : __uint_as_float(v);
}

// adds each lane's hit (cell >= 0, weight w) to hist with one atomic per
// group of lanes that hit one cell. Unit weights: the group is every lane
// of the cell (__match_any_sync) and adds its size. Weighted, RUNS (the
// shared route): lanes hold consecutive live rows, and Z-ordered rows that
// share a cell sit in runs of lanes, so each run's weights are summed into
// its first lane (a segmented reduction in 5 shuffle steps). Weighted, not
// RUNS (the global route, whose atomics cost more): the group is every
// lane of the cell, summed by its leader one shuffle a member.
template <int WK, bool RUNS>
__device__ __forceinline__ void add_cells(unsigned* hist, int cell, float w,
                                          int lane) {
  if (__ballot_sync(FULL, cell >= 0) == 0u) return;
  if (WK != W_NONE && RUNS) {
    const int prev = __shfl_up_sync(FULL, cell, 1);
    const bool head = lane == 0 || prev != cell;
    const unsigned heads = __ballot_sync(FULL, head);
    const unsigned after = lane == 31 ? 0u : heads >> (lane + 1) << (lane + 1);
    const int end = after ? __ffs(after) - 1 : 32;   // the next run's head
    float s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(FULL, s, o);
      if (lane + o < end) s = __fadd_rn(s, v);
    }
    if (head && cell >= 0) atomicAdd(reinterpret_cast<float*>(hist) + cell, s);
    return;
  }
  const unsigned peers = __match_any_sync(FULL, cell);
  const bool leader = cell >= 0 && lane == __ffs(peers) - 1;
  if (WK == W_NONE) {
    if (leader) atomicAdd(hist + cell, (unsigned)__popc(peers));
    return;
  }
  float s = w;
  unsigned rest = leader ? peers & (peers - 1u) : 0u;   // the other members
  while (__any_sync(FULL, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    const float v = __shfl_sync(FULL, w, src);
    if (rest) {
      s = __fadd_rn(s, v);
      rest &= rest - 1u;
    }
  }
  if (leader) atomicAdd(reinterpret_cast<float*>(hist) + cell, s);
}

// the next unit's loads, issued a unit ahead: its 16 mask bytes a lane (or,
// bytewise, their bits) and the starts of the blocks it begins in and
// runs into
struct Fetch {
  uint4 raw;
  bool packed;        // raw.x holds the 16 bits already
  long long off0;     // the unit's first candidate's offset in its block
  long long s0, s1;   // that block's start, the next block's start
  long long blk;
};

template <bool STARTS>
__device__ __forceinline__ Fetch fetch(const Params& p, long long u,
                                       int lane) {
  Fetch f;
  f.raw = make_uint4(0u, 0u, 0u, 0u);
  f.packed = true;
  f.off0 = f.s0 = f.s1 = f.blk = 0;
  const long long base = u * UNIT;
  if (base >= p.n) return f;
  const long long c0 = base + 16 * lane;
  if (p.vec && base + UNIT <= p.n) {
    f.raw = __ldg(reinterpret_cast<const uint4*>(p.mask + c0));
    f.packed = false;
  } else {
    unsigned m16 = 0u;
    for (int k = 0; k < 16; ++k)
      if (c0 + k < p.n && p.mask[c0 + k]) m16 |= 1u << k;
    f.raw.x = m16;
  }
  if (STARTS) {
    f.blk = base / p.bsz;
    f.off0 = base - f.blk * p.bsz;
    f.s0 = __ldg(p.starts + f.blk);
    if (f.off0 + UNIT > p.bsz && base + p.bsz - f.off0 < p.n)
      f.s1 = __ldg(p.starts + f.blk + 1);
  }
  return f;
}

template <bool SHARED, int WK, bool STARTS>
__global__ void __launch_bounds__(THREADS)
grid_scatter_kernel(Params p) {
  if (p.nlive) {   // the block list's live candidates, read on the device
    const long long live = (long long)max(*p.nlive, 0) * p.bsz;
    if (live < p.n) p.n = live;
  }
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ unsigned s_live;
  __shared__ bool s_finish;
  __shared__ uint16_t s_slots[WARPS][UNIT];   // a warp's live candidates
  const int cells = p.width * p.height;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* hist = p.acc;
  if (SHARED) {
    for (int c = threadIdx.x; c < cells * p.nsub; c += THREADS) smem[c] = 0u;
    hist = smem + (warp % p.nsub) * cells;
  }
  if (threadIdx.x == 0) s_live = 0u;
  __syncthreads();
  const float xmin = p.bbox[0], ymin = p.bbox[1];
  const float dx = __fsub_rn(p.bbox[2], xmin);
  const float dy = __fsub_rn(p.bbox[3], ymin);
  const float fw = (float)p.width, fh = (float)p.height;

  unsigned live_total = 0u;
  uint16_t* slots = s_slots[warp];
  const long long units = (p.n + UNIT - 1) / UNIT;
  const long long stride = (long long)gridDim.x * WARPS;
  long long u = (long long)blockIdx.x * WARPS + warp;
  Fetch next = fetch<STARTS>(p, u, lane);
  for (; u < units; u += stride) {
    const Fetch f = next;
    next = fetch<STARTS>(p, u + stride, lane);   // in flight meanwhile
    const long long base = u * UNIT;
    const unsigned m16 = f.packed ? f.raw.x
        : nib(f.raw.x) | nib(f.raw.y) << 4 | nib(f.raw.z) << 8
          | nib(f.raw.w) << 12;
    // the live candidates' offsets in the unit, in order, into the warp's
    // slots: an inclusive scan of the lanes' counts puts each lane's after
    // those of the lanes before it
    const int mine = __popc(m16);
    live_total += mine;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    if (total == 0) continue;   // warp-uniform
    // candidate idx of the unit is row (idx < split ? lo : hi) + idx: the
    // unit's rows run on from its first block's start into the next one's
    long long lo = base, hi = base;
    int split = UNIT;
    if (STARTS) {
      lo = f.s0 + f.off0;
      hi = f.s1 + f.off0 - p.bsz;
      split = p.bsz - f.off0 < UNIT ? (int)(p.bsz - f.off0) : UNIT;
    }
    int pos = incl - mine;
    for (unsigned bits = m16; bits; bits &= bits - 1u)
      slots[pos++] = (uint16_t)(16 * lane + __ffs(bits) - 1);
    __syncwarp();
    // rounds of 32 live candidates in batches of FLIGHT: all loads of a
    // batch are issued before its first atomic
#pragma unroll 1
    for (int r0 = 0; r0 < total; r0 += 32 * FLIGHT) {
      float xs[FLIGHT], ys[FLIGHT], ws[FLIGHT];
#pragma unroll
      for (int k = 0; k < FLIGHT; ++k) {
        xs[k] = ys[k] = ws[k] = 0.f;
        const int slot = r0 + 32 * k + lane;
        if (slot < total) {
          const int idx = slots[slot];
          long long row = (idx < split ? lo : hi) + idx;
          if (STARTS && p.bsz < UNIT && f.off0 + idx >= 2 * p.bsz) {
            long long off = f.off0 + idx, b = f.blk;   // short blocks
            while (off >= p.bsz) {
              off -= p.bsz;
              ++b;
            }
            row = p.starts[b] + off;
          }
          xs[k] = p.xf[row];
          ys[k] = p.yf[row];
          if (WK == W_I32)
            ws[k] = __int2float_rn(static_cast<const int*>(p.weight)[row]);
          else if (WK == W_F32)
            ws[k] = static_cast<const float*>(p.weight)[row];
        }
      }
#pragma unroll
      for (int k = 0; k < FLIGHT; ++k) {
        if (r0 + 32 * k >= total) break;   // warp-uniform
        int cell = -1;
        if (r0 + 32 * k + lane < total) {
          const float fx = __fdiv_rn(__fsub_rn(xs[k], xmin), dx);
          const float fy = __fdiv_rn(__fsub_rn(ys[k], ymin), dy);
          if (fx >= 0.f && fx < 1.f && fy >= 0.f && fy < 1.f) {
            int ix = __float2int_rz(__fmul_rn(fx, fw));
            int iy = __float2int_rz(__fmul_rn(fy, fh));
            ix = min(max(ix, 0), p.width - 1);
            iy = min(max(iy, 0), p.height - 1);
            cell = iy * p.width + ix;
          }
        }
        add_cells<WK, SHARED>(hist, cell, ws[k], lane);
      }
    }
    __syncwarp();   // the slots are rewritten by the next unit
  }

  // the live count: a warp sum, one shared atomic a warp
  live_total = __reduce_add_sync(FULL, live_total);
  if (lane == 0 && live_total) atomicAdd(&s_live, live_total);
  __syncthreads();
  if (SHARED) {
    for (int c = threadIdx.x; c < cells; c += THREADS) {
      if (WK == W_NONE) {
        unsigned v = 0u;
        for (int s = 0; s < p.nsub; ++s) v += smem[s * cells + c];
        if (v) atomicAdd(p.acc + c, v);
      } else {
        const float* f = reinterpret_cast<const float*>(smem);
        float v = 0.f;
        for (int s = 0; s < p.nsub; ++s) v = __fadd_rn(v, f[s * cells + c]);
        if (v != 0.f) atomicAdd(reinterpret_cast<float*>(p.acc) + c, v);
      }
    }
  }
  if (threadIdx.x == 0 && s_live) atomicAdd(p.live, s_live);

  // the accumulators become the f32 grid and the count, and are zeroed for
  // the next call: by the last CTA to finish for a small raster, by every
  // CTA past a grid barrier for a large one (whose launch is cooperative,
  // so every CTA is resident and the barrier cannot wait on an unscheduled
  // one)
  __threadfence();
  __syncthreads();
  const bool small = cells <= LAST_CTA_CELLS;
  if (threadIdx.x == 0) {
    const unsigned arrived = atomicAdd(p.ticket, 1u);
    s_finish = !small || arrived == gridDim.x - 1;
    if (!small)
      while (*(volatile unsigned*)p.ticket < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
  if (!s_finish) return;
  const int quads = cells / 4;   // the accumulators start 16-byte aligned
  uint4* acc4 = reinterpret_cast<uint4*>(p.acc);
  const int first = (small ? 0 : blockIdx.x * THREADS) + threadIdx.x;
  const int step = small ? THREADS : gridDim.x * THREADS;
  for (int q = first; q < quads; q += step) {
    const uint4 v = __ldcg(acc4 + q);
    float4 g;
    g.x = finish_cell<WK>(v.x);
    g.y = finish_cell<WK>(v.y);
    g.z = finish_cell<WK>(v.z);
    g.w = finish_cell<WK>(v.w);
    if (p.grid_vec) {
      reinterpret_cast<float4*>(p.grid)[q] = g;
    } else {
      p.grid[4 * q] = g.x;
      p.grid[4 * q + 1] = g.y;
      p.grid[4 * q + 2] = g.z;
      p.grid[4 * q + 3] = g.w;
    }
    acc4[q] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int c = 4 * quads + first; c < cells; c += step) {
    p.grid[c] = finish_cell<WK>(__ldcg(p.acc + c));
    p.acc[c] = 0u;
  }
  if (threadIdx.x == 0) {
    if (small || blockIdx.x == 0) {
      *p.count = (int)__ldcg(p.live);
      *p.live = 0u;
    }
    if (small) {
      *p.ticket = 0u;
    } else if (atomicAdd(p.out, 1u) == gridDim.x - 1) {
      // the last CTA out has seen every CTA pass the barrier
      *p.ticket = 0u;
      *p.out = 0u;
    }
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
  const long long units = (p.n + UNIT - 1) / UNIT;
  const long long want = (units + WARPS - 1) / WARPS;
  const long long fit = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  if (p.width * p.height <= LAST_CTA_CELLS) {
    kernel<<<grid, THREADS, smem, st>>>(p);
    return cudaGetLastError();
  }
  // the grid barrier needs every CTA resident: a cooperative launch (which
  // costs some microseconds more than a plain one)
  void* args[] = {const_cast<Params*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(THREADS), args, smem,
                                     st);
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

// Scatters the n > 0 candidates into `grid` (H*W f32) and their live count
// into `count`, in one launch; with nlive (a device count of live slots of
// starts, may be null) only the first *nlive * bsz candidates. scratch: 4 + H*W 32-bit words, 16-byte
// aligned, zero on entry and left zero ([0] and [2] the CTA counters, [1]
// the live count, [4...] the cells);
// calls that share a scratch must be ordered (one stream). shared: 1 for
// the shared-memory route. Returns the first CUDA error.
extern "C" int grid_scatter_launch(const float* xf, const float* yf,
                                   const void* weight, int wkind,
                                   const uint8_t* mask,
                                   const long long* starts,
                                   const int* nlive, long long bsz,
                                   long long n, const float* bbox, int width,
                                   int height, int shared, float* grid,
                                   int* count, unsigned* scratch,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int cells = width * height;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.xf = xf;
  p.yf = yf;
  p.weight = weight;
  p.mask = mask;
  p.starts = starts;
  p.nlive = nlive;
  p.bsz = bsz;
  p.n = n;
  p.bbox = bbox;
  p.width = width;
  p.height = height;
  const size_t raster = sizeof(unsigned) * (size_t)cells;
  const int nsub = (int)(SUB_BUDGET / raster);
  p.nsub = nsub < 1 ? 1 : (nsub > WARPS ? WARPS : nsub);
  p.vec = ((uintptr_t)mask & 15u) == 0;
  p.grid = grid;
  p.count = count;
  p.grid_vec = ((uintptr_t)grid & 15u) == 0;
  p.ticket = scratch;
  p.live = scratch + 1;
  p.out = scratch + 2;
  p.acc = scratch + 4;
  if (((uintptr_t)p.acc & 15u) != 0) return (int)cudaErrorMisalignedAddress;
  err = shared ? launch_weights<true>(p, wkind, raster * p.nsub, sms, st)
               : launch_weights<false>(p, wkind, 0, sms, st);
  return (int)err;
}

extern "C" const char* grid_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
