// Batched box counts for Hopper (sm_90a): per candidate row of a Z3 point
// table, base = membership AND any time window AND the residual mask AND
// __valid__; then either one count per box (per_box) or one count of the
// rows inside any box (any_box; base alone when there are no boxes).
//
// Replaces the XLA programs of geomesa_tpu/index/scan.py: the ScanKernels
// modes count_multi (:620, lax.map of one box count over the boxes) and
// count_multi_blocks (:701, the same over the union of the batch's
// candidate blocks), and the any-box mask plus sum of the modes count and
// count_blocks (_mask_kernel :368, run :597 and :697). Box tests compare the
// fp62 (hi, lo) int32 planes lexicographically and SIGNED, as the
// reference's _ge62/_le62 do: EMPTY_BOX = [I31MAX, I31MAX, 0, 0, ...]
// matches nothing only under signed compares. A window [bin_lo, off_lo,
// bin_hi, off_hi] with bin_lo > bin_hi is empty.
//
// Candidates: row i of the table, or, with block ids (pad -1) and a block
// size, candidate i reads row astart + i % bsz of block b = i / bsz, where
// astart = clamp(b * bsz, 0, max(0, n - bsz)); the row belongs to the
// candidate set only when b >= 0 and b * bsz <= row < b * bsz + bsz (the
// membership test of index/scan.py:expand_blocks, computed here, not
// gathered: a clamped last block re-reads a suffix of the previous one and
// those re-reads do not count). The residual mask, when given, has one byte
// per candidate (the torch residual function evaluated over the gathered
// residual columns only); __valid__ has one byte per table row.
//
// What bounds it on the card: per candidate 24 bytes of int32 planes (x
// hi/lo, y hi/lo, bin, off) plus the mask bytes; per (candidate, box) four
// lexicographic compares. With a handful of boxes it is bound by bytes (at
// the H100's 3.35 TB/s); at a batch of 64 boxes the compares (integer
// operations, 64 INT32 lanes an SM a clock) bound it instead.
//
// Design (simple first):
// - Grid-stride over candidates, one warp per 32 consecutive candidates,
//   rows read through the block starts (no gathers of the planes). Dead
//   rows (membership, residual, __valid__, windows) read no coordinates.
// - Windows and boxes are staged in shared memory (up to MAX_SMEM_WINDOWS
//   windows and a tile of MAX_SMEM_BOXES boxes; past that they are read
//   from device memory through the read-only cache).
// - The box loop runs only for warps with a live base (__ballot_sync).
//   Per box: __ballot_sync + __popc by lane 0 into a shared per-box counter,
//   then one global atomicAdd per (CTA, box) with a nonzero count. per_box
//   with more boxes than a tile launches once per tile.
// - The outputs are int32 counts the caller zeroed on the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM_WINDOWS = 256;    // 4 KB of windows
constexpr int MAX_SMEM_BOXES = 1024;     // 32 KB of boxes (+ 4 KB counters)

struct Params {
  const int* xi;            // fp62 x hi plane (null without boxes)
  const int* xl;
  const int* yi;
  const int* yl;
  const int* bin;           // binned time (null without windows)
  const int* off;
  const uint8_t* valid;     // __valid__ per table row, or null
  const uint8_t* resid;     // residual mask per candidate, or null
  const int* block_ids;     // padded block ids (pad -1), or null: the table
  long long bsz;
  long long n;              // table rows
  long long ncand;          // candidates: n, or blocks * bsz
  const int* windows;       // (nwin, 4)
  int nwin;
  const int* boxes;         // (nbox, 8): all boxes of the call
  int nbox;
  unsigned* counts;         // per_box: one per box; any_box: one
};

__device__ __forceinline__ bool ge62(int hi, int lo, int qhi, int qlo) {
  return hi > qhi || (hi == qhi && lo >= qlo);
}

__device__ __forceinline__ bool le62(int hi, int lo, int qhi, int qlo) {
  return hi < qhi || (hi == qhi && lo <= qlo);
}

__device__ __forceinline__ bool in_box(const int* q, int xi, int xl, int yi,
                                       int yl) {
  return ge62(xi, xl, q[0], q[1]) && le62(xi, xl, q[2], q[3]) &&
         ge62(yi, yl, q[4], q[5]) && le62(yi, yl, q[6], q[7]);
}

// box0/ntile: the boxes [box0, box0 + ntile) this launch tests (per_box
// tiles; any_box always all of them). smem_boxes: the tile sits in shared
// memory (else it is read from p.boxes).
template <bool PER_BOX, bool BLOCKS>
__global__ void __launch_bounds__(THREADS)
box_count_kernel(Params p, int box0, int ntile, bool smem_boxes) {
  extern __shared__ int smem[];
  const bool smem_windows = p.nwin <= MAX_SMEM_WINDOWS;
  int* s_win = smem;
  int* s_box = s_win + (smem_windows ? 4 * p.nwin : 0);
  unsigned* s_cnt =
      reinterpret_cast<unsigned*>(s_box + (smem_boxes ? 8 * ntile : 0));
  const int ncnt = PER_BOX ? ntile : 1;

  if (smem_windows)
    for (int k = threadIdx.x; k < 4 * p.nwin; k += THREADS)
      s_win[k] = p.windows[k];
  if (smem_boxes)
    for (int k = threadIdx.x; k < 8 * ntile; k += THREADS)
      s_box[k] = p.boxes[8 * box0 + k];
  for (int k = threadIdx.x; k < ncnt; k += THREADS) s_cnt[k] = 0u;
  __syncthreads();
  const int* win = smem_windows ? s_win : p.windows;
  const int* box = smem_boxes ? s_box : p.boxes + 8 * box0;

  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long stride = (long long)gridDim.x * WARPS * 32;
  const long long clamp_hi = p.n > p.bsz ? p.n - p.bsz : 0;

  for (long long base = warp * 32; base < p.ncand; base += stride) {
    const long long i = base + lane;
    bool live = i < p.ncand;
    long long row = i;
    if (BLOCKS && live) {
      const int b = __ldg(p.block_ids + i / p.bsz);
      const long long start = (long long)b * p.bsz;
      const long long astart =
          start < 0 ? 0 : (start > clamp_hi ? clamp_hi : start);
      row = astart + i % p.bsz;
      live = b >= 0 && row >= start && row < start + p.bsz && row < p.n;
    }
    if (live && p.resid) live = p.resid[i] != 0;
    if (live && p.valid) live = p.valid[row] != 0;
    if (live && p.nwin > 0) {
      const int tb = p.bin[row];
      const int to = p.off[row];
      bool any = false;
      for (int w = 0; w < p.nwin && !any; ++w) {
        const int blo = win[4 * w], olo = win[4 * w + 1];
        const int bhi = win[4 * w + 2], ohi = win[4 * w + 3];
        any = blo <= bhi && (tb > blo || (tb == blo && to >= olo)) &&
              (tb < bhi || (tb == bhi && to <= ohi));
      }
      live = any;
    }
    if (__ballot_sync(FULL, live) == 0u) continue;   // warp-uniform
    int xi = 0, xl = 0, yi = 0, yl = 0;
    if (live && p.nbox > 0) {
      xi = p.xi[row];
      xl = p.xl[row];
      yi = p.yi[row];
      yl = p.yl[row];
    }
    if (PER_BOX) {
      for (int b = 0; b < ntile; ++b) {
        const bool hit = live && in_box(box + 8 * b, xi, xl, yi, yl);
        const unsigned m = __ballot_sync(FULL, hit);
        if (lane == 0 && m) atomicAdd(&s_cnt[b], (unsigned)__popc(m));
      }
    } else {
      bool hit = live;
      if (live && p.nbox > 0) {
        hit = false;
        for (int b = 0; b < ntile && !hit; ++b)
          hit = in_box(box + 8 * b, xi, xl, yi, yl);
      }
      const unsigned m = __ballot_sync(FULL, hit);
      if (lane == 0 && m) atomicAdd(&s_cnt[0], (unsigned)__popc(m));
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ncnt; k += THREADS) {
    const unsigned c = s_cnt[k];
    if (c) atomicAdd(p.counts + (PER_BOX ? box0 + k : 0), c);
  }
}

template <bool PER_BOX, bool BLOCKS>
cudaError_t launch(const Params& p, int box0, int ntile, bool smem_boxes,
                   int sms, cudaStream_t st) {
  auto kernel = box_count_kernel<PER_BOX, BLOCKS>;
  const size_t smem =
      sizeof(int) * ((p.nwin <= MAX_SMEM_WINDOWS ? 4 * p.nwin : 0) +
                     (smem_boxes ? 8 * ntile : 0)) +
      sizeof(unsigned) * (PER_BOX ? ntile : 1);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (p.ncand + THREADS - 1) / THREADS;
  const long long fit = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  kernel<<<grid, THREADS, smem, st>>>(p, box0, ntile, smem_boxes);
  return cudaGetLastError();
}

template <bool PER_BOX>
cudaError_t launch_blocks(const Params& p, int box0, int ntile,
                          bool smem_boxes, int sms, cudaStream_t st) {
  return p.block_ids
             ? launch<PER_BOX, true>(p, box0, ntile, smem_boxes, sms, st)
             : launch<PER_BOX, false>(p, box0, ntile, smem_boxes, sms, st);
}

}  // namespace

// Adds the counts of the candidates into `counts` (int32, zeroed by the
// caller on the same stream): nbox counts when per_box, else one. Returns
// the first CUDA error (0 on success).
extern "C" int box_count_launch(const int* xi, const int* xl, const int* yi,
                                const int* yl, const int* bin, const int* off,
                                const uint8_t* valid, const uint8_t* resid,
                                const int* block_ids, long long nblocks,
                                long long bsz, long long n,
                                const int* windows, int nwin,
                                const int* boxes, int nbox, int per_box,
                                int* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  p.xi = xi;
  p.xl = xl;
  p.yi = yi;
  p.yl = yl;
  p.bin = bin;
  p.off = off;
  p.valid = valid;
  p.resid = resid;
  p.block_ids = block_ids;
  p.bsz = bsz;
  p.n = n;
  p.ncand = block_ids ? nblocks * bsz : n;
  p.windows = windows;
  p.nwin = nwin;
  p.boxes = boxes;
  p.nbox = nbox;
  p.counts = reinterpret_cast<unsigned*>(counts);
  if (p.ncand <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_box) {
    for (int box0 = 0; box0 < nbox; box0 += MAX_SMEM_BOXES) {
      const int ntile =
          nbox - box0 < MAX_SMEM_BOXES ? nbox - box0 : MAX_SMEM_BOXES;
      err = launch_blocks<true>(p, box0, ntile, true, sms, st);
      if (err != cudaSuccess) return (int)err;
    }
  } else {
    err = launch_blocks<false>(p, 0, nbox, nbox <= MAX_SMEM_BOXES, sms, st);
  }
  return (int)err;
}

extern "C" const char* box_count_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
