// Batched box counts for Hopper (sm_90a): per candidate row of a point or
// extent table, base = membership AND any time window AND the residual mask
// AND __valid__; then either one count per box (per_box) or one count of
// the rows inside any box (any_box; base alone when there are no boxes).
// A point row is in a box when its point is; an extent row (ENV, the
// bbox_overlap primary of the XZ indexes) when its envelope overlaps it:
// bxmin <= qxhi, bxmax >= qxlo, bymin <= qyhi, bymax >= qylo.
//
// Replaces the XLA programs of geomesa_tpu/index/scan.py: the ScanKernels
// modes count_multi (:620, lax.map of one box count over the boxes) and
// count_multi_blocks (:701, the same over the union of the batch's
// candidate blocks), and the any-box mask plus sum of the modes count and
// count_blocks (_mask_kernel :368, run :597 and :697), for the point
// primary (_point_box_mask :94) and the envelope primary
// (_bbox_overlap_pairwise/_bbox_overlap_mask :100-114).
//
// Keys: the reference compares fp62 (hi, lo) int32 pairs lexicographically
// and SIGNED (_ge62/_le62, scan.py:72). A pair becomes one int64,
//     key = (hi << 32) | (uint32)(lo ^ 0x80000000),
// whose signed order is exactly that lexicographic order for every int32
// hi and lo (flipping lo's sign bit maps signed lo order onto unsigned
// order). A box is (xlo, xhi, ylo, yhi) keys and a window (lo, hi) keys of
// (bin, off). EMPTY_BOX = [I31MAX, I31MAX, 0, 0, ...] and a window with
// bin_lo > bin_hi have lo key > hi key, so they match nothing.
//
// Candidates: row i of the table, or, with block ids (pad -1) and a block
// size, candidate i reads row astart + i % bsz of block b = i / bsz, where
// astart = clamp(b * bsz, 0, max(0, n - bsz)); the row belongs to the
// candidate set only when b >= 0 and b * bsz <= row < b * bsz + bsz (the
// membership test of index/scan.py:expand_blocks, computed here, not
// gathered: a clamped last block re-reads a suffix of the previous one and
// those re-reads do not count). The residual mask, when given, has one byte
// per candidate; __valid__ has one byte per table row.
//
// What bounds it on the card: per candidate 8 bytes of time planes plus the
// mask bytes, per passing candidate 16 bytes of box planes (32 for an
// envelope); per (passing candidate, box) four 64-bit compares (8 int32
// instructions), for points and envelopes alike. With a handful of boxes
// it is bound by bytes (the H100's 3.35 TB/s); at a batch of 64 boxes by
// the compares (64 INT32 lanes an SM a clock).
//
// Design:
// - Phase A (filter): a CTA takes rounds of TILE consecutive candidates;
//   each lane takes 4 consecutive candidates a step (16-byte loads of the
//   planes where the 4 rows are consecutive and aligned, 4-byte loads of
//   the masks), rows read through the block starts. Dead candidates read no
//   further plane; the windows test keys from shared memory.
// - per_box, phase B (test): phase A appends the passing candidates' (x
//   key, y key; an envelope's four keys in 32 bytes) to a tile in shared
//   memory (one shared atomicAdd a warp and
//   a prefix popcount of the ballots for the slots). After __syncthreads
//   each lane takes one box, its 4 keys in registers, and walks the tile:
//   one broadcast 16-byte shared load a candidate, 4 compares and a
//   predicated add into a register counter. With B < 32 boxes lanes split
//   the tile by candidate (lane = box + B * k), with 32 < B < 256 the box
//   groups of 32 split it among the warps (each warp a contiguous run),
//   past 256 a lane takes several boxes. A lane flushes its count with one
//   shared atomicAdd a tile, and the CTA adds one global atomicAdd per
//   (CTA, box) at the end. Boxes are staged in shared memory in launches
//   of MAX_SMEM_BOXES.
// - any_box: no tile; each live candidate walks the boxes until its first
//   hit (boxes in shared memory up to MAX_SMEM_BOXES, else packed from
//   device memory as it goes), and the count is one warp reduction, one
//   shared atomic a warp and one global atomic a CTA.
// - Windows are staged as keys in shared memory up to MAX_SMEM_WINDOWS,
//   else packed from device memory through the read-only cache.
// - The outputs are int32 counts the caller zeroed on the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int VEC = 4;                        // candidates a lane a step
constexpr int STEPS = 2;                      // warp steps a round
constexpr int TILE = THREADS * VEC * STEPS;   // candidates a CTA round
constexpr int MAX_SMEM_WINDOWS = 256;         // 4 KB of window keys
constexpr int MAX_SMEM_BOXES = 1024;          // 32 KB of box keys

struct Params {
  const int* xi;            // fp62 x hi plane (null without boxes)
  const int* xl;
  const int* yi;
  const int* yl;
  const int* xi2;           // ENV: the max planes (xi..yl hold the min)
  const int* xl2;
  const int* yi2;
  const int* yl2;
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
  int vec;                  // planes 16-byte and masks 4-byte aligned
};

struct BoxKeys {
  long long xlo, xhi, ylo, yhi;
};

__device__ __forceinline__ long long pack62(int hi, int lo) {
  return (long long)(((unsigned long long)(unsigned)hi << 32)
                     | (unsigned)(lo ^ (int)0x80000000));
}

__device__ __forceinline__ BoxKeys box_keys(const int* q) {
  return {pack62(__ldg(q), __ldg(q + 1)), pack62(__ldg(q + 2), __ldg(q + 3)),
          pack62(__ldg(q + 4), __ldg(q + 5)),
          pack62(__ldg(q + 6), __ldg(q + 7))};
}

__device__ __forceinline__ longlong2 window_keys(const int* w) {
  return make_longlong2(pack62(__ldg(w), __ldg(w + 1)),
                        pack62(__ldg(w + 2), __ldg(w + 3)));
}

__device__ __forceinline__ bool in_box(const BoxKeys& q, long long kx,
                                       long long ky) {
  return (kx >= q.xlo) & (kx <= q.xhi) & (ky >= q.ylo) & (ky <= q.yhi);
}

// the envelope [x0, x1] x [y0, y1] overlaps box q
__device__ __forceinline__ bool overlaps(const BoxKeys& q, long long x0,
                                         long long x1, long long y0,
                                         long long y1) {
  return (x0 <= q.xhi) & (x1 >= q.xlo) & (y0 <= q.yhi) & (y1 >= q.ylo);
}

// 4 int32 values of a plane at rows[k] (k with a bit in `need`): one
// 16-byte load when the rows are consecutive and aligned (`contig`)
__device__ __forceinline__ void load4(const int* plane, bool contig,
                                      const long long* rows, unsigned need,
                                      int* out) {
  if (contig) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(plane + rows[0]));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      out[k] = (need >> k) & 1u ? plane[rows[k]] : 0;
  }
}

// 4 mask bytes at idx[k] as bits (k with a bit in `need`); one 4-byte load
// when `contig` (idx consecutive from a multiple of 4)
__device__ __forceinline__ unsigned mask4(const uint8_t* m, bool contig,
                                          const long long* idx,
                                          unsigned need) {
  unsigned out = 0u;
  if (contig) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(m + idx[0]));
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      out |= ((w >> (8 * k)) & 0xffu) ? 1u << k : 0u;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (((need >> k) & 1u) && m[idx[k]]) out |= 1u << k;
  }
  return out & need;
}

// Phase A for a lane's candidates i0 .. i0 + 3 (i0 a multiple of 4): the
// bits of the live ones, and with `keys` their x and y keys (ENV: the min
// keys, and the max keys in kx2, ky2).
template <bool BLOCKS, bool ENV>
__device__ __forceinline__ unsigned filter4(const Params& p, long long i0,
                                            const longlong2* win, bool keys,
                                            long long* kx, long long* ky,
                                            long long* kx2, long long* ky2) {
  long long rows[VEC], cand[VEC];
  unsigned live = 0u;
  if (BLOCKS) {
    const long long clamp_hi = p.n > p.bsz ? p.n - p.bsz : 0;
    long long blk = i0 / p.bsz, off = i0 - blk * p.bsz;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (k > 0 && ++off == p.bsz) { ++blk; off = 0; }
      cand[k] = i0 + k;
      rows[k] = 0;
      if (cand[k] < p.ncand) {
        const int b = __ldg(p.block_ids + blk);
        const long long start = (long long)b * p.bsz;
        const long long astart =
            start < 0 ? 0 : (start > clamp_hi ? clamp_hi : start);
        rows[k] = astart + off;
        if (b >= 0 && rows[k] >= start && rows[k] < start + p.bsz
            && rows[k] < p.n)
          live |= 1u << k;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      cand[k] = rows[k] = i0 + k;
      if (i0 + k < p.n) live |= 1u << k;
    }
  }
  if (live == 0u) return 0u;
  const bool cand4 = p.vec && i0 + VEC <= p.ncand;
  const bool row4 = p.vec && (rows[0] & 3) == 0 && rows[0] + VEC <= p.n
                    && rows[3] == rows[0] + 3;
  if (p.resid) live = mask4(p.resid, cand4, cand, live);
  if (live && p.valid) live = mask4(p.valid, row4, rows, live);
  if (live && p.nwin > 0) {
    int tb[VEC], to[VEC];
    load4(p.bin, row4, rows, live, tb);
    load4(p.off, row4, rows, live, to);
    unsigned hit = 0u;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (!((live >> k) & 1u)) continue;
      const long long tk = pack62(tb[k], to[k]);
      for (int w = 0; w < p.nwin; ++w) {
        const longlong2 q = win ? win[w] : window_keys(p.windows + 4 * w);
        if ((tk >= q.x) & (tk <= q.y)) { hit |= 1u << k; break; }
      }
    }
    live = hit;
  }
  if (live && keys) {
    int a[VEC], b[VEC];
    load4(p.xi, row4, rows, live, a);
    load4(p.xl, row4, rows, live, b);
#pragma unroll
    for (int k = 0; k < VEC; ++k) kx[k] = pack62(a[k], b[k]);
    load4(p.yi, row4, rows, live, a);
    load4(p.yl, row4, rows, live, b);
#pragma unroll
    for (int k = 0; k < VEC; ++k) ky[k] = pack62(a[k], b[k]);
    if (ENV) {
      load4(p.xi2, row4, rows, live, a);
      load4(p.xl2, row4, rows, live, b);
#pragma unroll
      for (int k = 0; k < VEC; ++k) kx2[k] = pack62(a[k], b[k]);
      load4(p.yi2, row4, rows, live, a);
      load4(p.yl2, row4, rows, live, b);
#pragma unroll
      for (int k = 0; k < VEC; ++k) ky2[k] = pack62(a[k], b[k]);
    }
  }
  return live;
}

// adds 1 to c when (kx, ky) lies in box q: four signed 64-bit compares
// chained through one predicate (8 ISETP) and a predicated add; written in
// PTX because the compiler turns `if (in) ++c` into an add and a select
__device__ __forceinline__ void count_in(unsigned& c, const BoxKeys& q,
                                         long long kx, long long ky) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ge.s64 p, %1, %3;\n\t"
      "setp.le.and.s64 p, %1, %4, p;\n\t"
      "setp.ge.and.s64 p, %2, %5, p;\n\t"
      "setp.le.and.s64 p, %2, %6, p;\n\t"
      "@p add.u32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "l"(kx), "l"(ky), "l"(q.xlo), "l"(q.xhi), "l"(q.ylo), "l"(q.yhi));
}

// adds 1 to c when the envelope (x.x, x.y) x (y.x, y.y) overlaps box q,
// as count_in does for a point
__device__ __forceinline__ void count_env(unsigned& c, const BoxKeys& q,
                                          longlong2 x, longlong2 y) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.s64 p, %1, %6;\n\t"
      "setp.ge.and.s64 p, %2, %5, p;\n\t"
      "setp.le.and.s64 p, %3, %8, p;\n\t"
      "setp.ge.and.s64 p, %4, %7, p;\n\t"
      "@p add.u32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "l"(x.x), "l"(x.y), "l"(y.x), "l"(y.y), "l"(q.xlo), "l"(q.xhi),
        "l"(q.ylo), "l"(q.yhi));
}

// tile entry t: a point's (x, y) keys, or an envelope's ((x0, x1),
// (y0, y1)) keys in two 16-byte words
template <bool ENV>
__device__ __forceinline__ void count_at(unsigned& c, const BoxKeys& q,
                                         const longlong2* t) {
  if (ENV) {
    count_env(c, q, t[0], t[1]);
  } else {
    const longlong2 v = t[0];
    count_in(c, q, v.x, v.y);
  }
}

// the candidates [t, e) of a tile inside box q: 16-byte loads at immediate
// offsets, 8 compares and a predicated add a candidate
template <bool ENV>
__device__ __forceinline__ unsigned count_run(const BoxKeys& q,
                                              const longlong2* t,
                                              const longlong2* e) {
  constexpr int W = ENV ? 2 : 1;   // 16-byte words a tile entry
  unsigned c = 0u;
  for (; t + 8 * W <= e; t += 8 * W) {
#pragma unroll
    for (int k = 0; k < 8; ++k) count_at<ENV>(c, q, t + k * W);
  }
  for (; t < e; t += W) count_at<ENV>(c, q, t);
  return c;
}

// Phase B: the tile's tn candidates against the launch's nb boxes, one box
// a lane (see the design note); counts added into s_cnt. A warp's lanes
// share their replica when P >= 32, which then takes a contiguous run of
// the tile (every lane loads the same candidate: a broadcast); with fewer
// boxes the lanes of a warp interleave over the tile (consecutive
// candidates: no bank conflict).
template <bool ENV>
__device__ __forceinline__ void test_tile(const longlong2* tile, int tn,
                                          const BoxKeys* boxes, int nb,
                                          unsigned* s_cnt) {
  constexpr int W = ENV ? 2 : 1;   // 16-byte words a tile entry
  int P;   // box slots; THREADS / P replicas split the tile
  if (nb >= THREADS) {
    P = THREADS;
  } else if (nb > 32) {
    P = 64;
    while (P < nb) P <<= 1;
  } else {
    P = nb;
  }
  const int R = THREADS / P;
  const int rep = threadIdx.x / P;
  if (rep >= R) return;
  for (int b = threadIdx.x - rep * P; b < nb; b += P) {
    const BoxKeys q = boxes[b];
    unsigned c = 0u;
    if (P >= 32) {
      c = count_run<ENV>(q, tile + W * (int)((long long)tn * rep / R),
                         tile + W * (int)((long long)tn * (rep + 1) / R));
    } else {
      for (int j = rep; j < tn; j += R) count_at<ENV>(c, q, tile + W * j);
    }
    if (c) atomicAdd(s_cnt + b, c);
  }
}

// box0/ntile: the boxes [box0, box0 + ntile) this launch tests (per_box
// launches; any_box always all of them). smem_boxes: their keys are staged
// in shared memory (always for per_box).
template <bool PER_BOX, bool BLOCKS, bool ENV>
__global__ void __launch_bounds__(THREADS)
box_count_kernel(Params p, int box0, int ntile, bool smem_boxes) {
  constexpr int W = ENV ? 2 : 1;   // 16-byte words a tile entry
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_n[2];    // tile fills, by round parity
  const bool smem_windows = p.nwin <= MAX_SMEM_WINDOWS;
  longlong2* s_tile = reinterpret_cast<longlong2*>(smem);
  BoxKeys* s_box = reinterpret_cast<BoxKeys*>(
      smem + (PER_BOX ? sizeof(longlong2) * W * TILE : 0));
  longlong2* s_win =
      reinterpret_cast<longlong2*>(s_box + (smem_boxes ? ntile : 0));
  unsigned* s_cnt =
      reinterpret_cast<unsigned*>(s_win + (smem_windows ? p.nwin : 0));
  const int ncnt = PER_BOX ? ntile : 1;

  if (smem_windows)
    for (int k = threadIdx.x; k < p.nwin; k += THREADS)
      s_win[k] = window_keys(p.windows + 4 * k);
  if (smem_boxes)
    for (int k = threadIdx.x; k < ntile; k += THREADS)
      s_box[k] = box_keys(p.boxes + 8 * (box0 + k));
  for (int k = threadIdx.x; k < ncnt; k += THREADS) s_cnt[k] = 0u;
  if (threadIdx.x < 2) s_n[threadIdx.x] = 0;
  __syncthreads();
  const longlong2* win = smem_windows ? s_win : nullptr;
  const bool keys = PER_BOX || p.nbox > 0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long rounds = (p.ncand + TILE - 1) / TILE;
  unsigned cnt = 0u;   // any_box: this lane's hits
  int parity = 0;
  for (long long r = blockIdx.x; r < rounds; r += gridDim.x) {
#pragma unroll 1
    for (int s = 0; s < STEPS; ++s) {
      const long long i0 = r * TILE + (long long)(warp * STEPS + s) * 32 * VEC
                           + lane * VEC;
      long long kx[VEC], ky[VEC], kx2[VEC], ky2[VEC];
      unsigned live =
          filter4<BLOCKS, ENV>(p, i0, win, keys, kx, ky, kx2, ky2);
      if (PER_BOX) {
        unsigned m[VEC];
        int tot = 0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          m[k] = __ballot_sync(FULL, (live >> k) & 1u);
          tot += __popc(m[k]);
        }
        if (tot == 0) continue;   // warp-uniform
        int base = 0;
        if (lane == 0) base = atomicAdd(&s_n[parity], tot);
        base = __shfl_sync(FULL, base, 0);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if ((live >> k) & 1u) {
            longlong2* t = s_tile + W * (base + __popc(m[k] & lt));
            if (ENV) {
              t[0] = make_longlong2(kx[k], kx2[k]);
              t[1] = make_longlong2(ky[k], ky2[k]);
            } else {
              t[0] = make_longlong2(kx[k], ky[k]);
            }
          }
          base += __popc(m[k]);
        }
      } else if (live) {
        if (p.nbox == 0) {
          cnt += __popc(live);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            if (!((live >> k) & 1u)) continue;
            for (int b = 0; b < ntile; ++b) {
              const BoxKeys q =
                  smem_boxes ? s_box[b] : box_keys(p.boxes + 8 * b);
              if (ENV ? overlaps(q, kx[k], kx2[k], ky[k], ky2[k])
                      : in_box(q, kx[k], ky[k])) {
                ++cnt;
                break;
              }
            }
          }
        }
      }
    }
    if (PER_BOX) {
      __syncthreads();
      const int tn = s_n[parity];
      // the other parity's fill was last read before the previous round's
      // closing barrier: reset it for the next round
      if (threadIdx.x == 0) s_n[parity ^ 1] = 0;
      test_tile<ENV>(s_tile, tn, s_box, ntile, s_cnt);
      __syncthreads();
      parity ^= 1;
    }
  }
  if (!PER_BOX) {
    cnt = __reduce_add_sync(FULL, cnt);
    if (lane == 0 && cnt) atomicAdd(s_cnt, cnt);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ncnt; k += THREADS) {
    const unsigned c = s_cnt[k];
    if (c) atomicAdd(p.counts + (PER_BOX ? box0 + k : 0), c);
  }
}

template <bool PER_BOX, bool BLOCKS, bool ENV>
cudaError_t launch(const Params& p, int box0, int ntile, bool smem_boxes,
                   int sms, cudaStream_t st) {
  auto kernel = box_count_kernel<PER_BOX, BLOCKS, ENV>;
  const size_t smem =
      (PER_BOX ? sizeof(longlong2) * (ENV ? 2 : 1) * TILE : 0)
      + (smem_boxes ? sizeof(BoxKeys) * ntile : 0)
      + (p.nwin <= MAX_SMEM_WINDOWS ? sizeof(longlong2) * p.nwin : 0)
      + sizeof(unsigned) * (PER_BOX ? ntile : 1);
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
  const long long want = (p.ncand + TILE - 1) / TILE;
  const long long fit = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  kernel<<<grid, THREADS, smem, st>>>(p, box0, ntile, smem_boxes);
  return cudaGetLastError();
}

template <bool PER_BOX, bool ENV>
cudaError_t launch_blocks(const Params& p, int box0, int ntile,
                          bool smem_boxes, int sms, cudaStream_t st) {
  return p.block_ids
             ? launch<PER_BOX, true, ENV>(p, box0, ntile, smem_boxes, sms, st)
             : launch<PER_BOX, false, ENV>(p, box0, ntile, smem_boxes, sms,
                                           st);
}

template <bool PER_BOX>
cudaError_t launch_kind(const Params& p, int box0, int ntile,
                        bool smem_boxes, int sms, cudaStream_t st) {
  return p.xi2 ? launch_blocks<PER_BOX, true>(p, box0, ntile, smem_boxes,
                                              sms, st)
               : launch_blocks<PER_BOX, false>(p, box0, ntile, smem_boxes,
                                               sms, st);
}

bool aligned(const void* ptr, uintptr_t to) {
  return ((uintptr_t)ptr & (to - 1)) == 0;
}

}  // namespace

// Adds the counts of the candidates into `counts` (int32, zeroed by the
// caller on the same stream): nbox counts when per_box, else one. With
// xi2 (and xl2, yi2, yl2) the rows are envelopes: xi..yl hold the min
// planes, xi2..yl2 the max planes. Returns the first CUDA error (0 on
// success).
extern "C" int box_count_launch(const int* xi, const int* xl, const int* yi,
                                const int* yl, const int* xi2,
                                const int* xl2, const int* yi2,
                                const int* yl2, const int* bin, const int* off,
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
  p.xi2 = xi2;
  p.xl2 = xl2;
  p.yi2 = yi2;
  p.yl2 = yl2;
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
  p.vec = aligned(xi, 16) && aligned(xl, 16) && aligned(yi, 16)
          && aligned(yl, 16) && aligned(xi2, 16) && aligned(xl2, 16)
          && aligned(yi2, 16) && aligned(yl2, 16) && aligned(bin, 16)
          && aligned(off, 16)
          && aligned(valid, 4) && aligned(resid, 4);
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
      err = launch_kind<true>(p, box0, ntile, true, sms, st);
      if (err != cudaSuccess) return (int)err;
    }
  } else {
    err = launch_kind<false>(p, 0, nbox, nbox <= MAX_SMEM_BOXES, sms, st);
  }
  return (int)err;
}

// Candidates a CTA takes a round (the per-box tile's capacity).
extern "C" int box_count_tile() { return TILE; }

extern "C" const char* box_count_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
