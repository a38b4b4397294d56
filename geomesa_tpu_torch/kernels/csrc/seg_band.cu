// Certainty-band segment intersects for Hopper (sm_90a): per candidate row
// of the range-pruned blocks of a single-segment line layer, whether its
// segment (sx1, sy1)-(sx2, sy2) certainly intersects a polygon, certainly
// misses it, or sits within the f32 error band of its boundary.
//
// Replaces the XLA program of geomesa_tpu/index/scan.py's ScanKernels mode
// intersects_band_blocks (:754-784): its blocks_mask (:692), _segpair_band
// (:195), _pip_band (:175) and _orient_band (:160), and the nonzero that
// lists the uncertain rows. The result is the reference's int32 vector
//
//     [certain hits, n_uncertain, uncertain rows x unc_cap]
//
// where the rows are the sorted-table positions of the first unc_cap
// uncertain candidates in candidate order, padded with n; n_uncertain counts
// every uncertain candidate, past the cap too.
//
// Candidates: candidate i reads row astart + i % bsz of block
// b = block_ids[i / bsz] (pad -1), astart = clamp(b * bsz, 0, max(0, n - bsz));
// it is live when it belongs to its block (b >= 0 and b * bsz <= row <
// b * bsz + bsz, index/scan.py expand_blocks), its envelope overlaps any box
// (bxmin <= qxhi, bxmax >= qxlo, bymin <= qyhi, bymax >= qylo on the fp62
// planes, compared as the order-preserving int64 keys of box_count.cu), its
// (bin, off) key lies in any window, its residual byte is set and its
// __valid__ byte is set. A live candidate is
//   hit  = in(a) | in(b) | any edge certainly crossed,
//   miss = out(a) & out(b) & every edge a certain miss,
//   uncertain otherwise,
// with in/out the half-open crossing rule of the point-in-polygon band.
//
// Per (segment, edge) pair there are four orientation bands: (a, b, c),
// (a, b, d), (c, d, a), (c, d, b). The last two are the point-in-polygon
// bands of the endpoints a and b against the edge (c, d), so the crossing
// parity of each endpoint reuses them, and |y1 - ay| is |ay - y1|, the
// (c, d, a) band's d2y.
//
// What bounds it on the card: per candidate 4 bytes of block id (amortised
// over bsz candidates), 8 bytes of time planes and the mask bytes, 1 flag
// byte written and read back; per live candidate 32 bytes of envelope
// planes and 16 bytes of segment; per (live candidate, real edge) pair
// 64 f32 operations: 4 x 11 for the orientations and their bounds (d2x,
// d2y, t1, t2, det; |t1| + |t2|, two sums of the |d| terms past the
// hoisted one, two products and the bound's sum), 8 band compares, 4
// compares of the crossing rule's conditions, 2 of |o| <= t, and 2
// subtractions and 4 compares of the vertex ties. Polygons of a few
// edges leave it bound by bytes.
//
// Design (a simple, ordered compaction):
// - Kernel A (classify): a CTA takes chunks of CHUNK = 1024 candidates, a
//   thread ITEMS = 4 of them, strided by the CTA width so that the flag
//   bytes write coalesced. The edges are staged in shared memory with the
//   terms that depend on the edge alone (d1x, d1y, |d1x| + |d1y|, upward);
//   the boxes and windows as keys. Each live candidate walks the edges and
//   writes one flag byte (0 miss or dead, 1 hit, 2 uncertain); each chunk
//   writes its hit and uncertain counts.
// - Kernel B (scan): one CTA turns the chunks' uncertain counts into
//   exclusive offsets, in place, writes the totals and pads the list past
//   min(n_uncertain, unc_cap) with n.
// - Kernel C (write): a CTA takes chunks; its warps ballot the uncertain
//   flags in candidate order and write each one's row at its chunk offset
//   plus its rank, while that stays under unc_cap. Chunks whose offset is
//   past the cap write nothing.
// Kernels A and C read the flags in the same order, so the list comes out
// in candidate order with no sort.
//
// Bit-exactness: every product and sum is written with the round-to-nearest
// intrinsics in the plain version's order, and the build passes
// -fmad=false, so no multiply-add is contracted; the error-bound constants
// arrive as the same f32 values the plain version uses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;                    // candidates a thread a chunk
constexpr int CHUNK = THREADS * ITEMS;      // candidates a chunk
constexpr int MAX_SMEM_EDGES = 1024;        // 32 KB of staged edges
constexpr int MAX_SMEM_BOXES = 256;         // 8 KB of box keys
constexpr int MAX_SMEM_WINDOWS = 256;       // 4 KB of window keys
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const int* env[8];        // bxmin_i, bxmin_l, bymin_i, bymin_l,
                            // bxmax_i, bxmax_l, bymax_i, bymax_l
  const int* bin;           // binned time (null without windows)
  const int* off;
  const uint8_t* valid;     // __valid__ per table row, or null
  const uint8_t* resid;     // residual mask per candidate, or null
  const int* block_ids;     // padded block ids (pad -1)
  long long bsz;
  long long n;              // table rows
  long long ncand;          // blocks * bsz
  const int* windows;       // (nwin, 4)
  int nwin;
  const int* boxes;         // (nbox, 8)
  int nbox;
  const float* sx1;
  const float* sy1;
  const float* sx2;
  const float* sy2;
  const float4* edges;      // real edges only
  int ne;
  float tol_t, tol_d, dy_band;
  uint8_t* flags;           // one byte a candidate
  int* counts;              // per chunk: hits, then uncertain -> offset
  int nchunks;
  int unc_cap;
  int* out;                 // [hits, n_uncertain, rows x unc_cap]
};

struct __align__(16) Edge {
  float4 raw;  // x1, y1, x2, y2
  float4 hz;   // d1x, d1y, |d1x| + |d1y|, upward (1 or 0)
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

__device__ __forceinline__ Edge make_edge(float4 e) {
  const float d1x = __fsub_rn(e.z, e.x);
  const float d1y = __fsub_rn(e.w, e.y);
  Edge out;
  out.raw = e;
  out.hz = make_float4(d1x, d1y, __fadd_rn(fabsf(d1x), fabsf(d1y)),
                       e.w > e.y ? 1.0f : 0.0f);
  return out;
}

// orientation of (p, p + d1, r) with its error bound, d2 = r - p given,
// s1 = |d1x| + |d1y|: det = d1x*d2y - d1y*d2x, tol = tol_t*(|t1| + |t2|)
// + tol_d*(((|d1x| + |d1y|) + |d2x|) + |d2y|)
__device__ __forceinline__ void orient(const Params& p, float d1x, float d1y,
                                       float s1, float d2x, float d2y,
                                       float& det, float& tol) {
  const float t1 = __fmul_rn(d1x, d2y);
  const float t2 = __fmul_rn(d1y, d2x);
  det = __fsub_rn(t1, t2);
  const float sd = __fadd_rn(__fadd_rn(s1, fabsf(d2x)), fabsf(d2y));
  tol = __fadd_rn(__fmul_rn(p.tol_t, __fadd_rn(fabsf(t1), fabsf(t2))),
                  __fmul_rn(p.tol_d, sd));
}

// the live test of candidate i; its table row in `row`
__device__ __forceinline__ bool live_row(const Params& p, long long i,
                                         const BoxKeys* s_box,
                                         const longlong2* s_win,
                                         long long& row) {
  row = 0;
  if (i >= p.ncand) return false;
  const long long blk = i / p.bsz;
  const long long off = i - blk * p.bsz;
  const int b = __ldg(p.block_ids + blk);
  const long long clamp_hi = p.n > p.bsz ? p.n - p.bsz : 0;
  const long long start = (long long)b * p.bsz;
  const long long astart =
      start < 0 ? 0 : (start > clamp_hi ? clamp_hi : start);
  row = astart + off;
  if (b < 0 || row < start || row >= start + p.bsz || row >= p.n)
    return false;
  if (p.resid && !p.resid[i]) return false;
  if (p.valid && !p.valid[row]) return false;
  if (p.nwin > 0) {
    const long long tk = pack62(__ldg(p.bin + row), __ldg(p.off + row));
    bool in = false;
    for (int w = 0; w < p.nwin && !in; ++w) {
      const longlong2 q = w < MAX_SMEM_WINDOWS
                              ? s_win[w] : window_keys(p.windows + 4 * w);
      in = (tk >= q.x) & (tk <= q.y);
    }
    if (!in) return false;
  }
  const long long x0 = pack62(__ldg(p.env[0] + row), __ldg(p.env[1] + row));
  const long long y0 = pack62(__ldg(p.env[2] + row), __ldg(p.env[3] + row));
  const long long x1 = pack62(__ldg(p.env[4] + row), __ldg(p.env[5] + row));
  const long long y1 = pack62(__ldg(p.env[6] + row), __ldg(p.env[7] + row));
  for (int k = 0; k < p.nbox; ++k) {
    const BoxKeys q = k < MAX_SMEM_BOXES ? s_box[k]
                                         : box_keys(p.boxes + 8 * k);
    if ((x0 <= q.xhi) & (x1 >= q.xlo) & (y0 <= q.yhi) & (y1 >= q.ylo))
      return true;
  }
  return false;
}

// a segment's running state across the edges
struct Seg {
  float ax, ay, bx, by;
  float sdx, sdy, ss;       // b - a, |sdx| + |sdy|
  bool par_a, par_b, unc_a, unc_b, any_hit, all_miss;
};

__device__ __forceinline__ void load_seg(const Params& p, long long row,
                                         Seg& s) {
  s.ax = __ldg(p.sx1 + row);
  s.ay = __ldg(p.sy1 + row);
  s.bx = __ldg(p.sx2 + row);
  s.by = __ldg(p.sy2 + row);
  s.sdx = __fsub_rn(s.bx, s.ax);
  s.sdy = __fsub_rn(s.by, s.ay);
  s.ss = __fadd_rn(fabsf(s.sdx), fabsf(s.sdy));
  s.par_a = s.par_b = s.unc_a = s.unc_b = s.any_hit = false;
  s.all_miss = true;
}

__device__ __forceinline__ void pair(const Params& p, const Edge& e, Seg& s) {
  const float x1 = e.raw.x, y1 = e.raw.y, x2 = e.raw.z, y2 = e.raw.w;
  const float d1x = e.hz.x, d1y = e.hz.y, s1 = e.hz.z;
  const bool upward = e.hz.w != 0.0f;
  float o1, t1, o2, t2, o3, t3, o4, t4;
  // (a, b, c) and (a, b, d): the edge's ends against the segment
  orient(p, s.sdx, s.sdy, s.ss, __fsub_rn(x1, s.ax), __fsub_rn(y1, s.ay),
         o1, t1);
  orient(p, s.sdx, s.sdy, s.ss, __fsub_rn(x2, s.ax), __fsub_rn(y2, s.ay),
         o2, t2);
  // (c, d, a) and (c, d, b): the segment's ends against the edge
  const float ay1 = __fsub_rn(s.ay, y1);
  const float by1 = __fsub_rn(s.by, y1);
  orient(p, d1x, d1y, s1, __fsub_rn(s.ax, x1), ay1, o3, t3);
  orient(p, d1x, d1y, s1, __fsub_rn(s.bx, x1), by1, o4, t4);
  const bool p1 = o1 > t1, n1 = o1 < -t1, p2 = o2 > t2, n2 = o2 < -t2;
  const bool p3 = o3 > t3, n3 = o3 < -t3, p4 = o4 > t4, n4 = o4 < -t4;
  const bool opp12 = (p1 & n2) | (n1 & p2);
  const bool opp34 = (p3 & n4) | (n3 & p4);
  const bool same12 = (p1 & p2) | (n1 & n2);
  const bool same34 = (p3 & p4) | (n3 & n4);
  s.any_hit |= opp12 & opp34;
  s.all_miss &= same12 | same34;
  // the endpoints' crossing parity and their ties (half-open rule)
  const bool cond_a = (y1 > s.ay) != (y2 > s.ay);
  const bool cond_b = (y1 > s.by) != (y2 > s.by);
  s.par_a ^= cond_a & (upward ? p3 : n3);
  s.par_b ^= cond_b & (upward ? p4 : n4);
  s.unc_a |= (cond_a & (fabsf(o3) <= t3)) | (fabsf(ay1) <= p.dy_band)
             | (fabsf(__fsub_rn(y2, s.ay)) <= p.dy_band);
  s.unc_b |= (cond_b & (fabsf(o4) <= t4)) | (fabsf(by1) <= p.dy_band)
             | (fabsf(__fsub_rn(y2, s.by)) <= p.dy_band);
}

__device__ __forceinline__ uint8_t verdict(const Seg& s) {
  const bool in_a = s.par_a & !s.unc_a, out_a = !s.par_a & !s.unc_a;
  const bool in_b = s.par_b & !s.unc_b, out_b = !s.par_b & !s.unc_b;
  if (in_a | in_b | s.any_hit) return 1;
  if (out_a & out_b & s.all_miss) return 0;
  return 2;
}

__device__ __forceinline__ void stage_edges(const Params& p, Edge* s_edge,
                                            int e0, int m) {
  for (int k = threadIdx.x; k < m; k += THREADS)
    s_edge[k] = make_edge(__ldg(p.edges + e0 + k));
}

__global__ void __launch_bounds__(THREADS)
classify_kernel(Params p) {
  __shared__ Edge s_edge[MAX_SMEM_EDGES];
  __shared__ BoxKeys s_box[MAX_SMEM_BOXES];
  __shared__ longlong2 s_win[MAX_SMEM_WINDOWS];
  __shared__ int s_cnt[2];
  const int nb = p.nbox < MAX_SMEM_BOXES ? p.nbox : MAX_SMEM_BOXES;
  const int nw = p.nwin < MAX_SMEM_WINDOWS ? p.nwin : MAX_SMEM_WINDOWS;
  for (int k = threadIdx.x; k < nb; k += THREADS)
    s_box[k] = box_keys(p.boxes + 8 * k);
  for (int k = threadIdx.x; k < nw; k += THREADS)
    s_win[k] = window_keys(p.windows + 4 * k);
  const bool staged_once = p.ne <= MAX_SMEM_EDGES;
  if (staged_once) stage_edges(p, s_edge, 0, p.ne);
  __syncthreads();
  const int lane = threadIdx.x & 31;

  for (int c = blockIdx.x; c < p.nchunks; c += gridDim.x) {
    if (threadIdx.x < 2) s_cnt[threadIdx.x] = 0;
    Seg seg[ITEMS];
    bool live[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = (long long)c * CHUNK + k * THREADS + threadIdx.x;
      long long row;
      live[k] = live_row(p, i, s_box, s_win, row);
      if (live[k]) load_seg(p, row, seg[k]);
    }
    for (int e0 = 0; e0 < p.ne; e0 += MAX_SMEM_EDGES) {
      const int m = p.ne - e0 < MAX_SMEM_EDGES ? p.ne - e0 : MAX_SMEM_EDGES;
      if (!staged_once) {
        __syncthreads();
        stage_edges(p, s_edge, e0, m);
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (!live[k]) continue;
        for (int j = 0; j < m; ++j) pair(p, s_edge[j], seg[k]);
      }
    }
    int hits = 0, uncs = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = (long long)c * CHUNK + k * THREADS + threadIdx.x;
      const uint8_t v = live[k] ? verdict(seg[k]) : 0;
      hits += v == 1;
      uncs += v == 2;
      if (i < p.ncand) p.flags[i] = v;
    }
    __syncthreads();   // s_cnt reset before any add
    hits = __reduce_add_sync(FULL, hits);
    uncs = __reduce_add_sync(FULL, uncs);
    if (lane == 0) {
      if (hits) atomicAdd(&s_cnt[0], hits);
      if (uncs) atomicAdd(&s_cnt[1], uncs);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      p.counts[2 * c] = s_cnt[0];
      p.counts[2 * c + 1] = s_cnt[1];
    }
    __syncthreads();   // s_cnt read before the next chunk's reset
  }
}

// one CTA: exclusive offsets of the chunks' uncertain counts (in place),
// the totals, and the list's padding
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(Params p) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  __shared__ long long s_base;
  __shared__ long long s_hits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) { s_base = 0; s_hits = 0; }
  __syncthreads();
  for (int c0 = 0; c0 < p.nchunks; c0 += SCAN_THREADS) {
    const int c = c0 + threadIdx.x;
    const int u = c < p.nchunks ? p.counts[2 * c + 1] : 0;
    const int h = c < p.nchunks ? p.counts[2 * c] : 0;
    int incl = u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    const int hsum = __reduce_add_sync(FULL, h);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < SCAN_THREADS / 32 ? s_warp[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, w, d);
        if (lane >= d) w += v;
      }
      if (lane < SCAN_THREADS / 32) s_warp[lane] = w;   // inclusive
    }
    if (lane == 0) atomicAdd((unsigned long long*)&s_hits,
                             (unsigned long long)hsum);
    __syncthreads();
    const long long before = s_base + (warp > 0 ? s_warp[warp - 1] : 0)
                             + (incl - u);
    if (c < p.nchunks)
      p.counts[2 * c + 1] = before > 0x7fffffffLL ? 0x7fffffff : (int)before;
    __syncthreads();
    if (threadIdx.x == 0) s_base += s_warp[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  const long long total = s_base;
  if (threadIdx.x == 0) {
    p.out[0] = (int)s_hits;
    p.out[1] = (int)total;
  }
  const int filled = total < p.unc_cap ? (int)total : p.unc_cap;
  for (int j = filled + threadIdx.x; j < p.unc_cap; j += SCAN_THREADS)
    p.out[2 + j] = (int)p.n;
}

// writes each uncertain candidate's row at its chunk's offset plus its rank
__global__ void __launch_bounds__(THREADS) write_kernel(Params p) {
  __shared__ int s_warp[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = blockIdx.x; c < p.nchunks; c += gridDim.x) {
    long long base = p.counts[2 * c + 1];
    if (base >= p.unc_cap) continue;   // uniform over the CTA
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = (long long)c * CHUNK + k * THREADS + threadIdx.x;
      const bool u = i < p.ncand && p.flags[i] == 2;
      const unsigned m = __ballot_sync(FULL, u);
      if (lane == 0) s_warp[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int v = s_warp[w];
        before += w < warp ? v : 0;
        total += v;
      }
      if (u) {
        const long long pos =
            base + before + __popc(m & ((1u << lane) - 1u));
        if (pos < p.unc_cap) {
          const long long blk = i / p.bsz;
          const long long off = i - blk * p.bsz;
          const long long start = (long long)__ldg(p.block_ids + blk) * p.bsz;
          const long long clamp_hi = p.n > p.bsz ? p.n - p.bsz : 0;
          const long long astart =
              start < 0 ? 0 : (start > clamp_hi ? clamp_hi : start);
          p.out[2 + pos] = (int)(astart + off);
        }
      }
      base += total;
      __syncthreads();   // s_warp read before the next round's write
    }
  }
}

}  // namespace

// Computes out = [certain hits, n_uncertain, rows x unc_cap] of the
// candidates. `flags` holds one byte a candidate (blocks * bsz) and
// `counts` two ints a chunk of seg_band_chunk() candidates; both are
// scratch the caller allocates. Returns the first CUDA error (0 on
// success).
extern "C" int seg_band_launch(
    const int* bxmin_i, const int* bxmin_l, const int* bymin_i,
    const int* bymin_l, const int* bxmax_i, const int* bxmax_l,
    const int* bymax_i, const int* bymax_l, const int* bin, const int* off,
    const uint8_t* valid, const uint8_t* resid, const int* block_ids,
    long long nblocks, long long bsz, long long n, const int* windows,
    int nwin, const int* boxes, int nbox, const float* sx1, const float* sy1,
    const float* sx2, const float* sy2, const float* edges, int ne,
    float tol_t, float tol_d, float dy_band, uint8_t* flags, int* counts,
    int unc_cap, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  const int* env[8] = {bxmin_i, bxmin_l, bymin_i, bymin_l,
                       bxmax_i, bxmax_l, bymax_i, bymax_l};
  for (int k = 0; k < 8; ++k) p.env[k] = env[k];
  p.bin = bin;
  p.off = off;
  p.valid = valid;
  p.resid = resid;
  p.block_ids = block_ids;
  p.bsz = bsz;
  p.n = n;
  p.ncand = nblocks * bsz;
  p.windows = windows;
  p.nwin = nwin;
  p.boxes = boxes;
  p.nbox = nbox;
  p.sx1 = sx1;
  p.sy1 = sy1;
  p.sx2 = sx2;
  p.sy2 = sy2;
  p.edges = reinterpret_cast<const float4*>(edges);
  p.ne = ne;
  p.tol_t = tol_t;
  p.tol_d = tol_d;
  p.dy_band = dy_band;
  p.flags = flags;
  p.counts = counts;
  p.nchunks = (int)((p.ncand + CHUNK - 1) / CHUNK);
  p.unc_cap = unc_cap;
  p.out = out;
  if (p.nchunks == 0) p.nchunks = 1;   // one empty chunk: zero totals
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      classify_kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long fit = (long long)sms * per_sm;
  const unsigned grid =
      (unsigned)(p.nchunks < fit ? p.nchunks : fit);
  classify_kernel<<<grid, THREADS, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long wfit = (long long)sms * 8;
  write_kernel<<<(unsigned)(p.nchunks < wfit ? p.nchunks : wfit), THREADS, 0,
                 st>>>(p);
  return (int)cudaGetLastError();
}

// Candidates a chunk takes (the scratch `counts` holds two ints a chunk).
extern "C" int seg_band_chunk() { return CHUNK; }

extern "C" const char* seg_band_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
