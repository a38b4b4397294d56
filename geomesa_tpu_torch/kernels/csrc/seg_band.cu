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
// over bsz candidates), 8 bytes of time planes and the mask bytes; per live
// candidate 32 bytes of envelope planes and 16 bytes of segment; per (live
// candidate, real edge) pair 64 f32 operations: 4 x 11 for the orientations
// and their bounds (d2x, d2y, t1, t2, det; |t1| + |t2|, two sums of the |d|
// terms past the hoisted one, two products and the bound's sum), 8 band
// compares, 4 compares of the crossing rule's conditions, 2 of |o| <= t,
// and 2 subtractions and 4 compares of the vertex ties. Polygons of a few
// edges leave it bound by bytes.
//
// Design: one launch a call, an ordered compaction by decoupled look-back.
// - A CTA takes chunks of CHUNK = 1024 candidates by an atomic ticket, so
//   chunks start in candidate order; a thread holds ITEMS = 4 of a chunk's
//   candidates, strided by the CTA width so that a warp's plane loads
//   coalesce. The live tests and segment loads of the four go first (their
//   loads overlap), then each live one walks the edges alone, so one
//   segment's running state is in registers at a time (at most 64
//   registers a thread: four CTAs an SM; past STAGE_EDGES a segment loads
//   at its turn, so that nothing spills).
// - The block of a chunk's first candidate is one division a chunk (by
//   thread 0); a candidate's block follows by a shift (a power-of-two bsz),
//   one compare (bsz >= CHUNK: a chunk spans at most two blocks) or a 32-bit
//   division of a number under 2 * CHUNK.
// - The chunk's uncertain rows are ranked in candidate order by a CTA-wide
//   ballot scan. The chunk publishes its uncertain count in a status word
//   of its own (aggregate), warp 0 sums its predecessors' words from the
//   nearest back until one holds an inclusive prefix (32 a step), and the
//   chunk publishes its inclusive prefix. Its rows go straight from
//   registers to out at the exclusive prefix plus their rank; a chunk at or
//   past unc_cap writes nothing. No flag or count goes to device memory.
// - A chunk stops looking back once its sum reaches unc_cap: it writes
//   nothing, and the prefix it publishes is a lower bound that is itself
//   at least unc_cap, so every chunk that still writes sums exact values
//   (where uncertain rows abound, no chunk waits on a long chain).
// - A status word is epoch (32 bits) | prefix flag | value (31 bits); the
//   wrapper passes a new epoch each call, so words of earlier calls read as
//   unpublished and the workspace needs no memset between calls.
// - Hits and uncertain counts add to workspace totals, one atomic a CTA.
//   The last CTA to finish writes out[0], out[1], pads the list with n, and
//   zeroes the ticket, the done counter and the totals for the next call.
// - Shared memory is sized to the call: the real edges (with the terms
//   that depend on the edge alone: d1x, d1y, |d1x| + |d1y|, upward), boxes
//   and windows as keys. Past STAGE_EDGES edges the table streams through
//   two tiles of TILE_EDGES by cp.async, the next tile landing while the
//   pairs of the current one run.
//
// Bit-exactness: every product and sum is written with the round-to-nearest
// intrinsics in the plain version's order, and the build passes
// -fmad=false, so no multiply-add is contracted; the error-bound constants
// arrive as the same f32 values the plain version uses.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;                    // candidates a thread a chunk
constexpr int CHUNK = THREADS * ITEMS;      // candidates a chunk
constexpr int MIN_CTAS = 4;                 // CTAs an SM: <= 64 registers
constexpr int STAGE_EDGES = 1024;           // edges staged once (32 KB)
constexpr int TILE_EDGES = 512;             // a streamed tile (16 KB)
constexpr int MAX_SMEM_BOXES = 256;         // 8 KB of box keys
constexpr int MAX_SMEM_WINDOWS = 256;       // 4 KB of window keys
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
constexpr unsigned long long PREFIX = 1ull << 31;
constexpr unsigned long long VALUE_MAX = 0x7fffffffull;

enum BszMode { BSZ_SHIFT = 0, BSZ_WRAP = 1, BSZ_DIV = 2 };

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
  int bsz_mode;
  int bsz_shift;
  const int* windows;       // (nwin, 4)
  int nwin;
  const int* boxes;         // (nbox, 8)
  int nbox;
  int sb, sw;               // boxes and windows held in shared memory
  const float* sx1;
  const float* sy1;
  const float* sx2;
  const float* sy2;
  const float4* edges;      // real edges only
  int ne;
  float tol_t, tol_d, dy_band;
  int nchunks;
  int unc_cap;
  int* out;                 // [hits, n_uncertain, rows x unc_cap]
  unsigned* ticket;         // workspace: chunk ticket, CTAs done,
  unsigned* done;
  unsigned long long* hits; // the totals,
  unsigned long long* uncs;
  unsigned long long* status;  // and one status word a chunk
  unsigned epoch;
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

__device__ __forceinline__ float4 edge_terms(float4 e) {
  const float d1x = __fsub_rn(e.z, e.x);
  const float d1y = __fsub_rn(e.w, e.y);
  return make_float4(d1x, d1y, __fadd_rn(fabsf(d1x), fabsf(d1y)),
                     e.w > e.y ? 1.0f : 0.0f);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
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

// the live test of candidate i, in block slot blk at offset off; its table
// row in `row`
__device__ __forceinline__ bool live_row(const Params& p, long long i,
                                         long long blk, long long off,
                                         const BoxKeys* s_box,
                                         const longlong2* s_win, int& row) {
  row = 0;
  if (i >= p.ncand) return false;
  const int b = __ldg(p.block_ids + blk);
  const long long clamp_hi = p.n > p.bsz ? p.n - p.bsz : 0;
  const long long start = (long long)b * p.bsz;
  const long long astart =
      start < 0 ? 0 : (start > clamp_hi ? clamp_hi : start);
  const long long r = astart + off;
  row = (int)r;
  if (b < 0 || r < start || r >= start + p.bsz || r >= p.n) return false;
  if (p.resid && !p.resid[i]) return false;
  if (p.valid && !p.valid[r]) return false;
  if (p.nwin > 0) {
    const long long tk = pack62(__ldg(p.bin + r), __ldg(p.off + r));
    bool in = false;
    for (int w = 0; w < p.nwin && !in; ++w) {
      const longlong2 q = w < p.sw ? s_win[w] : window_keys(p.windows + 4 * w);
      in = (tk >= q.x) & (tk <= q.y);
    }
    if (!in) return false;
  }
  const long long x0 = pack62(__ldg(p.env[0] + r), __ldg(p.env[1] + r));
  const long long y0 = pack62(__ldg(p.env[2] + r), __ldg(p.env[3] + r));
  const long long x1 = pack62(__ldg(p.env[4] + r), __ldg(p.env[5] + r));
  const long long y1 = pack62(__ldg(p.env[6] + r), __ldg(p.env[7] + r));
  for (int k = 0; k < p.nbox; ++k) {
    const BoxKeys q = k < p.sb ? s_box[k] : box_keys(p.boxes + 8 * k);
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

__device__ __forceinline__ void start_seg(float4 c, Seg& s) {
  s.ax = c.x;
  s.ay = c.y;
  s.bx = c.z;
  s.by = c.w;
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

// 0 miss, 1 hit, 2 uncertain
__device__ __forceinline__ int verdict(const Seg& s) {
  const bool in_a = s.par_a & !s.unc_a, out_a = !s.par_a & !s.unc_a;
  const bool in_b = s.par_b & !s.unc_b, out_b = !s.par_b & !s.unc_b;
  if (in_a | in_b | s.any_hit) return 1;
  if (out_a & out_b & s.all_miss) return 0;
  return 2;
}

// issues the cp.async copies of tile t's raw edges into buf (this thread's
// share: edges threadIdx.x, threadIdx.x + THREADS, ...)
__device__ __forceinline__ void issue_tile(const Params& p, Edge* buf,
                                           int t) {
  const int e0 = t * TILE_EDGES;
  const int m = p.ne - e0 < TILE_EDGES ? p.ne - e0 : TILE_EDGES;
  for (int k = threadIdx.x; k < m; k += THREADS)
    cp_async16(&buf[k].raw, p.edges + e0 + k);
}

// the edge-only terms of this thread's share of a landed tile
__device__ __forceinline__ void finish_tile(const Params& p, Edge* buf,
                                            int t) {
  const int e0 = t * TILE_EDGES;
  const int m = p.ne - e0 < TILE_EDGES ? p.ne - e0 : TILE_EDGES;
  for (int k = threadIdx.x; k < m; k += THREADS)
    buf[k].hz = edge_terms(buf[k].raw);
}

__device__ __forceinline__ float4 load_seg(const Params& p, int r) {
  return make_float4(__ldg(p.sx1 + r), __ldg(p.sy1 + r), __ldg(p.sx2 + r),
                     __ldg(p.sy2 + r));
}

// verdicts of a thread's ITEMS candidates over every edge. STAGED: the
// whole table sits in s_edge, and the segments were loaded with the live
// tests; else it streams through two tiles, every thread of the CTA taking
// part in each step (the loop bounds are uniform), and each segment loads
// when its turn comes (four held across the tiles would spill).
template <bool STAGED>
__device__ __forceinline__ void classify(const Params& p, Edge* s_edge,
                                         const bool (&live)[ITEMS],
                                         const float4 (&seg)[ITEMS],
                                         const int (&row)[ITEMS],
                                         int (&v)[ITEMS]) {
  if constexpr (STAGED) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      v[k] = 0;
      if (!live[k]) continue;
      Seg s;
      start_seg(seg[k], s);
      for (int j = 0; j < p.ne; ++j) pair(p, s_edge[j], s);
      v[k] = verdict(s);
    }
    return;
  }
  const int ntiles = (p.ne + TILE_EDGES - 1) / TILE_EDGES;
  int g = 0;   // pipeline step: (item, tile) in order
  issue_tile(p, s_edge, 0);
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    Seg s;
    if (live[k]) start_seg(load_seg(p, row[k]), s);
    for (int t = 0; t < ntiles; ++t, ++g) {
      Edge* cur = s_edge + (g & 1) * TILE_EDGES;
      if (k + 1 < ITEMS || t + 1 < ntiles)
        issue_tile(p, s_edge + ((g + 1) & 1) * TILE_EDGES,
                   t + 1 < ntiles ? t + 1 : 0);
      cp_async_commit();
      cp_async_wait_one();   // this thread's copies of step g landed
      finish_tile(p, cur, t);
      __syncthreads();       // ... and every thread's, with their terms
      if (live[k]) {
        const int m = p.ne - t * TILE_EDGES < TILE_EDGES
                          ? p.ne - t * TILE_EDGES : TILE_EDGES;
        for (int j = 0; j < m; ++j) pair(p, cur[j], s);
      }
      __syncthreads();       // cur is refilled at step g + 2
    }
    v[k] = live[k] ? verdict(s) : 0;
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
seg_band_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Edge* s_edge = reinterpret_cast<Edge*>(smem);
  BoxKeys* s_box = reinterpret_cast<BoxKeys*>(
      s_edge + (STAGED ? p.ne : 2 * TILE_EDGES));
  longlong2* s_win = reinterpret_cast<longlong2*>(s_box + p.sb);
  __shared__ int s_unc[ITEMS][WARPS];
  __shared__ int s_hit[WARPS];
  __shared__ int s_chunk;
  __shared__ long long s_blk0, s_off0, s_excl;
  __shared__ bool s_last;
  __shared__ unsigned long long s_tot[2];

  for (int k = threadIdx.x; k < p.sb; k += THREADS)
    s_box[k] = box_keys(p.boxes + 8 * k);
  for (int k = threadIdx.x; k < p.sw; k += THREADS)
    s_win[k] = window_keys(p.windows + 4 * k);
  if (STAGED) {
    for (int k = threadIdx.x; k < p.ne; k += THREADS) {
      const float4 e = __ldg(p.edges + k);
      s_edge[k].raw = e;
      s_edge[k].hz = edge_terms(e);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long cta_hits = 0, cta_uncs = 0;   // thread 0's

  for (;;) {
    if (threadIdx.x == 0) {
      const int c = (int)atomicAdd(p.ticket, 1u);
      s_chunk = c;
      if (c < p.nchunks) {
        const long long base = (long long)c * CHUNK;
        const long long b0 =
            p.bsz_mode == BSZ_SHIFT ? base >> p.bsz_shift : base / p.bsz;
        s_blk0 = b0;
        s_off0 = base - b0 * p.bsz;
      }
    }
    __syncthreads();   // also: the staged tables, the previous chunk's reads
    const int c = s_chunk;
    if (c >= p.nchunks) break;   // uniform over the CTA
    const long long base = (long long)c * CHUNK;
    const long long blk0 = s_blk0, off0 = s_off0;

    bool live[ITEMS];
    float4 seg[ITEMS];
    int row[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int local = k * THREADS + threadIdx.x;
      long long blk = blk0, off = off0 + local;
      if (p.bsz_mode == BSZ_SHIFT) {
        blk += off >> p.bsz_shift;
        off &= p.bsz - 1;
      } else if (p.bsz_mode == BSZ_WRAP) {
        if (off >= p.bsz) { ++blk; off -= p.bsz; }
      } else {
        const unsigned q = (unsigned)off / (unsigned)p.bsz;
        blk += q;
        off -= (long long)q * p.bsz;
      }
      live[k] = live_row(p, base + local, blk, off, s_box, s_win, row[k]);
      seg[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (STAGED && live[k]) seg[k] = load_seg(p, row[k]);
    }
    int v[ITEMS];
    classify<STAGED>(p, s_edge, live, seg, row, v);

    // rank the uncertain candidates in candidate order (item, then thread)
    int hits = 0;
    unsigned um[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      hits += v[k] == 1;
      um[k] = __ballot_sync(FULL, v[k] == 2);
      if (lane == 0) s_unc[k][warp] = __popc(um[k]);
    }
    hits = __reduce_add_sync(FULL, hits);
    if (lane == 0) s_hit[warp] = hits;
    __syncthreads();
    int agg = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
#pragma unroll
      for (int w = 0; w < WARPS; ++w) agg += s_unc[k][w];

    // decoupled look-back: publish the aggregate, sum the predecessors'
    // words back to the nearest inclusive prefix, publish the prefix
    if (warp == 0) {
      const unsigned long long tag = (unsigned long long)p.epoch << 32;
      if (lane == 0)
        store_status(p.status + c,
                     tag | (c == 0 ? PREFIX : 0ull) | (unsigned)agg);
      long long excl = 0;
      long long j0 = (long long)c - 1;
      while (j0 >= 0 && excl < p.unc_cap) {
        const long long j = j0 - lane;
        const unsigned long long s =
            j >= 0 ? load_status(p.status + j) : (tag | PREFIX);
        const bool ok = (unsigned)(s >> 32) == p.epoch;
        const unsigned okm = __ballot_sync(FULL, ok);
        const unsigned prem = __ballot_sync(FULL, ok && (s & PREFIX));
        const int first = prem ? __ffs(prem) - 1 : 31;
        const unsigned need = first == 31 ? FULL : (2u << first) - 1u;
        if ((okm & need) != need) {   // a predecessor has not published
          __nanosleep(20);
          continue;
        }
        long long val = lane <= first ? (long long)(s & VALUE_MAX) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          val += __shfl_xor_sync(FULL, val, d);
        excl += val;
        if (prem) break;
        j0 -= 32;
      }
      if (lane == 0) {
        if (c > 0) {
          const long long incl = excl + agg;
          store_status(p.status + c,
                       tag | PREFIX
                           | (unsigned long long)(incl < (long long)VALUE_MAX
                                                      ? incl : VALUE_MAX));
        }
        s_excl = excl;
        int h = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) h += s_hit[w];
        cta_hits += (unsigned)h;
        cta_uncs += (unsigned)agg;
      }
    }
    __syncthreads();
    const long long excl = s_excl;
    if (excl < p.unc_cap) {   // uniform over the CTA
      long long pos = excl;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        int before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const int u = s_unc[k][w];
          before += w < warp ? u : 0;
          total += u;
        }
        if (v[k] == 2) {
          const long long at =
              pos + before + __popc(um[k] & ((1u << lane) - 1u));
          if (at < p.unc_cap) p.out[2 + at] = row[k];
        }
        pos += total;
      }
    }
  }

  // the totals; the last CTA to finish writes them, pads the list and
  // zeroes the workspace for the next call
  if (threadIdx.x == 0) {
    if (cta_hits) atomicAdd(p.hits, cta_hits);
    if (cta_uncs) atomicAdd(p.uncs, cta_uncs);
    __threadfence();
    const bool last = atomicAdd(p.done, 1u) == gridDim.x - 1;
    s_last = last;
    if (last) {
      __threadfence();
      s_tot[0] = atomicAdd(p.hits, 0ull);
      s_tot[1] = atomicAdd(p.uncs, 0ull);
      *p.hits = 0ull;
      *p.uncs = 0ull;
      *p.ticket = 0u;
      *p.done = 0u;
    }
  }
  __syncthreads();
  if (!s_last) return;
  const unsigned long long total = s_tot[1];
  if (threadIdx.x == 0) {
    p.out[0] = (int)s_tot[0];
    p.out[1] = (int)total;
  }
  const int filled =
      total < (unsigned long long)p.unc_cap ? (int)total : p.unc_cap;
  for (int j = filled + threadIdx.x; j < p.unc_cap; j += THREADS)
    p.out[2 + j] = (int)p.n;
}

// per device, read at its first call: SMs, shared memory, and each
// kernel's static shared memory and resident CTAs an SM (no shared memory)
struct DevInfo {
  int sms, smem_sm, reserved;
  int static_smem[2], occ[2];
};
DevInfo g_info[MAX_DEVICES];
std::atomic<int> g_ready[MAX_DEVICES];

cudaError_t device_info(int dev, DevInfo& out) {
  DevInfo d;
  cudaError_t err;
  if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(
           &d.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev))
      != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(
           &d.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev))
      != cudaSuccess)
    return err;
  const void* kernels[2] = {
      reinterpret_cast<const void*>(seg_band_kernel<false>),
      reinterpret_cast<const void*>(seg_band_kernel<true>)};
  for (int k = 0; k < 2; ++k) {
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kernels[k])) != cudaSuccess)
      return err;
    d.static_smem[k] = (int)fa.sharedSizeBytes;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &d.occ[k], kernels[k], THREADS, 0)) != cudaSuccess)
      return err;
    if (d.occ[k] < 1) return cudaErrorInvalidConfiguration;
  }
  out = d;
  return cudaSuccess;
}

}  // namespace

// The launch's arguments as the wrapper packs them (kernels/seg_band.py
// _ARGS): 8-byte slots (pointers, 0 for none), then the f32 constants.
struct SegBandArgs {
  long long env[8];
  long long bin, off, valid, resid, block_ids;
  long long nblocks, bsz, n;
  long long windows, nwin;
  long long boxes, nbox;
  long long seg[4];
  long long edges, ne;
  long long unc_cap;
  long long out, ws, ws_chunks, epoch, device;
  float tol_t, tol_d, dy_band, pad;
};
static_assert(sizeof(SegBandArgs) == 32 * 8 + 4 * 4,
              "SegBandArgs must match _ARGS");

// Computes out = [certain hits, n_uncertain, rows x unc_cap] of the
// candidates in one launch on `stream`, on device a->device (the current
// device). a->ws: the workspace of this stream, 4 + a->ws_chunks 64-bit
// words, zero when first made and left for the next call as the kernel
// found it; calls that share it must be ordered (one stream), each with a
// new nonzero a->epoch. Returns the first CUDA error (0 on success).
extern "C" int seg_band_launch(const SegBandArgs* a, void* stream) {
  const int dev = (int)a->device;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_ready[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = device_info(dev, g_info[dev]);
    if (err != cudaSuccess) return (int)err;
    g_ready[dev].store(1, std::memory_order_release);
  }
  const DevInfo& d = g_info[dev];
  Params p;
  for (int k = 0; k < 8; ++k)
    p.env[k] = reinterpret_cast<const int*>(a->env[k]);
  p.bin = reinterpret_cast<const int*>(a->bin);
  p.off = reinterpret_cast<const int*>(a->off);
  p.valid = reinterpret_cast<const uint8_t*>(a->valid);
  p.resid = reinterpret_cast<const uint8_t*>(a->resid);
  p.block_ids = reinterpret_cast<const int*>(a->block_ids);
  p.bsz = a->bsz;
  p.n = a->n;
  p.ncand = a->nblocks * a->bsz;
  if (p.bsz <= 0) return (int)cudaErrorInvalidValue;
  p.bsz_shift = 0;
  if ((p.bsz & (p.bsz - 1)) == 0) {
    p.bsz_mode = BSZ_SHIFT;
    while ((1ll << p.bsz_shift) < p.bsz) ++p.bsz_shift;
  } else {
    p.bsz_mode = p.bsz >= CHUNK ? BSZ_WRAP : BSZ_DIV;
  }
  p.windows = reinterpret_cast<const int*>(a->windows);
  p.nwin = (int)a->nwin;
  p.boxes = reinterpret_cast<const int*>(a->boxes);
  p.nbox = (int)a->nbox;
  p.sb = p.nbox < MAX_SMEM_BOXES ? p.nbox : MAX_SMEM_BOXES;
  p.sw = p.nwin < MAX_SMEM_WINDOWS ? p.nwin : MAX_SMEM_WINDOWS;
  p.sx1 = reinterpret_cast<const float*>(a->seg[0]);
  p.sy1 = reinterpret_cast<const float*>(a->seg[1]);
  p.sx2 = reinterpret_cast<const float*>(a->seg[2]);
  p.sy2 = reinterpret_cast<const float*>(a->seg[3]);
  p.edges = reinterpret_cast<const float4*>(a->edges);
  p.ne = (int)a->ne;
  p.tol_t = a->tol_t;
  p.tol_d = a->tol_d;
  p.dy_band = a->dy_band;
  const long long nchunks = (p.ncand + CHUNK - 1) / CHUNK;
  if (nchunks > a->ws_chunks || nchunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.nchunks = (int)nchunks;
  p.unc_cap = (int)a->unc_cap;
  p.out = reinterpret_cast<int*>(a->out);
  unsigned long long* ws = reinterpret_cast<unsigned long long*>(a->ws);
  p.ticket = reinterpret_cast<unsigned*>(ws);
  p.done = p.ticket + 1;
  p.hits = ws + 1;
  p.uncs = ws + 2;
  p.status = ws + 4;
  p.epoch = (unsigned)a->epoch;
  if (p.epoch == 0) return (int)cudaErrorInvalidValue;

  const bool staged = p.ne <= STAGE_EDGES;
  const size_t smem = sizeof(Edge) * (staged ? p.ne : 2 * TILE_EDGES)
                      + sizeof(BoxKeys) * p.sb + sizeof(longlong2) * p.sw;
  const int k = staged ? 1 : 0;
  const long long per_block = (long long)smem + d.static_smem[k] + d.reserved;
  long long per_sm = d.smem_sm / per_block;
  if (per_sm > d.occ[k]) per_sm = d.occ[k];
  if (per_sm < 1) per_sm = 1;
  long long grid = (long long)d.sms * per_sm;
  if (grid > nchunks) grid = nchunks;
  if (grid < 1) grid = 1;   // no candidates: one CTA writes the zeros
  cudaStream_t st = (cudaStream_t)stream;
  if (staged)
    seg_band_kernel<true><<<(unsigned)grid, THREADS, smem, st>>>(p);
  else
    seg_band_kernel<false><<<(unsigned)grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// Candidates a chunk takes (the workspace holds one status word a chunk).
extern "C" int seg_band_chunk() { return CHUNK; }

extern "C" const char* seg_band_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
