// Haversine distance and an ordered top-m for Hopper (sm_90a): the m
// candidates nearest a query point, ascending by (f32 distance, position).
//
// Replaces the XLA programs of geomesa_tpu/index/scan.py's KNN modes — mode
// "topk" (:809, over the table's rows) and mode "topk_blocks" (:737, over
// the gathered candidate blocks of a range cover) — each
// _haversine_f32 (:211) of every candidate, +inf where the scan mask is
// unset, then lax.top_k(-d, m): the m smallest distances, equal ones lower
// candidate first (also among the +inf past the matches), as (distances f32,
// positions int32). FULL: candidate i is row i. BLOCKS: candidate i is row
// starts[i / bsz] + i % bsz, and that row is its position.
//
// The distance is the reference's, one f32 operation at a time
// (-fmad=false, __f*_rn): la1 = lat * rad, la2 = qlat * rad, dla = (qlat -
// lat) * rad, dlo = (qlon - lon) * rad, a = sin(dla / 2)^2 + (cos(la1) *
// cos(la2)) * sin(dlo / 2)^2, d = 2R * asin(sqrt(clip(a, 0, 1))), with
// cos(la2) computed once a thread (the same cosf of the same f32, so the
// same bits as the plain version's). CUDA's sinf/cosf/asinf are not XLA's
// CPU functions, so the distances agree with the reference within a
// tolerance (the tests state it), and with the plain version on the card
// bit for bit.
//
// What bounds it on the card: bytes — each candidate's mask byte and the 8
// bytes of coordinates of each candidate whose mask is set. Over 100M set
// rows the keys pass is bound instead by the haversine's instructions (two
// sinf, a cosf, an asinf and a square root a row, CUDA's accurate ones),
// the floor of this design; a cluster call over a sparse cover by latency.
//
// Design. A candidate's composite is (key << 32 | candidate), key the bits
// of its f32 distance (ascending with it, since d >= +0), 0x7f800000 (+inf)
// where the mask is unset and 0x7fffffff for a NaN distance (after +inf, as
// the plain version's stable sort puts NaN). Composites are distinct and
// their order is the output's order, ties and the +inf tail included, so
// the top-m is a radix select on 64-bit composites, 12 bits a level, ended
// as soon as the composites under the selected prefix and below it fit one
// sort (EMIT = max(2 m, 1024), at most CAP), then one bitonic sort.
// - Both routes walk the candidates coalesced (`each_quad`): a lane loads
//   16 mask bytes in one 16-byte load and takes four quads of consecutive
//   candidates 128 apart, so coordinates, keys and columns move 512
//   contiguous bytes a warp.
// - The one-cluster route (the wrapper's choice: a BLOCKS call of at most
//   2^20 candidates, cfg4's cover of 1,048,576, a FULL call of
//   at most CLUSTER x CAPC): one launch of one cluster of 16
//   CTAs x 512 threads, no global scratch, no fill, no host sync. One pass
//   over the mask lists each CTA's set candidates (up to CAPC), whose keys
//   all its threads then compute at once (their loads in flight
//   together); the unset ones are (+inf, candidate) composites, counted,
//   and walked from the mask again only where the select reaches the +inf
//   keys. Each CTA histograms a level's digit in shared memory (a run of
//   equal digits one atomic) and adds its bins into CTA 0's by distributed
//   shared memory; CTA 0 selects the digit. The emission sends the
//   composites at or below the prefix into CTA 0's shared memory, which
//   sorts them and writes the m. A CTA with more than CAPC set candidates
//   makes every pass compute its keys again from the mask.
// - The grid route (larger counts, FULL over 100M rows): the keys pass
//   (every SM, the per-query cos(la2) hoisted, coordinates as float4 where
//   aligned) writes each candidate's key once and histograms its top digit;
//   its last CTA (a ticket) selects the digit. Up to four level passes
//   follow, each one read of the keys: the first that finds at most
//   BUF_CAP composites under the prefix sends those below it straight to
//   the pairs (fewer than m) and compacts those in it into a buffer; until
//   then a pass histograms the next digit and its last CTA selects (over
//   100M set rows the first level pass compacts; the others exit at once).
//   The one-cluster kernel then finishes the select over the buffer, adds
//   the pairs and sorts. Six launches, no fill: the per-stream workspace
//   (histogram, ticket, state) is zero between calls, each kernel zeroing
//   what it used.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_M = 4096;
constexpr unsigned KEY_INF = 0x7f800000u;   // a candidate whose mask is unset
constexpr unsigned KEY_NAN = 0x7fffffffu;   // a NaN distance
constexpr int DIGIT = 12;                   // bits a radix level
constexpr int NB = 1 << DIGIT;              // bins a level
constexpr int CLUSTER = 16;                 // CTAs of the one cluster
constexpr int CTHREADS = 512;               // threads a cluster CTA
constexpr int CAP = 8192;                   // composites of the final sort
constexpr int CAPC = 6144;                  // set candidates a cluster CTA lists
constexpr int GTHREADS = 256;               // threads a grid CTA
constexpr int LEVEL_PASSES = 4;             // grid passes after the keys
constexpr unsigned BUF_CAP = 1u << 20;      // composites the grid hands over
constexpr int MAX_DEVICES = 64;
constexpr int NO_CLUSTER = 100000;          // the cluster does not fit

enum Src { SRC_FULL = 0, SRC_BLOCKS = 1, SRC_BUF = 2 };

// the grid route's workspace, zero between calls
struct Ws {
  unsigned hist[NB];          // a level's bins
  unsigned ticket;            // CTAs done with the pass
  unsigned handed;            // the buffer holds the prefix's composites
  unsigned npairs;            // composites below the prefix, in `pairs`
  unsigned nbuf;              // composites under the prefix, in `buf`
  unsigned long long prefix;  // the selected prefix, `bits` wide
  unsigned bits;
  unsigned below;             // composites below the prefix
  unsigned count;             // composites under it
  unsigned pad[7];
};
static_assert(sizeof(Ws) % 16 == 0, "the pairs follow the header");

struct Params {
  const float* xf;
  const float* yf;
  const uint8_t* mask;          // one byte a candidate
  const long long* starts;      // BLOCKS: first row of each block
  long long bsz;                // BLOCKS: rows a block
  unsigned n;                   // candidates
  unsigned head;                // scalar candidates before the vectors
  unsigned nvec;                // 16-candidate vectors from `head`
  unsigned nscalar;             // head + the tail after the vectors
  int vec_xy;                   // FULL with 16-byte aligned coordinates
  float qx, qy;                 // the query point (f32)
  float rad;                    // f32(pi / 180)
  float two_r;                  // f32(2 * 6371008.8)
  int m;
  unsigned* keys;               // grid route: n keys, keys + head aligned
  Ws* ws;                       // grid route
  unsigned long long* pairs;    // grid route: MAX_M
  unsigned long long* buf;      // grid route: BUF_CAP
  float* dist;                  // m, out
  int* pos;                     // m, out
};

__device__ __forceinline__ unsigned long long comp(unsigned key, unsigned i) {
  return ((unsigned long long)key << 32) | i;
}

// the reference's _haversine_f32 of one set candidate, as its key
__device__ __forceinline__ unsigned key_of(float lon, float lat, float cq,
                                           const Params& p) {
  const float la1 = __fmul_rn(lat, p.rad);
  const float dla = __fmul_rn(__fsub_rn(p.qy, lat), p.rad);
  const float dlo = __fmul_rn(__fsub_rn(p.qx, lon), p.rad);
  const float s1 = sinf(__fmul_rn(dla, 0.5f));
  const float s2 = sinf(__fmul_rn(dlo, 0.5f));
  float a = __fadd_rn(__fmul_rn(s1, s1),
                      __fmul_rn(__fmul_rn(cosf(la1), cq), __fmul_rn(s2, s2)));
  a = a < 0.0f ? 0.0f : (a > 1.0f ? 1.0f : a);   // NaN stays NaN
  const float d = __fmul_rn(p.two_r, asinf(__fsqrt_rn(a)));
  return d != d ? KEY_NAN : __float_as_uint(d);
}

// candidate i's row: i itself, or through the block starts
template <bool BLOCKS>
__device__ __forceinline__ long long row_of(const Params& p, unsigned i) {
  if (!BLOCKS) return i;
  const unsigned long long b = (unsigned long long)i / (unsigned long long)p.bsz;
  return p.starts[b] + (long long)(i - b * p.bsz);
}

// the rows of consecutive candidates from i0, one division for all
template <bool BLOCKS>
struct Walk {
  long long b, off;
  __device__ __forceinline__ Walk(const Params& p, unsigned i0) {
    b = BLOCKS ? (long long)i0 / p.bsz : 0;
    off = BLOCKS ? (long long)i0 - b * p.bsz : (long long)i0;
  }
  __device__ __forceinline__ long long row(const Params& p) const {
    return BLOCKS ? p.starts[b] + off : off;
  }
  __device__ __forceinline__ void next(const Params& p) {
    ++off;
    if (BLOCKS && off == p.bsz) {
      off = 0;
      ++b;
    }
  }
};

// the keys of the four candidates i0..i0+3 with mask bytes w (one byte
// each), the walk advanced past them
template <bool BLOCKS>
__device__ __forceinline__ uint4 quad_keys(const Params& p, float cq,
                                           unsigned i0, unsigned w,
                                           Walk<BLOCKS>& walk) {
  unsigned k[4] = {KEY_INF, KEY_INF, KEY_INF, KEY_INF};
  if (!BLOCKS && p.vec_xy) {
    if (w) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p.xf + i0));
      const float4 y = __ldg(reinterpret_cast<const float4*>(p.yf + i0));
      if (w & 0xffu) k[0] = key_of(x.x, y.x, cq, p);
      if (w & 0xff00u) k[1] = key_of(x.y, y.y, cq, p);
      if (w & 0xff0000u) k[2] = key_of(x.z, y.z, cq, p);
      if (w & 0xff000000u) k[3] = key_of(x.w, y.w, cq, p);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if ((w >> (8 * r)) & 0xffu) {
        const long long row = walk.row(p);
        k[r] = key_of(__ldg(p.xf + row), __ldg(p.yf + row), cq, p);
      }
      walk.next(p);
    }
  }
  return make_uint4(k[0], k[1], k[2], k[3]);
}

// the key of one candidate (the scalar head and tail)
template <bool BLOCKS>
__device__ __forceinline__ unsigned cand_key(const Params& p, float cq,
                                             unsigned i) {
  if (!p.mask[i]) return KEY_INF;
  const long long row = row_of<BLOCKS>(p, i);
  return key_of(__ldg(p.xf + row), __ldg(p.yf + row), cq, p);
}

// scalar candidate t (< nscalar): the head, then the tail
__device__ __forceinline__ unsigned scalar_index(const Params& p, unsigned t) {
  return t < p.head ? t : p.head + 16u * p.nvec + (t - p.head);
}

// a thread's run of equal bins, added with one shared atomic when it ends
struct Runs {
  int bin = -1;
  unsigned cnt = 0;
  __device__ __forceinline__ void add(unsigned* h, int b, unsigned c) {
    if (b == bin) {
      cnt += c;
      return;
    }
    if (cnt) atomicAdd(&h[bin], cnt);
    bin = b;
    cnt = c;
  }
  __device__ __forceinline__ void flush(unsigned* h) {
    if (cnt) atomicAdd(&h[bin], cnt);
    cnt = 0;
    bin = -1;
  }
};

// the radix select's state: composites whose top `bits` bits equal
// `prefix` are under it; `below` composites are smaller, `count` under it
struct Level {
  unsigned long long prefix;
  unsigned bits, below, count;
  __device__ __forceinline__ bool under(unsigned long long c) const {
    return bits == 0 || (c >> (64 - bits)) == prefix;
  }
  __device__ __forceinline__ bool at_or_below(unsigned long long c) const {
    return bits == 0 || (c >> (64 - bits)) <= prefix;
  }
  __device__ __forceinline__ int dbits() const {
    return 64 - (int)bits < DIGIT ? 64 - (int)bits : DIGIT;
  }
  __device__ __forceinline__ int digit(unsigned long long c) const {
    const int db = dbits();
    return (int)((c >> (64 - (int)bits - db)) & ((1ull << db) - 1ull));
  }
};

// the histogram of the next digit of the cnt +inf composites of unset
// candidates i0.., at most cnt atomics (usually one add to the run)
__device__ __forceinline__ void hist_inf(unsigned* h, Runs& r,
                                        const Level& lv, unsigned i0,
                                        unsigned cnt) {
  const unsigned long long lo = comp(KEY_INF, i0);
  const unsigned long long hi = comp(KEY_INF, i0 + cnt - 1);
  if (lv.bits) {
    const int s = 64 - (int)lv.bits;
    if ((lo >> s) > lv.prefix || (hi >> s) < lv.prefix) return;
    if ((lo >> s) != (hi >> s)) {
      for (unsigned j = 0; j < cnt; ++j)
        if (lv.under(lo + j)) r.add(h, lv.digit(lo + j), 1);
      return;
    }
  }
  if (lv.digit(lo) == lv.digit(hi)) {
    r.add(h, lv.digit(lo), cnt);
  } else {
    for (unsigned j = 0; j < cnt; ++j) r.add(h, lv.digit(lo + j), 1);
  }
}

// The candidates' walk, coalesced: a warp takes groups of 512 candidates
// (group g from head + 512 g); lane l loads the 16 mask bytes from
// head + 512 g + 16 l in one 16-byte load, and in step q (0..3) takes the
// quad of 4 candidates from head + 512 g + 128 q + 4 l, whose mask bytes
// are word l & 3 of lane 8 q + (l >> 2)'s vector — so the coordinates
// (16-byte loads) and the keys (16-byte stores) of a step are 512
// contiguous bytes a warp. A quad past the vectors (the last group) is
// not the warp's. Every lane of the warp calls it.
__device__ __forceinline__ unsigned quad_word(const uint4& mv, int q) {
  const int lane = threadIdx.x & 31;
  const int src = 8 * q + (lane >> 2);
  const unsigned x = __shfl_sync(0xffffffffu, mv.x, src);
  const unsigned y = __shfl_sync(0xffffffffu, mv.y, src);
  const unsigned z = __shfl_sync(0xffffffffu, mv.z, src);
  const unsigned w = __shfl_sync(0xffffffffu, mv.w, src);
  const int k = lane & 3;
  return k == 0 ? x : (k == 1 ? y : (k == 2 ? z : w));
}

// calls f(i0, w) for each quad of the warp's groups (warp wid of nw): i0
// its first candidate, w its mask bytes; G groups' mask loads in flight a
// lane
template <int G, class F>
__device__ __forceinline__ void each_quad(const Params& p, unsigned wid,
                                          unsigned nw, F&& f) {
  const int lane = threadIdx.x & 31;
  const unsigned ngroups = (p.nvec + 31u) >> 5;
  for (unsigned g0 = wid; g0 < ngroups; g0 += G * nw) {
    uint4 mv[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const unsigned v = 32u * (g0 + k * nw) + lane;
      mv[k] = v < p.nvec
          ? __ldg(reinterpret_cast<const uint4*>(p.mask + p.head + 16u * v))
          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const unsigned g = g0 + k * nw;
      if (g >= ngroups) break;
      const bool any = __any_sync(0xffffffffu, (mv[k].x | mv[k].y | mv[k].z
                                                | mv[k].w) != 0);
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        const unsigned w = any ? quad_word(mv[k], q) : 0u;
        if (32u * g + 8u * q + (unsigned)(lane >> 2) >= p.nvec) continue;
        f(p.head + 512u * g + 128u * q + 4u * (unsigned)lane, w);
      }
    }
  }
}

// exclusive block scan of v (T threads), the total into *total
template <int T>
__device__ __forceinline__ unsigned block_excl_scan(unsigned v,
                                                    unsigned* s_warp,
                                                    unsigned* total) {
  static_assert(T / 32 <= 32, "one warp scans the warps' sums");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < T / 32 ? s_warp[lane] : 0u;
    unsigned wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < T / 32) s_warp[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  const unsigned out = incl - v + s_warp[warp];
  __syncthreads();
  return out;
}

// one level of the select (all T threads): from the bins h of the next
// digit of the composites under lv, the digit holding the m-th smallest
// composite; lv becomes its prefix
template <int T>
__device__ void select_level(const unsigned* h, unsigned m, Level& lv,
                             unsigned* s_warp, unsigned* s_res) {
  const int nb = 1 << lv.dbits();
  const int per = (nb + T - 1) / T;
  const int lo = (int)threadIdx.x * per;
  const int hi = lo + per < nb ? lo + per : nb;
  unsigned s = 0;
  for (int k = lo; k < hi; ++k) s += h[k];
  const unsigned excl = block_excl_scan<T>(s, s_warp, s_res + 3);
  const unsigned b0 = lv.below;
  if (b0 + excl < m && b0 + excl + s >= m) {
    unsigned c = b0 + excl;
    for (int k = lo; k < hi; ++k) {
      if (c + h[k] >= m) {
        s_res[0] = (unsigned)k;
        s_res[1] = c;
        s_res[2] = h[k];
        break;
      }
      c += h[k];
    }
  }
  __syncthreads();
  const int db = lv.dbits();
  lv.prefix = (lv.prefix << db) | s_res[0];
  lv.bits += (unsigned)db;
  lv.below = s_res[1];
  lv.count = s_res[2];
  __syncthreads();
}

// ---------------------------------------------------------------- grid route

// the last CTA of a grid pass (after every CTA's bins reached ws->hist):
// select the next level into ws, zero the bins and the ticket
__device__ void grid_select(const Params& p, unsigned* sh, unsigned* s_warp,
                            unsigned* s_res) {
  Ws* ws = p.ws;
  Level lv{ws->prefix, ws->bits, ws->below, ws->count};
  const int nb = 1 << lv.dbits();
  for (int k = threadIdx.x; k < nb; k += GTHREADS) {
    sh[k] = __ldcg(&ws->hist[k]);
    ws->hist[k] = 0;
  }
  __syncthreads();
  select_level<GTHREADS>(sh, (unsigned)p.m, lv, s_warp, s_res);
  if (threadIdx.x == 0) {
    ws->prefix = lv.prefix;
    ws->bits = lv.bits;
    ws->below = lv.below;
    ws->count = lv.count;
    ws->ticket = 0;
  }
}

// every CTA: whether it is the last of the pass to finish (its prior
// global atomics fenced)
__device__ __forceinline__ bool last_cta(Ws* ws, bool* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(&ws->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (*s_last) __threadfence();
  return *s_last;
}

// pass 1: every candidate's key into p.keys, the histogram of their top
// digit; the last CTA selects it
template <bool BLOCKS>
__global__ void __launch_bounds__(GTHREADS) keys_kernel(
    const __grid_constant__ Params p) {
  __shared__ unsigned sh[NB];
  __shared__ unsigned s_warp[GTHREADS / 32], s_res[4];
  __shared__ bool s_last;
  for (int k = threadIdx.x; k < NB; k += GTHREADS) sh[k] = 0;
  __syncthreads();
  const float cq = cosf(__fmul_rn(p.qy, p.rad));
  Runs r;
  const unsigned t = blockIdx.x * GTHREADS + threadIdx.x;
  each_quad<1>(p, t >> 5, (gridDim.x * GTHREADS) >> 5,
               [&](unsigned i0, unsigned w) {
    uint4 k = make_uint4(KEY_INF, KEY_INF, KEY_INF, KEY_INF);
    if (w) {
      Walk<BLOCKS> walk(p, i0);
      k = quad_keys<BLOCKS>(p, cq, i0, w, walk);
    }
    *reinterpret_cast<uint4*>(p.keys + i0) = k;
    if (!w) {
      r.add(sh, (int)(KEY_INF >> (32 - DIGIT)), 4);
      return;
    }
    r.add(sh, (int)(k.x >> (32 - DIGIT)), 1);
    r.add(sh, (int)(k.y >> (32 - DIGIT)), 1);
    r.add(sh, (int)(k.z >> (32 - DIGIT)), 1);
    r.add(sh, (int)(k.w >> (32 - DIGIT)), 1);
  });
  if (t < p.nscalar) {
    const unsigned i = scalar_index(p, t);
    const unsigned k = cand_key<BLOCKS>(p, cq, i);
    p.keys[i] = k;
    r.add(sh, (int)(k >> (32 - DIGIT)), 1);
  }
  r.flush(sh);
  __syncthreads();
  for (int k = threadIdx.x; k < NB; k += GTHREADS)
    if (sh[k]) atomicAdd(&p.ws->hist[k], sh[k]);
  if (last_cta(p.ws, &s_last)) grid_select(p, sh, s_warp, s_res);
}

// a warp-aggregated slot of an atomic counter for the calling thread
__device__ __forceinline__ unsigned agg_slot(unsigned* counter) {
  cg::coalesced_group g = cg::coalesced_threads();
  unsigned base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(counter, g.size());
  return g.shfl(base, 0) + g.thread_rank();
}

// passes 2 to 5 over the keys, each one read of them: nothing once the
// prefix's composites are handed over; else, when at most BUF_CAP are under
// the prefix, those below it into the pairs and those under it into the
// buffer; else the next digit's histogram, selected by the last CTA
__global__ void __launch_bounds__(GTHREADS) level_kernel(
    const __grid_constant__ Params p) {
  __shared__ unsigned sh[NB];
  __shared__ unsigned s_warp[GTHREADS / 32], s_res[4];
  __shared__ bool s_last;
  Ws* ws = p.ws;
  if (ws->handed) return;
  const Level lv{ws->prefix, ws->bits, ws->below, ws->count};
  const bool hand = lv.count <= BUF_CAP;
  if (!hand) {
    for (int k = threadIdx.x; k < NB; k += GTHREADS) sh[k] = 0;
    __syncthreads();
  }
  const int s = 64 - (int)lv.bits;     // bits >= DIGIT here
  Runs r;
  const unsigned nt = gridDim.x * GTHREADS;
  const unsigned t = blockIdx.x * GTHREADS + threadIdx.x;
  auto visit = [&](unsigned key, unsigned i) {
    const unsigned long long c = comp(key, i);
    const unsigned long long top = c >> s;
    if (hand) {
      if (top < lv.prefix)
        p.pairs[agg_slot(&ws->npairs)] = c;
      else if (top == lv.prefix)
        p.buf[agg_slot(&ws->nbuf)] = c;
    } else if (top == lv.prefix) {
      r.add(sh, lv.digit(c), 1);
    }
  };
  const unsigned kd = (unsigned)(lv.prefix >> (lv.bits - DIGIT));
  const unsigned nquad = 4u * p.nvec;
  for (unsigned q = t; q < nquad; q += nt) {
    const unsigned i0 = p.head + 4u * q;
    const uint4 k = __ldcs(reinterpret_cast<const uint4*>(p.keys + i0));
    // the top digit settles most keys without their composite: above the
    // prefix's, a key is neither below nor under it
    if ((k.x >> (32 - DIGIT)) <= kd) visit(k.x, i0);
    if ((k.y >> (32 - DIGIT)) <= kd) visit(k.y, i0 + 1);
    if ((k.z >> (32 - DIGIT)) <= kd) visit(k.z, i0 + 2);
    if ((k.w >> (32 - DIGIT)) <= kd) visit(k.w, i0 + 3);
  }
  if (t < p.nscalar) {
    const unsigned i = scalar_index(p, t);
    visit(p.keys[i], i);
  }
  if (hand) {
    if (last_cta(ws, &s_last) && threadIdx.x == 0) {
      ws->handed = 1;
      ws->ticket = 0;
    }
    return;
  }
  r.flush(sh);
  __syncthreads();
  for (int k = threadIdx.x; k < NB; k += GTHREADS)
    if (sh[k]) atomicAdd(&ws->hist[k], sh[k]);
  if (last_cta(ws, &s_last)) grid_select(p, sh, s_warp, s_res);
}

// ------------------------------------------------------------- the cluster

// the one cluster: the select from `lv` over the source's composites
// (SRC_FULL / SRC_BLOCKS: the candidates; SRC_BUF: the grid route's buffer
// and pairs), then the sort of those at or below the prefix in CTA 0's
// shared memory, and the m outputs. The candidates' set ones are listed
// first (one pass over the mask, CAPC a CTA) and their composites computed
// once, by all threads at a time; an unset candidate's composite is
// (+inf, candidate), counted at once and walked from the mask only where
// the select reaches the +inf keys. A CTA with more set candidates than
// CAPC makes every pass compute its keys again from the mask.
template <int SRC>
__global__ void __launch_bounds__(CTHREADS) cluster_kernel(
    const __grid_constant__ Params p) {
  constexpr bool BLOCKS = SRC == SRC_BLOCKS;
  constexpr bool CAND = SRC != SRC_BUF;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* lh = reinterpret_cast<unsigned*>(smem);      // this CTA's bins
  unsigned* gh = lh + NB;                                // CTA 0: the sums
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(gh + NB);    // CTA 0: CAP
  unsigned long long* ccomp = list + CAP;                // CAPC composites
  unsigned* cidx = reinterpret_cast<unsigned*>(ccomp + CAPC);   // CAPC
  __shared__ Level s_lv;
  __shared__ unsigned s_n, s_set, s_over, s_total;
  __shared__ unsigned s_warp[CTHREADS / 32], s_res[4];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < NB; k += CTHREADS) {
    lh[k] = 0;
    gh[k] = 0;
  }
  // SRC_BUF: the grid's composites below its prefix and under it
  const unsigned npairs = SRC == SRC_BUF ? p.ws->npairs : 0u;
  const unsigned nbuf = SRC == SRC_BUF ? p.ws->nbuf : 0u;
  if (threadIdx.x == 0) {
    s_n = 0;
    s_set = 0;
    if (SRC == SRC_BUF) {
      s_lv = Level{p.ws->prefix, p.ws->bits, p.ws->below, p.ws->count};
    } else {
      s_lv = Level{0ull, 0u, 0u, p.n};
    }
  }
  unsigned* gh0 = cluster.map_shared_rank(gh, 0);
  Level* lv0 = cluster.map_shared_rank(&s_lv, 0);
  __syncthreads();

  const float cq = cosf(__fmul_rn(p.qy, p.rad));
  const unsigned t = rank * CTHREADS + threadIdx.x;
  constexpr unsigned NT = CLUSTER * CTHREADS;
  const unsigned m = (unsigned)p.m;
  const unsigned emit = 2 * m > 1024 ? (2 * m < CAP ? 2 * m : CAP) : 1024;

  // the set candidates: listed, then their composites computed at once
  bool cached = false;
  unsigned nset = 0;
  if constexpr (CAND) {
    each_quad<4>(p, t >> 5, NT >> 5, [&](unsigned i0, unsigned w) {
      if (!w) return;
      unsigned j = atomicAdd(&s_set, (unsigned)__popc(w));   // bytes are 0/1
      for (int r = 0; r < 4; ++r)
        if ((w >> (8 * r)) & 0xffu) {
          if (j < CAPC) cidx[j] = i0 + r;
          ++j;
        }
    });
    if (t < p.nscalar) {
      const unsigned i = scalar_index(p, t);
      if (p.mask[i]) {
        const unsigned j = atomicAdd(&s_set, 1u);
        if (j < CAPC) cidx[j] = i;
      }
    }
  }
  cluster.sync();   // every CTA's bins zero, its state and set count made
  if constexpr (CAND) {
    if (threadIdx.x < 32) {
      const unsigned c = lane < CLUSTER ? *cluster.map_shared_rank(&s_set,
                                                                   lane)
                                        : 0u;
      unsigned sum = c;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, d);
      const bool over = __any_sync(0xffffffffu, c > (unsigned)CAPC);
      if (lane == 0) {
        s_over = over;
        s_total = sum;
      }
    }
    __syncthreads();
    cached = !s_over;
    if (cached) {
      nset = s_set;
      for (unsigned j = threadIdx.x; j < nset; j += CTHREADS) {
        const unsigned i = cidx[j];
        const long long row = row_of<BLOCKS>(p, i);
        ccomp[j] = comp(key_of(__ldg(p.xf + row), __ldg(p.yf + row), cq, p),
                        i);
      }
      __syncthreads();
    }
  }
  Level lv = s_lv;

  // visit(c) for every composite of the source, visit_inf(i0) for the 4
  // +inf composites of an unset quad from i0; `inf`: whether the unset
  // candidates' composites are needed (with the set ones listed)
  auto each = [&](bool inf, auto&& visit, auto&& visit_inf) {
    if constexpr (SRC == SRC_BUF) {
      for (unsigned e = t; e < nbuf; e += NT) visit(__ldcg(p.buf + e));
    } else {
      if (cached) {
        for (unsigned j = threadIdx.x; j < nset; j += CTHREADS)
          visit(ccomp[j]);
        if (!inf) return;
      }
      each_quad<4>(p, t >> 5, NT >> 5, [&](unsigned i0, unsigned w) {
        if (!w) {
          visit_inf(i0);
          return;
        }
        if (cached) {
          for (unsigned r = 0; r < 4; ++r)
            if (!((w >> (8 * r)) & 0xffu)) visit(comp(KEY_INF, i0 + r));
          return;
        }
        Walk<BLOCKS> walk(p, i0);
        const uint4 k = quad_keys<BLOCKS>(p, cq, i0, w, walk);
        visit(comp(k.x, i0));
        visit(comp(k.y, i0 + 1));
        visit(comp(k.z, i0 + 2));
        visit(comp(k.w, i0 + 3));
      });
      if (t < p.nscalar) {
        const unsigned i = scalar_index(p, t);
        if (!cached)
          visit(comp(cand_key<BLOCKS>(p, cq, i), i));
        else if (!p.mask[i])
          visit(comp(KEY_INF, i));
      }
    }
  };
  // the +inf composites (KEY_INF, 0..2^32-1) under / at or below the prefix
  const unsigned long long inf_lo = comp(KEY_INF, 0u);
  const unsigned long long inf_hi = comp(KEY_INF, 0xffffffffu);

  while (lv.below + lv.count > emit) {
    Runs r;
    // at the first level the unset candidates are counted, not walked
    const bool first = lv.bits == 0;
    const bool inf = !first && (inf_lo >> (64 - lv.bits)) <= lv.prefix &&
                     (inf_hi >> (64 - lv.bits)) >= lv.prefix;
    each(inf || !cached,
         [&](unsigned long long c) {
           if (lv.under(c)) r.add(lh, lv.digit(c), 1);
         },
         [&](unsigned i0) { hist_inf(lh, r, lv, i0, 4); });
    if (CAND && cached && first && rank == 0 && threadIdx.x == 0)
      r.add(lh, (int)(KEY_INF >> (32 - DIGIT)), p.n - s_total);
    r.flush(lh);
    __syncthreads();
    for (int k = threadIdx.x; k < NB; k += CTHREADS) {
      const unsigned c = lh[k];
      if (c) {
        atomicAdd(gh0 + k, c);
        lh[k] = 0;
      }
    }
    cluster.sync();   // CTA 0's sums are whole
    if (rank == 0) {
      Level next = lv;
      select_level<CTHREADS>(gh, m, next, s_warp, s_res);
      for (int k = threadIdx.x; k < NB; k += CTHREADS) gh[k] = 0;
      if (threadIdx.x == 0) s_lv = next;
    }
    cluster.sync();   // the next level is in CTA 0's state
    lv = *lv0;
  }

  // the emission: every composite at or below the prefix into CTA 0's list
  unsigned* n0 = cluster.map_shared_rank(&s_n, 0);
  unsigned long long* list0 = cluster.map_shared_rank(list, 0);
  const bool inf = lv.bits == 0 || (inf_lo >> (64 - lv.bits)) <= lv.prefix;
  each(inf,
       [&](unsigned long long c) {
         if (lv.at_or_below(c)) list0[agg_slot(n0)] = c;
       },
       [&](unsigned i0) {
         const unsigned long long lo = comp(KEY_INF, i0);
         if (!lv.at_or_below(lo)) return;
         for (unsigned j = 0; j < 4; ++j)
           if (lv.at_or_below(lo + j)) list0[agg_slot(n0)] = lo + j;
       });
  if constexpr (SRC == SRC_BUF) {
    // the grid's pairs, below its prefix (none of them in the buffer)
    if (rank == 0)
      for (unsigned e = threadIdx.x; e < npairs; e += CTHREADS)
        list0[agg_slot(n0)] = __ldcg(p.pairs + e);
  }
  cluster.sync();   // every composite is in CTA 0's list
  if (rank != 0) return;

  const unsigned total = s_n;
  unsigned P = 1;
  while (P < total) P <<= 1;
  for (unsigned i = total + threadIdx.x; i < P; i += CTHREADS) list[i] = ~0ull;
  __syncthreads();
  // bitonic, one thread a compare-exchange pair (i, i + j) of a stage
  for (unsigned k = 2; k <= P; k <<= 1) {
    for (unsigned j = k >> 1; j > 0; j >>= 1) {
      for (unsigned h = threadIdx.x; h < P / 2; h += CTHREADS) {
        const unsigned i = 2 * h - (h & (j - 1));
        const unsigned l = i + j;
        const unsigned long long a = list[i], b = list[l];
        if ((a > b) == ((i & k) == 0)) {
          list[i] = b;
          list[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (unsigned i = threadIdx.x; i < m; i += CTHREADS) {
    const unsigned long long v = list[i];
    p.dist[i] = __uint_as_float((unsigned)(v >> 32));
    p.pos[i] = SRC == SRC_BUF && p.starts
                   ? (int)row_of<true>(p, (unsigned)v)
                   : (int)row_of<BLOCKS>(p, (unsigned)v);
  }
  if (SRC == SRC_BUF && threadIdx.x == 0) {
    // the workspace zero again for the next call
    Ws* ws = p.ws;
    ws->handed = 0;
    ws->npairs = 0;
    ws->nbuf = 0;
    ws->prefix = 0;
    ws->bits = 0;
    ws->below = 0;
    ws->count = 0;
  }
}

constexpr size_t CLUSTER_SMEM =
    2 * NB * sizeof(unsigned) + CAP * sizeof(unsigned long long)
    + CAPC * (sizeof(unsigned long long) + sizeof(unsigned));

// one launch of the one cluster
template <int SRC>
cudaError_t launch_cluster(const Params& p, int dev, cudaStream_t st) {
  static std::mutex mu;
  static bool ready[MAX_DEVICES];
  const void* kernel = reinterpret_cast<const void*>(cluster_kernel<SRC>);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(CTHREADS);
  cfg.dynamicSmemBytes = CLUSTER_SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  {
    std::lock_guard<std::mutex> hold(mu);
    if (!ready[dev]) {
      if ((err = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               (int)CLUSTER_SMEM)) != cudaSuccess)
        return err;
      if ((err = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
          != cudaSuccess)
        return err;
      int fit = 0;
      if ((err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg))
          != cudaSuccess)
        return err;
      if (fit < 1) return (cudaError_t)NO_CLUSTER;
      ready[dev] = true;
    }
  }
  if ((err = cudaLaunchKernelEx(&cfg, cluster_kernel<SRC>, p)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// CTAs of a grid pass (kernel ID): as many as fit on the device at once
template <int ID>
cudaError_t grid_of(const void* kernel, int dev, int* out) {
  static std::mutex mu;
  static int known[MAX_DEVICES];
  std::lock_guard<std::mutex> hold(mu);
  if (!known[dev]) {
    int sms = 0, per = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, kernel, GTHREADS, 0)) != cudaSuccess)
      return err;
    known[dev] = sms * (per > 0 ? per : 1);
  }
  *out = known[dev];
  return cudaSuccess;
}

template <bool BLOCKS>
cudaError_t launch_grid(const Params& p, int dev, cudaStream_t st) {
  int g1 = 0, g2 = 0;
  cudaError_t err = grid_of<BLOCKS ? 1 : 0>(
      reinterpret_cast<const void*>(keys_kernel<BLOCKS>), dev, &g1);
  if (err != cudaSuccess) return err;
  if ((err = grid_of<2>(reinterpret_cast<const void*>(level_kernel), dev,
                        &g2)) != cudaSuccess)
    return err;
  keys_kernel<BLOCKS><<<g1, GTHREADS, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k = 0; k < LEVEL_PASSES; ++k) {
    level_kernel<<<g2, GTHREADS, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return launch_cluster<SRC_BUF>(p, dev, st);
}

}  // namespace

// The m (1 <= m <= min(n, 4096)) nearest of n candidates to (qx, qy):
// dist (m f32) and pos (m int32) ascending by (distance, candidate). With
// starts (BLOCKS; null for FULL) candidate i reads row starts[i / bsz] +
// i % bsz. route 0: the one cluster (keys and ws unused); 1: the grid
// passes, with keys (n + 3 words, 16-byte aligned) and ws (the per-stream
// workspace, topk_nearest_ws_bytes() bytes, 16-byte aligned, zero between
// calls). On `stream` of device `device` (the current device); returns
// the first CUDA error, or NO_CLUSTER.
extern "C" int topk_nearest_launch(const float* xf, const float* yf,
                                   const uint8_t* mask,
                                   const long long* starts, long long bsz,
                                   unsigned n, float qx, float qy, float rad,
                                   float two_r, int m, int route,
                                   unsigned* keys, void* ws, float* dist,
                                   int* pos, int device, void* stream) {
  if (m < 1 || m > MAX_M || (unsigned)m > n || n > 0x7fffffffu ||
      device < 0 || device >= MAX_DEVICES || (starts && bsz <= 0) ||
      (route == 1 && (((uintptr_t)keys & 15) || ((uintptr_t)ws & 15))))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.xf = xf;
  p.yf = yf;
  p.mask = mask;
  p.starts = starts;
  p.bsz = bsz;
  p.n = n;
  unsigned head = (unsigned)((16u - ((uintptr_t)mask & 15u)) & 15u);
  if (head > n) head = n;
  p.head = head;
  p.nvec = (n - head) / 16u;
  p.nscalar = head + (n - head - 16u * p.nvec);
  p.vec_xy = !starts && (((uintptr_t)(xf + head) & 15) == 0) &&
             (((uintptr_t)(yf + head) & 15) == 0);
  p.qx = qx;
  p.qy = qy;
  p.rad = rad;
  p.two_r = two_r;
  p.m = m;
  p.dist = dist;
  p.pos = pos;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (route == 0) {
    err = starts ? launch_cluster<SRC_BLOCKS>(p, device, st)
                 : launch_cluster<SRC_FULL>(p, device, st);
    return (int)err;
  }
  // keys + head on a 16-byte boundary, as the mask's vectors
  p.keys = keys + ((4u - (head & 3u)) & 3u);
  p.ws = static_cast<Ws*>(ws);
  p.pairs = reinterpret_cast<unsigned long long*>(p.ws + 1);
  p.buf = p.pairs + MAX_M;
  // the stream's calls share its workspace, and stream order keeps each
  // call's passes on it together only if no other thread's call enqueues
  // between them: one call's six launches go in under the device's lock
  static std::mutex grid_mu[MAX_DEVICES];
  std::lock_guard<std::mutex> hold(grid_mu[device]);
  err = starts ? launch_grid<true>(p, device, st)
               : launch_grid<false>(p, device, st);
  return (int)err;
}

// bytes of the grid route's per-stream workspace
extern "C" long long topk_nearest_ws_bytes() {
  return (long long)sizeof(Ws)
         + (long long)(MAX_M + BUF_CAP) * sizeof(unsigned long long);
}

extern "C" int topk_nearest_max_m() { return MAX_M; }

extern "C" const char* topk_nearest_error_string(int code) {
  if (code == NO_CLUSTER)
    return "no cluster of its CTAs, threads and shared memory fits on the "
           "device";
  return cudaGetErrorString((cudaError_t)code);
}
