// The traversal of the geometry catalog's pair programs (geom_dist.cu,
// geom_pred.cu): packed features against one literal, on Hopper (sm_90a).
//
// A program is an Op (DistOp, PredOp) that folds the four kinds of pair
// into its per-lane state: (feature vertex, literal edge) A, (feature
// vertex, literal point) B, (feature segment, literal edge) C and (literal
// point, feature segment) D. A vertex's crossing parity and band
// uncertainty over the literal's edges, and a literal point's over the
// feature's segments, are XOR and OR over pairs; everything else is a min,
// an any or an all. None depends on order, so the lanes may split the
// pairs any way and meet in shuffles and ballots: the kernels equal the
// plain versions bit for bit.
//
// Design:
// - Several features a warp: a feature gets a group of G lanes (a power of
//   two, 1 to 32; kernels/geom.py `plan` picks it from the batch's size,
//   K, S, L and P: a lane a feature where the batch fills the card), a CTA
//   of 256 threads takes 256 / G features a round and strides over the
//   batch; 4 CTAs an SM (32 warps, 64 registers a thread). Consecutive
//   lanes read consecutive slots of consecutive features.
// - The literal is staged once a CTA, flushed, in the global frame, into
//   shared memory (when L and P fit a tile of 1,024; else tile by tile
//   behind CTA barriers, the loops around them uniform across the CTA).
//   Each feature's shift into its frame is done in registers: the same
//   zsub on the same operands as the plain version's.
// - Two forms. ITEMS (lanes over the feature's items): a lane takes the
//   feature's vertex slots g, g + G, ... against every staged edge and
//   point, and its segment slots against every edge; D runs 32 literal
//   points at a time against the lane's segments, each point's parity and
//   uncertainty a bit of a word that the group XORs and ORs. LIT (lanes
//   over the literal, G = 32): the warp walks the feature's vertices and
//   segments and its lanes split the literal's edges (a vertex's parity a
//   ballot) and, in D, its points.
// - A feature's vertex and segment loops stop at its masks' last set byte
//   (`extent`, the rows read as 4-byte words): pad slots past a feature's
//   own count cost neither loads nor arithmetic; slots inside it are read
//   by their mask, so any mask gives the plain version's answer.
// - A vertex's bits ride in a word while the tiles pass (chunks of 32
//   vertex rounds; more chunks restage the literal).
// - The literal's trailing run of identical items (pack_literal's pads up
//   to a power of two) is cut to what gives the same answer: one point,
//   and one edge or two as the run's length is odd or even (identical
//   items give identical pairs; min, any and all take one copy, a parity
//   the run's own). The traversal spends nothing on the rest.

#pragma once

#include "geom_common.cuh"

namespace geomk {

constexpr int PAIR_THREADS = 256;
// CTAs an SM: 4 (32 warps) leave a thread 64 registers (8, for all 64
// warps, left 32: the kernels spilled more and ran slower). At 4 ptxas
// spills a little (stores / loads): geom_dist ITEMS 8 / 16 bytes, LIT
// none; geom_pred ITEMS 20 / 24, LIT 14 / 28.
constexpr int PAIR_CTAS_PER_SM = 4;
constexpr int PAIR_TILE = 1024;
constexpr int PAIR_MAX_DEVICES = 64;
constexpr unsigned FULL_MASK = 0xffffffffu;

// a launch's arguments: 8-byte slots, as kernels/geom.py packs them
struct PairArgs {
  long long verts, vmask, segs, smask, poly, ref, lsegs, lpts;
  long long B, K, S, L, P;
  long long lg, lit;  // the plan: log2 of the lanes a feature, the form
  long long op, lit_poly, lit_ext;
  long long out, cin, cout;
  long long device;
  double tol_t, tol_d, dy_band, miss2;
};

struct PairParams {
  const float2* verts;   // (B, K)
  const uint8_t* vmask;  // (B, K)
  const float4* segs;    // (B, S)
  const uint8_t* smask;  // (B, S)
  const uint8_t* poly;   // (B,)
  const float2* ref;     // (B,) f32 origins
  const float4* lsegs;   // (L,)
  const float2* lpts;    // (P,)
  long long B;
  int K, S, L, P;
  int lg;                // log2 G
  bool vwords, swords;   // mask rows readable as 4-byte words
  int op, lit_poly, lit_ext;
  Band band;
  float miss2;           // the certain-miss band, squared in f32
  float* out;            // (B,) geom_dist
  uint8_t* cin;          // (B,) geom_pred
  uint8_t* cout;         // (B,) geom_pred
};

// reductions over a group of G lanes (aligned, G a power of two); every
// lane of the warp calls them
__device__ __forceinline__ float group_min(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v = nmin(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ unsigned group_or(unsigned v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v |= __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ unsigned group_xor(unsigned v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v ^= __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ int group_max(int v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// one past the last set byte of the mask row `row` of n bytes (0 when
// none), read by the group's lanes (g of G)
__device__ __forceinline__ int extent(const uint8_t* row, int n, bool words,
                                      int g, int G) {
  int last = -1;
  if (words) {
    const unsigned* w = reinterpret_cast<const unsigned*>(row);
    for (int i = g; i < (n >> 2); i += G) {
      const unsigned x = w[i];
      if (x) last = 4 * i + ((31 - __clz((int)x)) >> 3);
    }
  } else {
    for (int i = g; i < n; i += G)
      if (row[i]) last = i;
  }
  return group_max(last, G) + 1;
}

// the largest v of the CTA (every thread calls it)
__device__ __forceinline__ int cta_max(int v) {
  __shared__ int s_max;
  __syncthreads();
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  atomicMax(&s_max, v);
  __syncthreads();
  return s_max;
}

__device__ __forceinline__ float4 shift4(float4 e, float rx, float ry) {
  return make_float4(zsub(e.x, rx), zsub(e.y, ry), zsub(e.z, rx),
                     zsub(e.w, ry));
}

__device__ __forceinline__ float2 shift2(float2 q, float rx, float ry) {
  return make_float2(zsub(q.x, rx), zsub(q.y, ry));
}

// the start of the trailing run of n items of W 4-byte words each that
// equal the last one bit for bit (a warp's lanes together; every lane of
// the warp calls it and gets it)
__device__ __forceinline__ int run_start(const unsigned* a, int n, int W) {
  const unsigned* last = a + (long long)(n - 1) * W;
  int start = 0;
  for (int i = threadIdx.x & 31; i < n - 1; i += 32) {
    bool same = true;
    for (int w = 0; w < W; ++w) same &= a[(long long)i * W + w] == last[w];
    if (!same) start = i + 1;
  }
  return __reduce_max_sync(FULL_MASK, start);
}

// the literal's tile t (of L edges and P points), flushed, into shared
// memory (the CTA's threads)
__device__ __forceinline__ void stage(const PairParams& p, float4* s_e,
                                      float2* s_p, int L, int P, int t) {
  const int e0 = t * PAIR_TILE;
  const int ne = min(PAIR_TILE, L - e0);
  const int nq = min(PAIR_TILE, P - e0);
  for (int i = threadIdx.x; i < ne; i += PAIR_THREADS)
    s_e[i] = zin4(p.lsegs[e0 + i]);
  for (int i = threadIdx.x; i < nq; i += PAIR_THREADS)
    s_p[i] = zin2(p.lpts[e0 + i]);
}

template <class Op, bool LIT>
__device__ __forceinline__ void pair_program(const PairParams& p) {
  extern __shared__ float4 s_lit[];
  float4* s_e = s_lit;
  float2* s_p = reinterpret_cast<float2*>(s_lit + min(p.L, PAIR_TILE));
  const int G = 1 << p.lg;
  const int g = threadIdx.x & (G - 1);
  const int lane = threadIdx.x & 31;
  // the edges and points the traversal takes (the trailing runs cut): a
  // warp's own copy in shared memory, read where it is used (as two
  // registers live across the feature loop they spilled 36 to 64 bytes)
  __shared__ int s_keep[PAIR_THREADS / 32][2];
  volatile int* keep = s_keep[threadIdx.x >> 5];
  {
    const int le = run_start(reinterpret_cast<const unsigned*>(p.lsegs), p.L,
                             4);
    const int lp = run_start(reinterpret_cast<const unsigned*>(p.lpts), p.P,
                             2);
    if (lane == 0) {
      keep[0] = le + 2 - ((p.L - le) & 1);  // the run is 1 item or more
      keep[1] = lp + 1;
    }
    __syncwarp();
  }
  // (the whole padded literal when it fits a tile: its loads need not
  // wait for the cut)
  const bool resident = p.L <= PAIR_TILE && p.P <= PAIR_TILE;
  // a lane's first item and stride: its own slots (ITEMS) or the
  // literal's edges and points (LIT)
  constexpr int LSTEP = LIT ? 32 : 1;
  const int l0 = LIT ? lane : 0;
  const int fpc = PAIR_THREADS >> p.lg;
  if (resident) {
    stage(p, s_e, s_p, p.L, p.P, 0);
    __syncthreads();
  }
  for (long long base = (long long)blockIdx.x * fpc; base < p.B;
       base += (long long)gridDim.x * fpc) {
    const long long b = base + (threadIdx.x >> p.lg);
    const bool live = b < p.B;
    const uint8_t* vm = p.vmask + b * p.K;
    const uint8_t* sm = p.smask + b * p.S;
    const float2* vt = p.verts + b * p.K;
    const float4* sg = p.segs + b * p.S;
    const int kext = extent(vm, live ? p.K : 0, p.vwords, g, G);
    const int sext = extent(sm, live ? p.S : 0, p.swords, g, G);
    float rx = 0.0f, ry = 0.0f;
    bool fpoly = false;
    if (live) {
      const float2 r = zin2(p.ref[b]);
      rx = r.x;
      ry = r.y;
      fpoly = p.poly[b] != 0;
    }
    // vertex rounds: the feature's slots (LIT), the lane's own (ITEMS)
    const int rounds =
        LIT ? kext : (kext > g ? ((kext - g - 1) >> p.lg) + 1 : 0);
    int chunks = max(1, (rounds + 31) >> 5);
    if (!resident) chunks = cta_max(chunks);
    Op op(p);
    for (int c = 0; c < chunks; ++c) {
      unsigned vin = 0, vunc = 0, vlive = 0;
      for (int t = 0;; ++t) {
        // (the same for every thread: the loop is uniform across the CTA)
        const int ne = min(PAIR_TILE, keep[0] - t * PAIR_TILE);
        const int nq = min(PAIR_TILE, keep[1] - t * PAIR_TILE);
        if (ne <= 0 && nq <= 0) break;
        if (!resident) {
          __syncthreads();
          stage(p, s_e, s_p, keep[0], keep[1], t);
          __syncthreads();
        }
        // A and B: the chunk's vertices against the tile
        for (int i = 0; i < 32; ++i) {
          const int r = (c << 5) + i;
          if (r >= rounds) break;
          const int k = LIT ? r : g + (r << p.lg);
          const float2 v = zin2(vt[k]);  // beside its mask, not after it
          if (!vm[k]) continue;
          vlive |= 1u << i;
          bool in = false, un = false;
          for (int e = l0; e < ne; e += LSTEP)
            op.vertex_edge(v.x, v.y, shift4(s_e[e], rx, ry), in, un);
          for (int q = l0; q < nq; q += LSTEP)
            op.vertex_point(v.x, v.y, shift2(s_p[q], rx, ry));
          if (LIT) {
            in = __popc(__ballot_sync(FULL_MASK, in)) & 1;
            un = __any_sync(FULL_MASK, un);
          }
          if (in) vin ^= 1u << i;
          if (un) vunc |= 1u << i;
        }
        if (c != 0) continue;
        if (LIT) {
          // C: the feature's segments against the tile's edges
          for (int j = 0; j < sext; ++j) {
            const float4 s = zin4(sg[j]);
            if (!sm[j]) continue;
            for (int e = lane; e < ne; e += 32)
              op.seg_edge(s, shift4(s_e[e], rx, ry));
          }
          // D: the tile's points against the feature's segments
          for (int q = lane; q < nq; q += 32) {
            const float2 lq = shift2(s_p[q], rx, ry);
            bool in = false, un = false;
            for (int j = 0; j < sext; ++j) {
              const float4 s = zin4(sg[j]);
              if (sm[j]) op.point_seg(lq.x, lq.y, s, in, un);
            }
            op.point_end(fpoly, in, un);
          }
          continue;
        }
        // C, and D over the tile's first 32 points, with each of the
        // lane's segments loaded once; D's further points 32 at a time
        for (int q0 = 0; q0 == 0 || q0 < nq; q0 += 32) {
          const int m = min(32, nq - q0);
          unsigned pin = 0, punc = 0;
          for (int j = g; j < sext; j += G) {
            const float4 s = zin4(sg[j]);
            if (!sm[j]) continue;
            if (q0 == 0)
              for (int e = 0; e < ne; ++e)
                op.seg_edge(s, shift4(s_e[e], rx, ry));
            for (int i = 0; i < m; ++i) {
              const float2 lq = shift2(s_p[q0 + i], rx, ry);
              bool in = false, un = false;
              op.point_seg(lq.x, lq.y, s, in, un);
              if (in) pin ^= 1u << i;
              if (un) punc |= 1u << i;
            }
          }
          if (m <= 0) break;
          pin = group_xor(pin, G);
          punc = group_or(punc, G);
          for (int i = 0; i < m; ++i)
            op.point_end(fpoly, (pin >> i) & 1u, (punc >> i) & 1u);
        }
      }
      while (vlive) {
        const int i = __ffs(vlive) - 1;
        vlive &= vlive - 1;
        op.vertex_end((vin >> i) & 1u, (vunc >> i) & 1u);
      }
    }
    op.reduce(G);
    if (live && g == 0) op.write(p, b, fpoly);
  }
}

template <class Op>
__global__ void __launch_bounds__(PAIR_THREADS, PAIR_CTAS_PER_SM)
pair_items_kernel(PairParams p) {
  pair_program<Op, false>(p);
}

template <class Op>
__global__ void __launch_bounds__(PAIR_THREADS, PAIR_CTAS_PER_SM)
pair_lit_kernel(PairParams p) {
  pair_program<Op, true>(p);
}

// Launches Op's kernel on `stream` (PyTorch's current stream of the
// current device) and returns the launch's cudaError_t (0 on success); the
// caller raises on non-zero.
template <class Op>
int pair_launch(const PairArgs* a, void* stream) {
  static int sms_of[PAIR_MAX_DEVICES];
  if (a->B <= 0) return 0;
  if (a->K < 1 || a->S < 1 || a->L < 1 || a->P < 1 || a->lg < 0 ||
      a->lg > 5 || (a->lit && a->lg != 5) || a->K > 0x7fffffff ||
      a->S > 0x7fffffff || a->L > 0x7fffffff || a->P > 0x7fffffff ||
      (a->verts | a->ref | a->lpts) % 8 || (a->segs | a->lsegs) % 16)
    return (int)cudaErrorInvalidValue;
  if (a->device < 0 || a->device >= PAIR_MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  int& sms = sms_of[a->device];
  if (sms == 0) {
    int n = 0;
    const cudaError_t err = cudaDeviceGetAttribute(
        &n, cudaDevAttrMultiProcessorCount, (int)a->device);
    if (err != cudaSuccess) return (int)err;
    sms = n > 0 ? n : 1;
  }
  PairParams p;
  p.verts = reinterpret_cast<const float2*>(a->verts);
  p.vmask = reinterpret_cast<const uint8_t*>(a->vmask);
  p.segs = reinterpret_cast<const float4*>(a->segs);
  p.smask = reinterpret_cast<const uint8_t*>(a->smask);
  p.poly = reinterpret_cast<const uint8_t*>(a->poly);
  p.ref = reinterpret_cast<const float2*>(a->ref);
  p.lsegs = reinterpret_cast<const float4*>(a->lsegs);
  p.lpts = reinterpret_cast<const float2*>(a->lpts);
  p.B = a->B;
  p.K = (int)a->K;
  p.S = (int)a->S;
  p.L = (int)a->L;
  p.P = (int)a->P;
  p.lg = (int)a->lg;
  p.vwords = p.K % 4 == 0 && a->vmask % 4 == 0;
  p.swords = p.S % 4 == 0 && a->smask % 4 == 0;

  p.op = (int)a->op;
  p.lit_poly = (int)a->lit_poly;
  p.lit_ext = (int)a->lit_ext;
  p.band.tol_t = (float)a->tol_t;
  p.band.tol_d = (float)a->tol_d;
  p.band.dy = (float)a->dy_band;
  p.miss2 = (float)a->miss2;
  p.out = reinterpret_cast<float*>(a->out);
  p.cin = reinterpret_cast<uint8_t*>(a->cin);
  p.cout = reinterpret_cast<uint8_t*>(a->cout);
  const long long fpc = PAIR_THREADS >> p.lg;
  const long long rounds = (p.B + fpc - 1) / fpc;
  const long long fit = (long long)sms * PAIR_CTAS_PER_SM;
  const unsigned grid = (unsigned)(rounds < fit ? rounds : fit);
  const size_t smem =
      sizeof(float4) * (size_t)(p.L < PAIR_TILE ? p.L : PAIR_TILE) +
      sizeof(float2) * (size_t)(p.P < PAIR_TILE ? p.P : PAIR_TILE);
  if (a->lit)
    pair_lit_kernel<Op>
        <<<grid, PAIR_THREADS, smem, (cudaStream_t)stream>>>(p);
  else
    pair_items_kernel<Op>
        <<<grid, PAIR_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace geomk
