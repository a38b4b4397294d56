// Fused polygon refine for Hopper (sm_90a): the certainty-band
// point-in-polygon classifier together with the fused program's refine masks.
//
// Replaces the Pallas kernel geomesa_tpu/index/compiled.py:_pallas_pip (the
// pl.pallas_call that tiles scan._pip_band) and the masks the reference's
// refine_of applies to its flags (compiled.py:517). For candidate i with
// mask bit m[i] (all ones when there is no mask):
//
//     hit[i] = m[i] & certainly-inside,   unc[i] = m[i] & uncertain
//
// under the half-open crossing rule: an orientation sign counts only outside
// its error bound, and a vertex y within DY_BAND of the point's y makes the
// point uncertain. Candidate i reads row starts[i / bsz] + i % bsz of the
// coordinate columns (the pruned branch's gathered blocks, the last one
// clamped), or row i when there are no starts; with a device count of live
// blocks (block_gate.cu's), only their candidates. Uncertain rows
// re-evaluate on the host in f64.
//
// What bounds it on the card: per candidate it reads 1 mask byte and writes
// 2 flag bytes; per live candidate it reads 8 bytes of coordinates; per
// (live point, real edge) pair it does 18 f32 operations (12 additions,
// subtractions and multiplications, 6 comparisons). At the H100's 3.35 TB/s
// and 67 TFLOP/s that is bound by bytes up to about a dozen real edges per
// live point and by operations beyond. With -fmad=false there is no FMA, so
// against the data sheet's 67 TFLOP/s (an FMA counted as 2) the operation
// bound is reachable only to about 50%. Tensor cores cannot serve: the
// orientation must round as separate f32 operations, and TF32 products would
// flip flags near the band's edges.
//
// Design:
// - Only live rows are classified. A warp takes a tile of 32*K candidates,
//   K contiguous ones per lane; each lane reads its K mask bytes, the warp
//   ballots them and packs the live candidates densely across lanes by
//   prefix popcount (rank = live candidates in lower lanes + live slots
//   below in this lane), so lane j holds ranks j, j+32, ... in registers.
//   Only live points read coordinates, through the block starts. Flags go
//   back to their candidate slots through a per-warp byte array in shared
//   memory, and each lane writes its K hit and K unc bytes with one 8-byte
//   store each where the tile is whole and aligned; the ragged tail is
//   masked here, the host pads nothing. Dead rows read no coordinates and
//   get hit = unc = 0. A warp reads its next tile's mask bytes while it
//   works on the current tile, so only the coordinate gathers wait on the
//   memory.
// - Per-edge terms are hoisted. Each edge is staged once per CTA with its
//   d1x, d1y, |d1x| + |d1y| and upward flag beside the raw row; these are
//   single f32 operations on f32 inputs, so they round exactly as they did
//   inside the pair loop. |y1 - y| is |d2y| (round-to-nearest subtraction is
//   antisymmetric), so the y1 band test reuses d2y.
// - Persistent CTAs: a grid of as many CTAs as fit on the SMs strides over
//   the tiles. Up to CHUNK real edges, the table is staged once per CTA and
//   warps then run with no block barrier. Larger tables go through two
//   shared-memory buffers: the next chunk's rows copy in with cp.async while
//   the current chunk is hoisted and consumed, and every point's parity and
//   uncertainty stay in registers across chunks.
// - Pad edges are skipped: the caller passes the count of real edges (the
//   rows before the EDGE_PAD filler, which can set neither a crossing nor
//   a band flag).
//
// - Each point's crossing parity and uncertainty are one bit of two words
//   a lane keeps, flipped or set by predicated bit operations: K bool
//   registers each would not fit the predicate file and cost moves and
//   selects in every pair.
//
// Choices: K = 8 (one 8-byte word of mask and flag bytes a lane, 8
// independent points a lane for the edge loop), 8 warps a CTA, CHUNK = 512
// edges (two 16 KB buffers), and at least 3 CTAs an SM (__launch_bounds__),
// which on the card (NVIDIA H100 80GB HBM3) gave fewer instructions a pair
// than the unbounded build. ptxas: 80 registers, 36,864 bytes of static
// shared memory, no spills; the inner loop is 183 SASS instructions for 8
// pairs (22.875 a pair; 18 of them the f32 operations counted above). K,
// the warp count and CHUNK were not swept.
//
// Bit-exactness: the flags must equal the plain version (index/scan.py
// pip_refine, itself equal to the JAX package's composition). Every product
// and sum is written with the round-to-nearest intrinsics and every other
// operation keeps the plain version's order, so no multiply-add is
// contracted into an FMA (the build also passes -fmad=false) and denormals
// are kept (no -ftz, no fast math); the error-bound constants arrive from the
// host as the same f32 values the plain version uses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int K = 8;            // candidates per lane in a tile
constexpr int TILE = 32 * K;    // candidates per warp tile
constexpr int CHUNK = 512;      // edges per shared-memory buffer
constexpr unsigned FULL = 0xffffffffu;
static_assert(K == 8, "a lane's mask and flag bytes move as one 8-byte word");

struct __align__(16) Edge {
  float4 raw;  // x1, y1, x2, y2: the cp.async target
  float4 hz;   // d1x, d1y, |d1x| + |d1y|, upward (1 or 0)
};

struct Params {
  const float* xf;
  const float* yf;
  const uint8_t* mask;       // null: every candidate is live
  const long long* starts;   // null: candidate i is row i
  const int* nlive;          // null, or the live slots of starts: only
                             // their candidates are read and written
  long long bsz;
  int bsz_shift;             // log2(bsz) when bsz is a power of two, else -1
  const float4* edges;
  int ne;                    // real edges
  long long n;               // candidates
  float tol_t, tol_d, dy_band;
  uint8_t* hit;
  uint8_t* unc;
  int aligned;               // mask, hit and unc all 8-byte aligned
};

// one warp's tile: the lane's live slots, and its packed points: their
// coordinates, crossing parity (bit s for point s) and uncertainty
struct Tile {
  long long base;
  unsigned bits;
  int total;
  float x[K], y[K];
  unsigned par, unc;
};

__device__ __forceinline__ void stage(Edge* buf, const float4* edges,
                                      int first, int m) {
  for (int k = threadIdx.x; k < m; k += THREADS) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&buf[k].raw);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(edges + first + k) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void hoist(Edge* buf, int m) {
  for (int k = threadIdx.x; k < m; k += THREADS) {
    const float4 e = buf[k].raw;
    const float d1x = __fsub_rn(e.z, e.x);
    const float d1y = __fsub_rn(e.w, e.y);
    buf[k].hz = make_float4(d1x, d1y, __fadd_rn(fabsf(d1x), fabsf(d1y)),
                            e.w > e.y ? 1.0f : 0.0f);
  }
}

__device__ __forceinline__ bool whole(const Params& p, int n,
                                      long long base) {
  return p.aligned && base + TILE <= n;
}

// The lane's 8 mask bytes of a whole tile (0 when the tile is ragged or
// there is no mask): read one tile ahead, so the read overlaps the current
// tile's coordinate gathers and arithmetic.
__device__ __forceinline__ unsigned long long mask_word(const Params& p,
                                                        int n,
                                                        long long tile,
                                                        int lane) {
  const long long base = tile * TILE;
  if (!p.mask || !whole(p, n, base)) return 0ull;
  return *reinterpret_cast<const unsigned long long*>(
      p.mask + base + (long long)lane * K);
}

// Packs the tile's live candidates (its mask word `w` from mask_word) across
// the warp and loads their coordinates; `list` maps rank -> slot in the tile.
__device__ __forceinline__ void load_tile(const Params& p, int n,
                                          long long tile,
                                          unsigned long long w, int lane,
                                          uint8_t* list, Tile& t) {
  t.base = tile * TILE;
  const long long mine = t.base + (long long)lane * K;
  unsigned bits = 0;
  if (whole(p, n, t.base)) {
    if (p.mask) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        bits |= (unsigned)(((w >> (8 * k)) & 0xffull) != 0ull) << k;
    } else {
      bits = (1u << K) - 1u;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = mine + k;
      if (i < n && (!p.mask || p.mask[i])) bits |= 1u << k;
    }
  }
  const unsigned lower = (1u << lane) - 1u;
  int rank = 0, total = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned b = __ballot_sync(FULL, (bits >> k) & 1u);
    rank += __popc(b & lower);
    total += __popc(b);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((bits >> k) & 1u) list[rank++] = (uint8_t)(lane * K + k);
  __syncwarp();
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int q = lane + 32 * s;
    float x = 0.0f, y = 0.0f;
    if (q < total) {
      const long long i = t.base + list[q];
      long long row = i;
      if (p.starts) {
        const long long b = p.bsz_shift >= 0 ? (i >> p.bsz_shift) : i / p.bsz;
        row = p.starts[b] + (i - b * p.bsz);
      }
      x = p.xf[row];
      y = p.yf[row];
    }
    t.x[s] = x;
    t.y[s] = y;
  }
  t.par = 0u;
  t.unc = 0u;
  t.bits = bits;
  t.total = total;
}

// S packed points per lane against edges es[0, m)
template <int S>
__device__ __forceinline__ void classify(const Params& p, const Edge* es,
                                         int m, Tile& t) {
  unsigned par = t.par, unc = t.unc;
  for (int k = 0; k < m; ++k) {
    const float4 r = es[k].raw;
    const float4 h = es[k].hz;
    const float x1 = r.x, y1 = r.y, y2 = r.w;
    const float d1x = h.x, d1y = h.y, s1 = h.z;
    const bool upward = h.w != 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float x = t.x[s], y = t.y[s];
      const bool cond = (y1 > y) != (y2 > y);
      // orientation of (e1, e2, p) with its error bound
      const float d2x = __fsub_rn(x, x1);
      const float d2y = __fsub_rn(y, y1);
      const float t1 = __fmul_rn(d1x, d2y);
      const float t2 = __fmul_rn(d1y, d2x);
      const float det = __fsub_rn(t1, t2);
      const float sd = __fadd_rn(__fadd_rn(s1, fabsf(d2x)), fabsf(d2y));
      const float tol = __fadd_rn(
          __fmul_rn(p.tol_t, __fadd_rn(fabsf(t1), fabsf(t2))),
          __fmul_rn(p.tol_d, sd));
      // det < -tol is -det > tol exactly (negation is exact); the flags
      // combine bitwise, not short-circuit, into predicated bit updates
      const float sdet = upward ? det : -det;
      if (cond & (sdet > tol)) par ^= 1u << s;
      if ((cond & (fabsf(det) <= tol)) | (fabsf(d2y) <= p.dy_band)
          | (fabsf(__fsub_rn(y2, y)) <= p.dy_band))
        unc |= 1u << s;
    }
  }
  t.par = par;
  t.unc = unc;
}

// warp-uniform dispatch on the packed points per lane
__device__ __forceinline__ void classify_live(const Params& p, const Edge* es,
                                              int m, Tile& t) {
  switch ((t.total + 31) >> 5) {
    case 0: break;
    case 1: classify<1>(p, es, m, t); break;
    case 2: classify<2>(p, es, m, t); break;
    case 3: classify<3>(p, es, m, t); break;
    case 4: classify<4>(p, es, m, t); break;
    case 5: classify<5>(p, es, m, t); break;
    case 6: classify<6>(p, es, m, t); break;
    case 7: classify<7>(p, es, m, t); break;
    default: classify<8>(p, es, m, t); break;
  }
}

// Scatters the packed flags back to their slots, then writes the lane's K
// hit and unc bytes (dead slots 0).
__device__ __forceinline__ void store_tile(const Params& p, int n,
                                           int lane,
                                           const uint8_t* list, uint8_t* res,
                                           const Tile& t) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int q = lane + 32 * s;
    if (q < t.total) {
      const unsigned par = (t.par >> s) & 1u, unc = (t.unc >> s) & 1u;
      res[list[q]] = (uint8_t)((par & ~unc) | (unc << 1));
    }
  }
  __syncwarp();
  const unsigned long long w =
      *reinterpret_cast<const unsigned long long*>(res + lane * K);
  unsigned long long live = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    live |= (unsigned long long)((t.bits >> k) & 1u) << (8 * k);
  const unsigned long long hw = w & live;
  const unsigned long long uw = (w >> 1) & live;
  const long long mine = t.base + (long long)lane * K;
  if (whole(p, n, t.base)) {
    *reinterpret_cast<unsigned long long*>(p.hit + mine) = hw;
    *reinterpret_cast<unsigned long long*>(p.unc + mine) = uw;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (mine + k < n) {
        p.hit[mine + k] = (uint8_t)((hw >> (8 * k)) & 1u);
        p.unc[mine + k] = (uint8_t)((uw >> (8 * k)) & 1u);
      }
    }
  }
  __syncwarp();  // list and res are rewritten by the warp's next tile
}

__global__ void __launch_bounds__(THREADS, 3)
pip_refine_kernel(const __grid_constant__ Params p) {
  // the candidates: with nlive, the block list's live ones (read on the
  // device); 32-bit (the launch checks n < 2^31), so that the count and the
  // tile loop's bounds take no more registers than p.n did from the
  // parameter space
  int n = (int)p.n;
  if (p.nlive) {
    const long long live = (long long)max(*p.nlive, 0) * p.bsz;
    if (live < n) n = (int)live;
  }
  __shared__ Edge s_edge[2][CHUNK];
  __shared__ __align__(8) uint8_t s_list[WARPS][TILE];
  __shared__ __align__(8) uint8_t s_res[WARPS][TILE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint8_t* list = s_list[warp];
  uint8_t* res = s_res[warp];
  const int ntiles = (n + TILE - 1) / TILE;
  const int stride = gridDim.x * WARPS;
  const int nchunks = max(1, (p.ne + CHUNK - 1) / CHUNK);

  if (nchunks == 1) {
    // the whole table once per CTA; warps then run free of block barriers
    stage(s_edge[0], p.edges, 0, p.ne);
    wait_staged();
    __syncthreads();
    hoist(s_edge[0], p.ne);
    __syncthreads();
    int tile = blockIdx.x * WARPS + warp;
    unsigned long long w = mask_word(p, n, tile, lane);
    for (; tile < ntiles; tile += stride) {
      const unsigned long long w_next = mask_word(p, n, tile + stride, lane);
      Tile t;
      load_tile(p, n, tile, w, lane, list, t);
      classify_live(p, s_edge[0], p.ne, t);
      store_tile(p, n, lane, list, res, t);
      w = w_next;
    }
    return;
  }

  // larger tables: the CTA's warps take one tile each per round and walk the
  // chunks together, double-buffered
  unsigned long long w = mask_word(p, n, blockIdx.x * WARPS + warp, lane);
  for (int first = blockIdx.x * WARPS; first < ntiles; first += stride) {
    const int tile = first + warp;
    const bool active = tile < ntiles;  // warp-uniform
    const unsigned long long w_next = mask_word(p, n, tile + stride, lane);
    Tile t;
    t.total = 0;
    if (active) load_tile(p, n, tile, w, lane, list, t);
    w = w_next;
    stage(s_edge[0], p.edges, 0, CHUNK);
    for (int c = 0; c < nchunks; ++c) {
      const int m = min(CHUNK, p.ne - c * CHUNK);
      Edge* buf = s_edge[c & 1];
      wait_staged();
      __syncthreads();  // chunk c landed; every warp is done with chunk c-1
      if (c + 1 < nchunks)
        stage(s_edge[(c + 1) & 1], p.edges, (c + 1) * CHUNK,
              min(CHUNK, p.ne - (c + 1) * CHUNK));
      hoist(buf, m);
      __syncthreads();
      if (active) classify_live(p, buf, m, t);
    }
    __syncthreads();  // both buffers free before the next round stages
    if (active) store_tile(p, n, lane, list, res, t);
  }
}

int g_sms[64];
int g_ctas[64];

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns the launch's
// cudaError_t (0 on success); the caller raises on non-zero. `mask`,
// `starts` and `nlive` may be null; `edges` holds at least `ne` 16-byte
// aligned rows. With nlive (a device count of live slots of starts, as
// block_gate.cu writes it) the grid is sized for n candidates and only the
// first *nlive * bsz are read and written.
extern "C" int pip_refine_launch(const float* xf, const float* yf,
                                 const uint8_t* mask, const long long* starts,
                                 const int* nlive,
                                 long long bsz, const float* edges, int ne,
                                 long long n, float tol_t, float tol_d,
                                 float dy_band, uint8_t* hit, uint8_t* unc,
                                 void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL - TILE) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (g_ctas[dev] == 0) {
    int sms = 0, ctas = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, pip_refine_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    g_sms[dev] = sms;
    g_ctas[dev] = ctas > 0 ? ctas : 1;
  }
  Params p;
  p.xf = xf;
  p.yf = yf;
  p.mask = mask;
  p.starts = starts;
  p.nlive = nlive;
  p.bsz = bsz;
  p.bsz_shift = -1;
  if (bsz > 0 && (bsz & (bsz - 1)) == 0) {
    p.bsz_shift = 0;
    while ((1ll << p.bsz_shift) < bsz) ++p.bsz_shift;
  }
  p.edges = reinterpret_cast<const float4*>(edges);
  p.ne = ne;
  p.n = n;
  p.tol_t = tol_t;
  p.tol_d = tol_d;
  p.dy_band = dy_band;
  p.hit = hit;
  p.unc = unc;
  p.aligned = (((uintptr_t)mask | (uintptr_t)hit | (uintptr_t)unc) & 7u) == 0;
  const long long ntiles = (n + TILE - 1) / TILE;
  const long long want = (ntiles + WARPS - 1) / WARPS;
  const long long fit = (long long)g_sms[dev] * g_ctas[dev];
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  pip_refine_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* pip_refine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
