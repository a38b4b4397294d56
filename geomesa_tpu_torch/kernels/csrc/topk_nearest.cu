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
// cos(la2)) * sin(dlo / 2)^2, d = 2R * asin(sqrt(clip(a, 0, 1))). CUDA's
// sinf/cosf/asinf are not XLA's CPU functions, so the distances agree with
// the reference within a tolerance (the tests state it), not bit for bit.
//
// What bounds it on the card: bytes — each candidate's mask byte and the 8
// bytes of coordinates of each candidate whose mask is set (a handful of
// transcendental f32 operations a candidate stay far below the operation
// bound). This design adds traffic of its own on top: a 4-byte key a
// candidate, written once and read by each of the passes after the first.
//
// Design (simple and right first), six launches on one stream, no host
// sync between them:
// 1. keys: each CTA takes a contiguous chunk of candidates and writes each
//    one's key, the bits of its f32 distance (ascending with the distance,
//    since d >= 0; +inf for a masked-out candidate), with a histogram of the
//    keys' top 11 bits (shared memory, one atomic a group of lanes that
//    share a bin, found by __match_any_sync), added into the global one.
// 2, 3. radix select: each CTA first finds, from the histograms so far, the
//    digit in which the m-th smallest key lies (a block scan of the bins),
//    then histograms the next digit (bits 20..10, then 9..0) of the keys
//    that share the prefix. After pass 3 the m-th smallest key T and the
//    number `below` of keys smaller than T are known.
// 4. every key below T is emitted (key << 32 | candidate) into the m
//    output slots through an atomic counter; each CTA counts its keys equal
//    to T.
// 5. the first m - below keys equal to T in candidate order are emitted:
//    each CTA sums the equal counts of the CTAs before it (a block-wide
//    reduction) and walks its chunk in order (a block scan of the equal
//    flags), stopping once full.
// 6. one CTA sorts the m (key, candidate) pairs — 64-bit composites, so by
//    key, then candidate — with a bitonic sort in shared memory (m <= 4096:
//    32 KB), and writes the distances and the positions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int B1 = 2048;      // bits 31..21
constexpr int B2 = 2048;      // bits 20..10
constexpr int B3 = 1024;      // bits 9..0
constexpr int MAX_M = 4096;
constexpr int SORT_THREADS = 1024;

struct Params {
  const float* xf;
  const float* yf;
  const uint8_t* mask;          // one byte a candidate
  const long long* starts;      // BLOCKS: first row of each block
  long long bsz;                // BLOCKS: rows a block
  unsigned n;                   // candidates
  unsigned chunk;               // candidates a CTA
  float qx, qy;                 // the query point (f32)
  float rad;                    // f32(pi / 180)
  float two_r;                  // f32(2 * 6371008.8)
  int m;
  unsigned* keys;               // n
  unsigned* hist;               // B1 + B2 + B3, zero on entry
  unsigned* counter;            // 1, zero on entry: slots taken by pass 4
  unsigned* eq;                 // one a CTA: its keys equal to T
  unsigned long long* pairs;    // m
  float* dist;                  // m, out
  int* pos;                     // m, out
};

struct Sel {
  unsigned digit;
  unsigned long long below;     // keys below the digit's bin (all passes)
};

// the reference's _haversine_f32 of one candidate
__device__ __forceinline__ float haversine(float lon, float lat,
                                           const Params& p) {
  const float la1 = __fmul_rn(lat, p.rad);
  const float la2 = __fmul_rn(p.qy, p.rad);
  const float dla = __fmul_rn(__fsub_rn(p.qy, lat), p.rad);
  const float dlo = __fmul_rn(__fsub_rn(p.qx, lon), p.rad);
  const float s1 = sinf(__fmul_rn(dla, 0.5f));
  const float s2 = sinf(__fmul_rn(dlo, 0.5f));
  float a = __fadd_rn(__fmul_rn(s1, s1),
                      __fmul_rn(__fmul_rn(cosf(la1), cosf(la2)),
                                __fmul_rn(s2, s2)));
  a = a < 0.0f ? 0.0f : (a > 1.0f ? 1.0f : a);   // NaN stays NaN
  return __fmul_rn(p.two_r, asinf(__fsqrt_rn(a)));
}

// candidate i's row: i itself, or through the block starts
template <bool BLOCKS>
__device__ __forceinline__ long long row_of(const Params& p, unsigned i) {
  if (!BLOCKS) return i;
  const unsigned long long b = (unsigned long long)i / (unsigned long long)p.bsz;
  return p.starts[b] + (long long)(i - b * p.bsz);
}

// adds one to sh[bin] for every lane with bin >= 0, one atomic a group of
// lanes that share a bin (all lanes of the warp call it)
__device__ __forceinline__ void add_bin(unsigned* sh, int bin) {
  if (!__any_sync(FULL, bin >= 0)) return;
  const unsigned peers = __match_any_sync(FULL, bin);
  if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&sh[bin], __popc(peers));
}

// the digit of `hist` (nb bins, all threads of the block call it) in which
// the m-th smallest key lies, given `below0` keys below the bins: the
// smallest d with below0 + hist[0..d] >= m, and the keys below its bin
__device__ void select_digit(const unsigned* hist, int nb,
                             unsigned long long below0, unsigned long long m,
                             Sel* out) {
  __shared__ unsigned long long part[THREADS];
  const int t = threadIdx.x;
  const int per = nb / THREADS;
  unsigned long long s = 0;
  for (int k = 0; k < per; ++k) s += hist[t * per + k];
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {
    const unsigned long long v = t >= off ? part[t - off] : 0ull;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  const unsigned long long excl = t ? part[t - 1] : 0ull;
  if (below0 + excl < m && below0 + part[t] >= m) {
    unsigned long long c = below0 + excl;
    for (int k = 0; k < per; ++k) {
      const unsigned h = hist[t * per + k];
      if (c + h >= m) {
        out->digit = (unsigned)(t * per + k);
        out->below = c;
        break;
      }
      c += h;
    }
  }
  __syncthreads();
}

// the prefix chosen after `passes` histograms: T's top bits and the keys
// below them (every CTA recomputes it from the global histograms)
__device__ void select_prefix(const Params& p, int passes, unsigned* prefix,
                              unsigned long long* below) {
  __shared__ Sel s1, s2, s3;
  select_digit(p.hist, B1, 0ull, (unsigned long long)p.m, &s1);
  unsigned pre = s1.digit;
  unsigned long long bl = s1.below;
  if (passes >= 2) {
    select_digit(p.hist + B1, B2, bl, (unsigned long long)p.m, &s2);
    pre = (pre << 11) | s2.digit;
    bl = s2.below;
  }
  if (passes >= 3) {
    select_digit(p.hist + B1 + B2, B3, bl, (unsigned long long)p.m, &s3);
    pre = (pre << 10) | s3.digit;
    bl = s3.below;
  }
  *prefix = pre;
  *below = bl;
}

__device__ __forceinline__ void chunk_of(const Params& p, unsigned* lo,
                                         unsigned* hi) {
  const unsigned long long a = (unsigned long long)blockIdx.x * p.chunk;
  const unsigned long long b = a + p.chunk;
  *lo = a < p.n ? (unsigned)a : p.n;
  *hi = b < p.n ? (unsigned)b : p.n;
}

template <bool BLOCKS>
__global__ void __launch_bounds__(THREADS) keys_kernel(Params p) {
  __shared__ unsigned sh[B1];
  for (int k = threadIdx.x; k < B1; k += THREADS) sh[k] = 0;
  __syncthreads();
  unsigned lo, hi;
  chunk_of(p, &lo, &hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (unsigned base = lo + warp * 32 * UNROLL; base < hi;
       base += THREADS * UNROLL) {
    unsigned key[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned i = base + u * 32 + lane;
      key[u] = 0xffffffffu;
      if (i < hi) {
        float d = __int_as_float(0x7f800000);    // +inf: masked out
        if (p.mask[i]) {
          const long long r = row_of<BLOCKS>(p, i);
          d = haversine(p.xf[r], p.yf[r], p);
        }
        key[u] = __float_as_uint(d);
        p.keys[i] = key[u];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      add_bin(sh, base + u * 32 + lane < hi ? (int)(key[u] >> 21) : -1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < B1; k += THREADS)
    if (sh[k]) atomicAdd(&p.hist[k], sh[k]);
}

// pass 2 (PASS = 2) histograms bits 20..10 of the keys under the pass-1
// prefix; pass 3 bits 9..0 under the pass-2 prefix
template <int PASS>
__global__ void __launch_bounds__(THREADS) refine_kernel(Params p) {
  constexpr int NB = PASS == 2 ? B2 : B3;
  constexpr int SHIFT = PASS == 2 ? 21 : 10;
  __shared__ unsigned sh[NB];
  __shared__ unsigned prefix;
  __shared__ unsigned long long below;
  for (int k = threadIdx.x; k < NB; k += THREADS) sh[k] = 0;
  unsigned pre;
  unsigned long long bl;
  select_prefix(p, PASS - 1, &pre, &bl);
  if (threadIdx.x == 0) {
    prefix = pre;
    below = bl;
  }
  __syncthreads();
  unsigned lo, hi;
  chunk_of(p, &lo, &hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (unsigned base = lo + warp * 32 * UNROLL; base < hi;
       base += THREADS * UNROLL) {
    unsigned key[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned i = base + u * 32 + lane;
      key[u] = i < hi ? p.keys[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = base + u * 32 + lane < hi && (key[u] >> SHIFT) == prefix;
      add_bin(sh, in ? (int)((key[u] >> (SHIFT - (PASS == 2 ? 11 : 10)))
                             & (NB - 1)) : -1);
    }
  }
  __syncthreads();
  unsigned* g = p.hist + (PASS == 2 ? B1 : B1 + B2);
  for (int k = threadIdx.x; k < NB; k += THREADS)
    if (sh[k]) atomicAdd(&g[k], sh[k]);
}

// pass 4: every key below T into the slots by an atomic counter; each CTA's
// count of keys equal to T
__global__ void __launch_bounds__(THREADS) below_kernel(Params p) {
  __shared__ unsigned eq;
  unsigned T;
  unsigned long long bl;
  select_prefix(p, 3, &T, &bl);
  if (threadIdx.x == 0) eq = 0;
  __syncthreads();
  unsigned lo, hi;
  chunk_of(p, &lo, &hi);
  unsigned mine = 0;
  for (unsigned i = lo + threadIdx.x; i < hi; i += THREADS) {
    const unsigned k = p.keys[i];
    if (k < T) {
      const unsigned slot = atomicAdd(p.counter, 1u);
      p.pairs[slot] = ((unsigned long long)k << 32) | i;
    } else if (k == T) {
      ++mine;
    }
  }
  if (mine) atomicAdd(&eq, mine);
  __syncthreads();
  if (threadIdx.x == 0) p.eq[blockIdx.x] = eq;
}

// pass 5: the first m - below keys equal to T, in candidate order
__global__ void __launch_bounds__(THREADS) ties_kernel(Params p) {
  __shared__ unsigned long long sum[THREADS];
  __shared__ unsigned warp_sum[THREADS / 32];
  unsigned T;
  unsigned long long bl;
  select_prefix(p, 3, &T, &bl);
  const unsigned long long need = (unsigned long long)p.m - bl;
  // the equal keys of the CTAs before this one, summed by the block
  unsigned long long s = 0;
  for (unsigned c = threadIdx.x; c < blockIdx.x; c += THREADS) s += p.eq[c];
  sum[threadIdx.x] = s;
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sum[threadIdx.x] += sum[threadIdx.x + off];
    __syncthreads();
  }
  const unsigned long long before = sum[0];
  if (before >= need || p.eq[blockIdx.x] == 0) return;
  unsigned lo, hi;
  chunk_of(p, &lo, &hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long taken = before;        // ties emitted before this tile
  for (unsigned base = lo; base < hi && taken < need; base += THREADS) {
    const unsigned i = base + threadIdx.x;
    const bool hit = i < hi && p.keys[i] == T;
    const unsigned ballot = __ballot_sync(FULL, hit);
    if (lane == 0) warp_sum[warp] = __popc(ballot);
    __syncthreads();
    unsigned rank = __popc(ballot & ((1u << lane) - 1u));
    unsigned tile = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) rank += warp_sum[w];
      tile += warp_sum[w];
    }
    if (hit && taken + rank < need)
      p.pairs[bl + taken + rank] = ((unsigned long long)T << 32) | i;
    taken += tile;
    __syncthreads();
  }
}

// pass 6: sort the m pairs, write distances and positions
template <bool BLOCKS>
__global__ void __launch_bounds__(SORT_THREADS) sort_kernel(Params p) {
  __shared__ unsigned long long s[MAX_M];
  int P = 1;
  while (P < p.m) P <<= 1;
  for (int i = threadIdx.x; i < P; i += SORT_THREADS)
    s[i] = i < p.m ? p.pairs[i] : ~0ull;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += SORT_THREADS) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = s[i], b = s[l];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < p.m; i += SORT_THREADS) {
    const unsigned long long v = s[i];
    p.dist[i] = __uint_as_float((unsigned)(v >> 32));
    p.pos[i] = (int)row_of<BLOCKS>(p, (unsigned)(v & 0xffffffffu));
  }
}

template <bool BLOCKS>
cudaError_t launch(const Params& p, int grid, cudaStream_t st) {
  keys_kernel<BLOCKS><<<grid, THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  refine_kernel<2><<<grid, THREADS, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  refine_kernel<3><<<grid, THREADS, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  below_kernel<<<grid, THREADS, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ties_kernel<<<grid, THREADS, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sort_kernel<BLOCKS><<<1, SORT_THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The m (1 <= m <= min(n, 4096)) nearest of n candidates to (qx, qy):
// dist (m f32) and pos (m int32) ascending by (distance, candidate). With
// starts (BLOCKS; may be null for FULL) candidate i reads row starts[i /
// bsz] + i % bsz. Scratch: keys (n words), hist (B1 + B2 + B3 + 1 words,
// zero on entry; the last the slot counter), eq (grid words), pairs (m
// 64-bit words). `grid` CTAs each take ceil(n / grid) candidates. Six
// launches on `stream`; returns the first CUDA error.
extern "C" int topk_nearest_launch(const float* xf, const float* yf,
                                   const uint8_t* mask,
                                   const long long* starts, long long bsz,
                                   unsigned n, float qx, float qy, float rad,
                                   float two_r, int m, int grid,
                                   unsigned* keys, unsigned* hist,
                                   unsigned* eq, unsigned long long* pairs,
                                   float* dist, int* pos, void* stream) {
  if (m < 1 || m > MAX_M || (unsigned)m > n || grid < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xf = xf;
  p.yf = yf;
  p.mask = mask;
  p.starts = starts;
  p.bsz = bsz;
  p.n = n;
  p.chunk = (unsigned)((n + (unsigned)grid - 1) / (unsigned)grid);
  p.qx = qx;
  p.qy = qy;
  p.rad = rad;
  p.two_r = two_r;
  p.m = m;
  p.keys = keys;
  p.hist = hist;
  p.counter = hist + B1 + B2 + B3;
  p.eq = eq;
  p.pairs = pairs;
  p.dist = dist;
  p.pos = pos;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(starts ? launch<true>(p, grid, st) : launch<false>(p, grid, st));
}

extern "C" int topk_nearest_max_m() { return MAX_M; }

extern "C" const char* topk_nearest_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
