// Point-in-polygon join of a point column against a polygon set, for
// Hopper (sm_90a): per-polygon hit counts (COUNTS) or the first matching
// polygon of each point (ASSIGN).
//
// Replaces the reference's XLA programs `contains_matrix_kernel` and
// `assign_kernel` (geomesa_tpu/parallel/join.py:86, :103), which vmap
// `_pip_block` (:72) over the polygons: every point meets every polygon's
// padded edges. Per polygon p and point q: q lies in p's bbox (original
// frame, f32) and is masked in, and the ray from q (recentred frame:
// px - center) crosses an odd number of p's real edges, a crossing being
// (y1 > y) != (y2 > y) and x < x1 + t * (x2 - x1), t = (y - y1) / (y2 - y1).
// The arithmetic is XLA's on the CPU, as the plain versions
// (geomesa_tpu_torch/parallel/join.py) emulate it: inputs and results
// flushed to zeros of their sign (PTX .ftz), the IEEE division, and
// x1 + t * (x2 - x1) as one fma.rn.ftz(t, x2 - x1, x1).
//
// What bounds it on the card: operations. A (point, edge) pair of a point
// in the polygon's bbox is two compares and their xor; a straddling edge
// adds a division and an fma. The points (8 bytes each and the mask) are
// read once.
//
// Design (a simple first version): a block takes TILE points into
// registers (original frame) and shared memory (recentred) once, and walks
// the polygons in order. For each it compacts its points that are live and
// in the bbox (shared atomics; most points of a block are outside any one
// bbox), stages the polygon's edges in shared memory in tiles of EDGE_TILE
// (skipped when no point of the block is in the bbox), and gives each
// compacted point a warp whose lanes split the edges; the parity is a
// ballot's popcount. The owner thread of a point then counts it (a warp
// sum and one integer atomicAdd a warp: exact in any order) or, in ASSIGN,
// writes p and drops the point from the later polygons: the first
// matching polygon, as the reference's argmax over the hit matrix.

#include <cstdint>
#include <cuda_runtime.h>

#include "geom_common.cuh"

namespace {

using geomk::zdiv;
using geomk::zfma;
using geomk::zin;
using geomk::zin4;
using geomk::zsub;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PTS = 16;                    // points a thread
constexpr int TILE = THREADS * PTS;        // 4,096 points a block
constexpr int EDGE_TILE = 2048;            // edges staged at once (32 KB)
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM = EDGE_TILE * sizeof(float4) + 2 * TILE * sizeof(float)
                        + TILE * sizeof(short) + TILE;

__global__ void __launch_bounds__(THREADS, 2)
pip_join_kernel(const float* __restrict__ px, const float* __restrict__ py,
                const unsigned char* __restrict__ mask, long long n,
                const float4* __restrict__ edges,
                const int* __restrict__ n_edges, int P, int E,
                const float4* __restrict__ bboxes,
                const float* __restrict__ center, int assign,
                int* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* s_e = smem;
  float* s_xc = reinterpret_cast<float*>(smem + EDGE_TILE);
  float* s_yc = s_xc + TILE;
  short* s_idx = reinterpret_cast<short*>(s_yc + TILE);
  unsigned char* s_par = reinterpret_cast<unsigned char*>(s_idx + TILE);
  __shared__ int s_n[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  const float cx = zin(center[0]);
  const float cy = zin(center[1]);

  float x[PTS], y[PTS];
  unsigned live = 0;  // bit k: the thread's point k is in range and masked in
#pragma unroll
  for (int k = 0; k < PTS; ++k) {
    const long long i = base + k * THREADS + tid;
    x[k] = y[k] = 0.0f;
    if (i < n) {
      x[k] = zin(px[i]);
      y[k] = zin(py[i]);
      s_xc[k * THREADS + tid] = zsub(x[k], cx);
      s_yc[k * THREADS + tid] = zsub(y[k], cy);
      if (mask == nullptr || mask[i]) live |= 1u << k;
      if (assign) out[i] = -1;
    }
  }
  if (tid == 0) s_n[0] = s_n[1] = 0;
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const int b = p & 1;
    const float4 bb = zin4(bboxes[p]);
    unsigned inb = 0;
#pragma unroll
    for (int k = 0; k < PTS; ++k) {
      if ((live >> k & 1u) && x[k] >= bb.x && x[k] <= bb.z && y[k] >= bb.y &&
          y[k] <= bb.w) {
        inb |= 1u << k;
        const int slot = atomicAdd(&s_n[b], 1);
        s_idx[slot] = (short)(k * THREADS + tid);
        s_par[k * THREADS + tid] = 0;
      }
    }
    __syncthreads();
    const int m = s_n[b];
    if (m > 0) {
      const int ne = n_edges[p];
      const float4* pe = edges + (long long)p * E;
      for (int e0 = 0; e0 < ne; e0 += EDGE_TILE) {
        const int nt = min(EDGE_TILE, ne - e0);
        for (int e = tid; e < nt; e += THREADS) s_e[e] = zin4(pe[e0 + e]);
        __syncthreads();
        for (int j = warp; j < m; j += WARPS) {
          const int i = s_idx[j];
          const float qx = s_xc[i];
          const float qy = s_yc[i];
          unsigned par = 0;
          for (int e = lane; e < nt; e += 32) {
            const float4 ed = s_e[e];
            if ((ed.y > qy) != (ed.w > qy)) {
              const float den = ed.w == ed.y ? 1.0f : zsub(ed.w, ed.y);
              const float t = zdiv(zsub(qy, ed.y), den);
              if (qx < zfma(t, zsub(ed.z, ed.x), ed.x)) par ^= 1u;
            }
          }
          par = __popc(__ballot_sync(FULL, par != 0)) & 1;
          if (lane == 0 && par) s_par[i] ^= 1;
        }
        __syncthreads();
      }
      int c = 0;
#pragma unroll
      for (int k = 0; k < PTS; ++k) {
        if ((inb >> k & 1u) && s_par[k * THREADS + tid]) {
          if (assign) {
            out[base + k * THREADS + tid] = p;
            live &= ~(1u << k);
          } else {
            ++c;
          }
        }
      }
      if (!assign) {
        c = __reduce_add_sync(FULL, c);
        if (lane == 0 && c) atomicAdd(&out[p], c);
      }
    }
    // the other counter was last read before this polygon's barrier and is
    // next written after the one below
    if (tid == 0) s_n[b ^ 1] = 0;
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream of device `dev`) and
// returns the launch's cudaError_t (0 on success). COUNTS (assign 0) adds
// into out[P], which the caller zeroes; ASSIGN (assign 1) writes out[n].
// `mask` may be null (every point in).
extern "C" int pip_join_launch(const float* px, const float* py,
                               const unsigned char* mask, long long n,
                               const float4* edges, const int* n_edges, int P,
                               int E, const float4* bboxes,
                               const float* center, int assign, int* out,
                               int dev, void* stream) {
  (void)dev;
  if (n < 0 || P < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || P == 0) return 0;
  const long long grid = (n + TILE - 1) / TILE;
  if (grid > 0x7fffffffll) return (int)cudaErrorInvalidConfiguration;
  cudaError_t rc = cudaFuncSetAttribute(
      pip_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (rc != cudaSuccess) return (int)rc;
  pip_join_kernel<<<(unsigned)grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      px, py, mask, n, edges, n_edges, P, E, bboxes, center, assign, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pip_join_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
