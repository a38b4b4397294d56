// Certainty-band point-in-polygon classifier for Hopper (sm_90a).
//
// Replaces the Pallas kernel geomesa_tpu/index/compiled.py:_pallas_pip
// (the pl.pallas_call that tiles scan._pip_band). For each point it gives
// (certainly-inside, certainly-outside) against a polygon edge table under
// the half-open crossing rule: an orientation sign counts only outside its
// error bound, and a vertex y within DY_BAND of the point's y makes the
// point uncertain. Uncertain points are re-evaluated on the host in f64.
//
// What bounds it on the card: per point it reads 8 bytes (px, py) and writes
// 2 (two flags), about 10 B/point; per (point, edge) it does about 26 f32
// additions, multiplications and absolute values plus 6 comparisons. At the
// H100's 3.35 TB/s and 67 TFLOP/s (f32, outside the tensor cores) the work
// is bound by operations once the edge count reaches about 64.
//
// Design: simple and correct first. One thread per point, blocks of 256
// points; the edge table, whose length has no bound, is staged through
// shared memory in chunks of CHUNK edges (32 KB) with a __syncthreads loop,
// and every thread of a block reads the same edge at a time (a shared-memory
// broadcast). Crossing parity is kept as an XOR bit and any uncertainty as
// an OR flag. The ragged tail of points is masked here (no padding rows).
// Keeping edge tiles in registers and giving each thread several points are
// left to a later change.
//
// Bit-exactness: the flags must equal the plain version (index/scan.py
// pip_band, itself equal to the JAX package's _pip_band). Every product and
// sum is written with the round-to-nearest intrinsics, so no multiply-add is
// contracted into an FMA (the build also passes -fmad=false); the error-bound
// constants arrive from the host as the same f32 values the plain version
// uses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 2048;  // edges per shared-memory stage: 2048 * 16 B

__global__ void __launch_bounds__(THREADS)
pip_band_kernel(const float* __restrict__ px, const float* __restrict__ py,
                const float4* __restrict__ edges, long long n, int ne,
                float tol_t, float tol_d, float dy_band,
                uint8_t* __restrict__ cin, uint8_t* __restrict__ cout) {
  __shared__ float4 sedge[CHUNK];
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < n;
  const float x = live ? px[i] : 0.0f;
  const float y = live ? py[i] : 0.0f;
  unsigned parity = 0u;
  bool unc = false;

  for (int base = 0; base < ne; base += CHUNK) {
    const int m = min(CHUNK, ne - base);
    for (int k = threadIdx.x; k < m; k += THREADS) sedge[k] = edges[base + k];
    __syncthreads();
    if (live) {
      for (int k = 0; k < m; ++k) {
        const float4 e = sedge[k];  // (x1, y1, x2, y2)
        const bool a1 = e.y > y;
        const bool a2 = e.w > y;
        const bool cond = a1 != a2;
        // orientation of (e1, e2, p) with its error bound
        const float d1x = __fsub_rn(e.z, e.x);
        const float d1y = __fsub_rn(e.w, e.y);
        const float d2x = __fsub_rn(x, e.x);
        const float d2y = __fsub_rn(y, e.y);
        const float t1 = __fmul_rn(d1x, d2y);
        const float t2 = __fmul_rn(d1y, d2x);
        const float det = __fsub_rn(t1, t2);
        const float sd = __fadd_rn(
            __fadd_rn(__fadd_rn(fabsf(d1x), fabsf(d1y)), fabsf(d2x)),
            fabsf(d2y));
        const float tol = __fadd_rn(
            __fmul_rn(tol_t, __fadd_rn(fabsf(t1), fabsf(t2))),
            __fmul_rn(tol_d, sd));
        const bool upward = e.w > e.y;
        const bool cross = cond && (upward ? (det > tol) : (det < -tol));
        parity ^= (unsigned)cross;
        unc = unc || (cond && fabsf(det) <= tol)
              || fabsf(__fsub_rn(e.y, y)) <= dy_band
              || fabsf(__fsub_rn(e.w, y)) <= dy_band;
      }
    }
    __syncthreads();
  }
  if (live) {
    cin[i] = (uint8_t)(parity && !unc);
    cout[i] = (uint8_t)(!parity && !unc);
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns the launch's
// cudaError_t (0 on success); the caller raises on non-zero.
extern "C" int pip_band_launch(const float* px, const float* py,
                               const float* edges, long long n, int ne,
                               float tol_t, float tol_d, float dy_band,
                               uint8_t* cin, uint8_t* cout, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  pip_band_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      px, py, reinterpret_cast<const float4*>(edges), n, ne, tol_t, tol_d,
      dy_band, cin, cout);
  return (int)cudaGetLastError();
}

extern "C" const char* pip_band_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
