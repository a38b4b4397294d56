// Radial-distance refine for Hopper (sm_90a): the fused program's banded
// "dist" refine kind.
//
// Replaces the reference's dist refine, an XLA computation inside the fused
// program (geomesa_tpu/index/compiled.py:508, refine_of for the "dist"
// kind), which classifies the masked candidate rows of
// `st_distance(geom, POINT(cx cy)) < r` (or <= r). For candidate i with
// mask bit m[i] (all ones when there is no mask), in f32:
//
//     d      = sqrt((x - cx)^2 + (y - cy)^2)
//     hit[i] = m[i] & (d <= r - DIST_BAND)
//     unc[i] = m[i] & !(d <= r - DIST_BAND) & !(d >= r + DIST_BAND)
//
// Candidate i reads row starts[i / bsz] + i % bsz of the coordinate
// columns (the pruned branch's gathered blocks, the last one clamped), or
// row i when there are no starts. Uncertain rows re-evaluate on the host in
// f64. The host passes cx, cy and the two band bounds r - DIST_BAND and
// r + DIST_BAND already rounded in f32, as the reference's traced program
// rounds them.
//
// What bounds it on the card: bytes. Per candidate it reads 1 mask byte
// and writes 2 flag bytes; per live candidate it reads 8 bytes of
// coordinates (through the block starts) and does 7 f32 operations and 2
// compares, far under the operation rate.
//
// Design (a simple first version): each thread takes 4 consecutive
// candidates a step of a grid-stride loop, reading their 4 mask bytes as
// one 32-bit word and writing 4 hit and 4 unc bytes as one 32-bit word
// each where the buffers are 4-byte aligned; the ragged tail (and unaligned
// buffers) take one candidate a step. Dead candidates read no coordinates.
//
// Bit-exactness: the flags must equal the plain version (index/scan.py
// dist_refine, itself equal to the JAX package's composition). The
// subtractions, products, sum and square root are the round-to-nearest
// intrinsics in the plain version's order, so nothing is contracted into
// an FMA (the build also passes -fmad=false) and the square root is the
// IEEE one, not the approximate sqrt of fast math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

struct Params {
  const float* xf;
  const float* yf;
  const uint8_t* mask;       // null: every candidate is live
  const long long* starts;   // null: candidate i is row i
  long long bsz;
  int bsz_shift;             // log2(bsz) when bsz is a power of two, else -1
  long long n;               // candidates
  float cx, cy, rlo, rhi;
  uint8_t* hit;
  uint8_t* unc;
  int vec;                   // mask, hit and unc all 4-byte aligned
};

__device__ __forceinline__ long long row_of(const Params& p, long long i) {
  if (p.starts == nullptr) return i;
  if (p.bsz_shift >= 0)
    return p.starts[i >> p.bsz_shift] + (i & (p.bsz - 1));
  return p.starts[i / p.bsz] + i % p.bsz;
}

// (hit, unc) of one live candidate as 0/1
__device__ __forceinline__ void classify(const Params& p, long long i,
                                         unsigned& h, unsigned& u) {
  const long long r = row_of(p, i);
  const float dx = __fsub_rn(p.xf[r], p.cx);
  const float dy = __fsub_rn(p.yf[r], p.cy);
  const float d = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  h = d <= p.rlo;
  u = !h && !(d >= p.rhi);
}

__global__ void __launch_bounds__(THREADS)
dist_refine_kernel(Params p) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n4 = p.vec ? p.n / 4 : 0;
  const uint32_t* mask4 = reinterpret_cast<const uint32_t*>(p.mask);
  uint32_t* hit4 = reinterpret_cast<uint32_t*>(p.hit);
  uint32_t* unc4 = reinterpret_cast<uint32_t*>(p.unc);
  for (long long q = tid; q < n4; q += stride) {
    const uint32_t m = p.mask ? mask4[q] : 0x01010101u;
    uint32_t hw = 0, uw = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((m >> (8 * k)) & 0xffu) {
        unsigned h, u;
        classify(p, 4 * q + k, h, u);
        hw |= h << (8 * k);
        uw |= u << (8 * k);
      }
    }
    hit4[q] = hw;
    unc4[q] = uw;
  }
  for (long long i = 4 * n4 + tid; i < p.n; i += stride) {
    unsigned h = 0, u = 0;
    if (p.mask == nullptr || p.mask[i]) classify(p, i, h, u);
    p.hit[i] = (uint8_t)h;
    p.unc[i] = (uint8_t)u;
  }
}

int g_sms[64];

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns the launch's
// cudaError_t (0 on success); the caller raises on non-zero. `mask` and
// `starts` may be null.
extern "C" int dist_refine_launch(const float* xf, const float* yf,
                                  const uint8_t* mask, const long long* starts,
                                  long long bsz, long long n, float cx,
                                  float cy, float rlo, float rhi,
                                  uint8_t* hit, uint8_t* unc, void* stream) {
  if (n <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    g_sms[dev] = sms > 0 ? sms : 1;
  }
  Params p;
  p.xf = xf;
  p.yf = yf;
  p.mask = mask;
  p.starts = starts;
  p.bsz = bsz;
  p.bsz_shift = -1;
  if (bsz > 0 && (bsz & (bsz - 1)) == 0) {
    p.bsz_shift = 0;
    while ((1ll << p.bsz_shift) < bsz) ++p.bsz_shift;
  }
  p.n = n;
  p.cx = cx;
  p.cy = cy;
  p.rlo = rlo;
  p.rhi = rhi;
  p.hit = hit;
  p.unc = unc;
  p.vec = (((uintptr_t)mask | (uintptr_t)hit | (uintptr_t)unc) & 3u) == 0;
  const long long steps = (n + 3) / 4;
  const long long want = (steps + THREADS - 1) / THREADS;
  const long long fit = (long long)g_sms[dev] * BLOCKS_PER_SM;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  dist_refine_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* dist_refine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
