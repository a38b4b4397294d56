// The geometry catalog's unary program for Hopper (sm_90a): st_area,
// st_length and st_centroid of packed features.
//
// Replaces the reference's `_unary_batch` = jit(vmap(_unary_one))
// (geomesa_tpu/geom/catalog.py:224-252), an XLA program. Per feature b of
// the pack (geom/catalog.py pack_features: S padded segments [x1 y1 x2 y2]
// with their mask and shoelace weight, K padded vertices with their mask,
// the centroid mode), in f32 with subnormals flushed:
//
//   cross_j = fma(x1, y2, -(x2 * y1)) * w_j      a2  = sum_j cross_j
//   ln_j    = hypot(x2 - x1, y2 - y1) * m_j      len = sum_j ln_j
//   area    = max(a2 * 0.5, 0)
//   cx      = mode 2: sum fma((x1 + x2), cross) / (3 a2)
//             mode 1: sum fma(ln, (x1 + x2)) / (2 len)
//             mode 0: sum (x * vm) / max(sum vm, 1)          (and cy alike)
//
// hypot is jnp.hypot's body, max * sqrt(fma(r, r, 1)) with r = min / max
// (0 where max is 0), not CUDA's hypotf. Every sum runs left to right over
// the padded rows from the first (the fma sums from 0), as the plain
// version (catalog._unary_plain) does, so the two are equal bit for bit.
//
// What bounds it on the card: bytes. Per feature it reads 16 bytes a
// segment slot, 6 of mask and weight, 9 a vertex slot and the mode, and
// writes 16; it does about 30 f32 operations a segment, far under the
// operation rate.
//
// Design: one thread a feature, grid-stride over the batch (the first
// design: a thread's segment reads are 16-byte loads, contiguous across
// threads where S = 1, as a line layer's). CTAs of 256 threads, up to 8 an
// SM.

#include "geom_common.cuh"

namespace {

using namespace geomk;

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_DEVICES = 64;

struct Params {
  const float* verts;    // (B, K, 2)
  const uint8_t* vmask;  // (B, K)
  const float4* segs;    // (B, S)
  const uint8_t* smask;  // (B, S)
  const float* wsign;    // (B, S)
  const int* mode;       // (B,)
  long long B;
  int K, S;
  float* out;            // (4, B): area, length, cx, cy
};

// jnp.hypot of two flushed f32 values
__device__ __forceinline__ float hypot_z(float a, float b) {
  a = fabsf(a);
  b = fabsf(b);
  const float hi = fmaxf(a, b);
  const float lo = fminf(a, b);
  const float r = zdiv(lo, hi == 0.0f ? 1.0f : hi);
  const float h = hi == 0.0f ? hi : zmul(hi, zsqrt(zfma(r, r, 1.0f)));
  return (isinf(a) || isinf(b)) ? INFINITY : h;
}

__global__ void __launch_bounds__(THREADS)
geom_unary_kernel(Params p) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long b = (long long)blockIdx.x * THREADS + threadIdx.x; b < p.B;
       b += stride) {
    const float4* sg = p.segs + b * p.S;
    const uint8_t* sm = p.smask + b * p.S;
    const float* ws = p.wsign + b * p.S;
    float a2 = 0.0f, len = 0.0f;
    float mx = 0.0f, my = 0.0f, lx = 0.0f, ly = 0.0f;
    for (int j = 0; j < p.S; ++j) {
      const float4 s = zin4(sg[j]);
      const float cross = zmul(zfma(s.x, s.w, -zmul(s.z, s.y)), zin(ws[j]));
      const float ln = zmul(hypot_z(zsub(s.z, s.x), zsub(s.w, s.y)),
                            sm[j] ? 1.0f : 0.0f);
      a2 = j == 0 ? cross : zadd(a2, cross);
      len = j == 0 ? ln : zadd(len, ln);
      const float sx = zadd(s.x, s.z);
      const float sy = zadd(s.y, s.w);
      mx = zfma(sx, cross, mx);
      my = zfma(sy, cross, my);
      lx = zfma(ln, sx, lx);
      ly = zfma(ln, sy, ly);
    }
    const float* vt = p.verts + b * p.K * 2;
    const uint8_t* vm = p.vmask + b * p.K;
    float nv = 0.0f, px = 0.0f, py = 0.0f;
    for (int k = 0; k < p.K; ++k) {
      const float m = vm[k] ? 1.0f : 0.0f;
      const float x = zmul(zin(vt[2 * k]), m);
      const float y = zmul(zin(vt[2 * k + 1]), m);
      nv = k == 0 ? m : zadd(nv, m);
      px = k == 0 ? x : zadd(px, x);
      py = k == 0 ? y : zadd(py, y);
    }
    const float three = zmul(a2 == 0.0f ? 1.0f : a2, 3.0f);
    const float two = zmul(len == 0.0f ? 1.0f : len, 2.0f);
    const float nvc = fmaxf(nv, 1.0f);
    const int mode = p.mode[b];
    float cx, cy;
    if (mode == 2) {
      cx = zdiv(mx, three);
      cy = zdiv(my, three);
    } else if (mode == 1) {
      cx = zdiv(lx, two);
      cy = zdiv(ly, two);
    } else {
      cx = zdiv(px, nvc);
      cy = zdiv(py, nvc);
    }
    p.out[b] = fmaxf(zmul(a2, 0.5f), 0.0f);
    p.out[p.B + b] = len;
    p.out[2 * p.B + b] = cx;
    p.out[3 * p.B + b] = cy;
  }
}

int g_sms[MAX_DEVICES];

}  // namespace

// Launches on `stream` (PyTorch's current stream of `device`, the current
// device) and returns the launch's cudaError_t (0 on success); the caller
// raises on non-zero.
extern "C" int geom_unary_launch(const float* verts, const uint8_t* vmask,
                                 const float* segs, const uint8_t* smask,
                                 const float* wsign, const int* mode,
                                 long long B, int K, int S, float* out,
                                 int device, void* stream) {
  if (B <= 0) return 0;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (g_sms[device] == 0) {
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    g_sms[device] = sms > 0 ? sms : 1;
  }
  Params p;
  p.verts = verts;
  p.vmask = vmask;
  p.segs = reinterpret_cast<const float4*>(segs);
  p.smask = smask;
  p.wsign = wsign;
  p.mode = mode;
  p.B = B;
  p.K = K;
  p.S = S;
  p.out = out;
  const long long want = (B + THREADS - 1) / THREADS;
  const long long fit = (long long)g_sms[device] * BLOCKS_PER_SM;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  geom_unary_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* geom_unary_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
