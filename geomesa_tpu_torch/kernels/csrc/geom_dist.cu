// The geometry catalog's distance program for Hopper (sm_90a):
// st_distance(feature, literal) of packed features.
//
// Replaces the reference's `_dist_batch` = jit(vmap(_dist_one))
// (geomesa_tpu/geom/catalog.py:255-285), an XLA program. Per feature b,
// with the literal's edges (L, padded) and points (P, padded) shifted into
// the feature's frame (minus its f32 origin) and the masked vertices at
// 3e9:
//
//   d2 = min( vertex -> literal edge, literal point -> feature segment,
//             vertex -> literal point )           squared, masked to 9e18
//   d  = 0       on a proper crossing of a feature segment (masked ones at
//                4e9) with a literal edge, a vertex inside a polygonal
//                literal, or a literal point inside a polygonal feature
//                (unbanded crossing parity)
//        sqrt(d2) otherwise
//
// in f32 as catalog._dist_plain computes it: subnormals flushed, the
// reference's fused multiply-adds (_pt_seg_d2, the orientations), IEEE
// division and square root. Min, any and the crossing parity (XOR) do not
// depend on order, so kernel and plain version are equal bit for bit.
//
// What bounds it on the card: operations. Per feature it reads its pack
// (16 bytes a segment slot, 8 a vertex slot, the masks, the origin) and
// writes 4 bytes, and does about 25 f32 operations per (vertex, literal
// edge), (literal point, segment) and (segment, literal edge) pair and 5
// per (vertex, literal point).
//
// Design: one CTA of one warp a feature (grid-stride over the batch). The
// literal's edges and points, shifted into the feature's frame, are staged
// in shared memory in tiles of 256; the warp's lanes take the feature's
// vertices, then its segments, then the literal's points (32 a round), and
// each lane loops over a tile (the points loop over the feature's segments
// in global memory, which stay in L1). The lane results meet in warp
// shuffles.

#include "geom_common.cuh"

namespace {

using namespace geomk;

constexpr int THREADS = 32;
constexpr int BLOCKS_PER_SM = 32;
constexpr int TILE = 256;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* verts;     // (B, K, 2)
  const uint8_t* vmask;   // (B, K)
  const float4* segs;     // (B, S)
  const uint8_t* smask;   // (B, S)
  const uint8_t* poly;    // (B,)
  const float* ref;       // (B, 2) f32 origins
  const float4* lsegs;    // (L,)
  const float2* lpts;     // (P,)
  long long B;
  int K, S, L, P;
  int lit_poly;
  float* out;             // (B,)
};

__global__ void __launch_bounds__(THREADS)
geom_dist_kernel(Params p) {
  __shared__ float4 s_e[TILE];
  __shared__ float2 s_p[TILE];
  const int lane = threadIdx.x;
  for (long long b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float rx = zin(p.ref[2 * b]);
    const float ry = zin(p.ref[2 * b + 1]);
    const float4* sg = p.segs + b * p.S;
    const uint8_t* sm = p.smask + b * p.S;
    float d2 = BIG;
    bool zero = false;
    // the feature's vertices against the literal's edges and points
    for (int k0 = 0; k0 < p.K; k0 += THREADS) {
      const int k = k0 + lane;
      const bool vm = k < p.K && p.vmask[b * p.K + k];
      const float vx = vm ? zin(p.verts[(b * p.K + k) * 2]) : VERT_PAD;
      const float vy = vm ? zin(p.verts[(b * p.K + k) * 2 + 1]) : VERT_PAD;
      bool parity = false;
      for (int e0 = 0; e0 < p.L; e0 += TILE) {
        const int ne = min(TILE, p.L - e0);
        __syncwarp();
        for (int i = lane; i < ne; i += THREADS) {
          const float4 e = zin4(p.lsegs[e0 + i]);
          s_e[i] = make_float4(zsub(e.x, rx), zsub(e.y, ry), zsub(e.z, rx),
                               zsub(e.w, ry));
        }
        __syncwarp();
        if (vm) {
          for (int i = 0; i < ne; ++i) {
            const float4 e = s_e[i];
            d2 = fminf(d2, pt_seg_d2(vx, vy, e.x, e.y, e.z, e.w));
            parity ^= pip_cross(vx, vy, e.x, e.y, e.z, e.w);
          }
        }
      }
      if (p.lit_poly && vm && parity) zero = true;
      for (int q0 = 0; q0 < p.P; q0 += TILE) {
        const int nq = min(TILE, p.P - q0);
        __syncwarp();
        for (int i = lane; i < nq; i += THREADS) {
          const float2 q = p.lpts[q0 + i];
          s_p[i] = make_float2(zsub(zin(q.x), rx), zsub(zin(q.y), ry));
        }
        __syncwarp();
        if (vm) {
          for (int i = 0; i < nq; ++i) {
            const float dx = zsub(vx, s_p[i].x);
            const float dy = zsub(vy, s_p[i].y);
            d2 = fminf(d2, zfma(dx, dx, zmul(dy, dy)));
          }
        }
      }
    }
    // the feature's segments (masked ones at 4e9) against the literal's
    // edges: a proper crossing
    for (int j0 = 0; j0 < p.S; j0 += THREADS) {
      const int j = j0 + lane;
      const bool live = j < p.S;
      const float4 s = live && sm[j]
                           ? zin4(sg[j])
                           : make_float4(SEG_PAD, SEG_PAD, SEG_PAD, SEG_PAD);
      for (int e0 = 0; e0 < p.L; e0 += TILE) {
        const int ne = min(TILE, p.L - e0);
        __syncwarp();
        for (int i = lane; i < ne; i += THREADS) {
          const float4 e = zin4(p.lsegs[e0 + i]);
          s_e[i] = make_float4(zsub(e.x, rx), zsub(e.y, ry), zsub(e.z, rx),
                               zsub(e.w, ry));
        }
        __syncwarp();
        if (live) {
          for (int i = 0; i < ne; ++i) {
            const float4 e = s_e[i];
            const float d1 = zfma(zsub(s.z, s.x), zsub(e.y, s.y),
                                  -zmul(zsub(s.w, s.y), zsub(e.x, s.x)));
            const float d2_ = zfma(zsub(s.z, s.x), zsub(e.w, s.y),
                                   -zmul(zsub(s.w, s.y), zsub(e.z, s.x)));
            const float d3 = zfma(zsub(e.z, e.x), zsub(s.y, e.y),
                                  -zmul(zsub(e.w, e.y), zsub(s.x, e.x)));
            const float d4 = zfma(zsub(e.z, e.x), zsub(s.w, e.y),
                                  -zmul(zsub(e.w, e.y), zsub(s.z, e.x)));
            if (zmul(d1, d2_) < 0.0f && zmul(d3, d4) < 0.0f) zero = true;
          }
        }
      }
    }
    // the literal's points against the feature's segments
    const bool fpoly = p.poly[b] != 0;
    for (int q0 = 0; q0 < p.P; q0 += THREADS) {
      const int q = q0 + lane;
      if (q < p.P) {
        const float2 pt = p.lpts[q];
        const float qx = zsub(zin(pt.x), rx);
        const float qy = zsub(zin(pt.y), ry);
        bool parity = false;
        for (int j = 0; j < p.S; ++j) {
          if (!sm[j]) continue;
          const float4 s = zin4(sg[j]);
          d2 = fminf(d2, pt_seg_d2(qx, qy, s.x, s.y, s.z, s.w));
          parity ^= pip_cross(qx, qy, s.x, s.y, s.z, s.w);
        }
        if (fpoly && parity) zero = true;
      }
    }
    d2 = warp_min(d2);
    zero = __any_sync(FULL, zero);
    if (lane == 0) p.out[b] = zero ? 0.0f : zsqrt(d2);
  }
}

int g_sms[MAX_DEVICES];

}  // namespace

// Launches on `stream` (PyTorch's current stream of `device`, the current
// device) and returns the launch's cudaError_t (0 on success); the caller
// raises on non-zero.
extern "C" int geom_dist_launch(const float* verts, const uint8_t* vmask,
                                const float* segs, const uint8_t* smask,
                                const uint8_t* poly, const float* ref,
                                const float* lsegs, const float* lpts,
                                long long B, int K, int S, int L, int P,
                                int lit_poly, float* out, int device,
                                void* stream) {
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
  p.poly = poly;
  p.ref = ref;
  p.lsegs = reinterpret_cast<const float4*>(lsegs);
  p.lpts = reinterpret_cast<const float2*>(lpts);
  p.B = B;
  p.K = K;
  p.S = S;
  p.L = L;
  p.P = P;
  p.lit_poly = lit_poly;
  p.out = out;
  const long long fit = (long long)g_sms[device] * BLOCKS_PER_SM;
  const unsigned grid = (unsigned)(B < fit ? B : fit);
  geom_dist_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* geom_dist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
