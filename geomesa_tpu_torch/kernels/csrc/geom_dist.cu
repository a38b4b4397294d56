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
//                4e9, which cross nothing) with a literal edge, a vertex
//                inside a polygonal literal, or a literal point inside a
//                polygonal feature (unbanded crossing parity)
//        sqrt(d2) otherwise
//
// in f32 as catalog._dist_plain computes it: subnormals flushed, the
// reference's fused multiply-adds (_pt_seg_d2, the orientations), IEEE
// division and square root, a NaN kept by the min. Min, any and the
// crossing parity (XOR) do not depend on order, so kernel and plain
// version are equal bit for bit.
//
// What bounds it on the card: bytes at a short literal (a feature's pack,
// 8 bytes and a mask byte a vertex, 16 and a mask byte a segment, its
// origin and polygon flag, read once; 4 bytes written), operations at a
// long one (about 25 f32 operations a (vertex, literal edge), (literal
// point, segment) and (segment, literal edge) pair, 5 a (vertex, literal
// point) pair).
//
// Design: geom_pair.cuh's traversal (several features a warp, the literal
// staged once a CTA, lanes over the literal when it is long).

#include "geom_pair.cuh"

namespace {

using namespace geomk;

struct DistOp {
  float d2;
  bool zero;
  bool lit_poly;

  __device__ explicit DistOp(const PairParams& p)
      : d2(BIG), zero(false), lit_poly(p.lit_poly != 0) {}

  // A: a vertex against a literal edge (crossing parity, unbanded)
  __device__ __forceinline__ void vertex_edge(float vx, float vy, float4 e,
                                              bool& in, bool&) {
    d2 = nmin(d2, pt_seg_d2(vx, vy, e.x, e.y, e.z, e.w));
    in ^= pip_cross(vx, vy, e.x, e.y, e.z, e.w);
  }

  // B: a vertex against a literal point
  __device__ __forceinline__ void vertex_point(float vx, float vy,
                                               float2 q) {
    const float dx = zsub(vx, q.x);
    const float dy = zsub(vy, q.y);
    d2 = nmin(d2, zfma(dx, dx, zmul(dy, dy)));
  }

  __device__ __forceinline__ void vertex_end(bool in, bool) {
    if (lit_poly && in) zero = true;
  }

  // C: a proper crossing of a feature segment and a literal edge
  __device__ __forceinline__ void seg_edge(float4 s, float4 e) {
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

  // D: a literal point against a feature segment
  __device__ __forceinline__ void point_seg(float qx, float qy, float4 s,
                                            bool& in, bool&) {
    d2 = nmin(d2, pt_seg_d2(qx, qy, s.x, s.y, s.z, s.w));
    in ^= pip_cross(qx, qy, s.x, s.y, s.z, s.w);
  }

  __device__ __forceinline__ void point_end(bool fpoly, bool in, bool) {
    if (fpoly && in) zero = true;
  }

  __device__ __forceinline__ void reduce(int G) {
    d2 = group_min(d2, G);
    zero = group_or(zero ? 1u : 0u, G) != 0;
  }

  __device__ __forceinline__ void write(const PairParams& p, long long b,
                                        bool) const {
    p.out[b] = zero ? 0.0f : zsqrt(d2);
  }
};

}  // namespace

extern "C" int geom_dist_launch(const PairArgs* a, void* stream) {
  return pair_launch<DistOp>(a, stream);
}

extern "C" const char* geom_dist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
