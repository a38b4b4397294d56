// Shared f32 arithmetic of the geometry catalog's kernels (geom_unary.cu,
// geom_dist.cu, geom_pred.cu).
//
// The catalog's plain versions (geomesa_tpu_torch/geom/catalog.py) do the
// reference's f32 arithmetic as XLA does it on the CPU: subnormal inputs
// and results flushed to zeros of their sign, and a * b + c contracted into
// one fused multiply-add where the product has no other use. Here that is
// PTX's .ftz arithmetic, rounded to nearest (the IEEE division and square
// root, not the approximate ones), and fma.rn.ftz where the plain version
// calls _fma. The certainty bands (orient_band, pip_band_step,
// segpair_band) are index/scan.py's: unflushed, unfused, as seg_band.cu
// and pip_refine.cu compute them.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace geomk {

constexpr float BIG = 9e18f;  // a masked pair's squared distance

__device__ __forceinline__ float zadd(float a, float b) {
  float d;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float zsub(float a, float b) {
  float d;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float zmul(float a, float b) {
  float d;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// an input as XLA reads it: a subnormal is a zero of its sign (one
// flushed multiplication by 1, exact for every other value)
__device__ __forceinline__ float zin(float v) { return zmul(v, 1.0f); }

__device__ __forceinline__ float zdiv(float a, float b) {
  float d;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float zsqrt(float a) {
  float d;
  asm("sqrt.rn.ftz.f32 %0, %1;" : "=f"(d) : "f"(a));
  return d;
}

__device__ __forceinline__ float zfma(float a, float b, float c) {
  float d;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}

// the smaller of a and b, NaN when either is NaN (XLA's min, torch.amin and
// torch.minimum); no signed-zero rule is needed: the squared distances
// this takes are never -0
__device__ __forceinline__ float nmin(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// squared distance of point p to segment (x1, y1)-(x2, y2) (_pt_seg_d2;
// its clamp keeps a NaN, as torch.clamp and XLA's clamp do)
__device__ __forceinline__ float pt_seg_d2(float px, float py, float x1,
                                           float y1, float x2, float y2) {
  const float dx = zsub(x2, x1);
  const float dy = zsub(y2, y1);
  const float ll = zfma(dx, dx, zmul(dy, dy));
  float t = zdiv(zfma(zsub(px, x1), dx, zmul(zsub(py, y1), dy)),
                 ll == 0.0f ? 1.0f : ll);
  if (t == t) t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float ex = zsub(px, zfma(t, dx, x1));
  const float ey = zsub(py, zfma(t, dy, y1));
  return zfma(ex, ex, zmul(ey, ey));
}

// the half-open crossing of edge (x1, y1)-(x2, y2) by the ray from p
// (_pip_plain's term, unbanded; no division where the edge does not
// straddle p's y)
__device__ __forceinline__ bool pip_cross(float px, float py, float x1,
                                          float y1, float x2, float y2) {
  const bool cond = (y1 > py) != (y2 > py);
  if (!cond) return false;
  const float den = zsub(y2, y1);
  const float xs = zadd(x1, zdiv(zmul(zsub(py, y1), zsub(x2, x1)),
                                 y2 == y1 ? 1.0f : den));
  return xs > px;
}

// the band constants of index/scan.py (TOL_T, TOL_D, DY_BAND)
struct Band {
  float tol_t, tol_d, dy;
};

// orientation of (p, q, r) with its error bound (_orient_band)
__device__ __forceinline__ void orient_band(const Band& bd, float px,
                                            float py, float qx, float qy,
                                            float rx, float ry, float& det,
                                            float& tol) {
  const float d1x = __fsub_rn(qx, px);
  const float d1y = __fsub_rn(qy, py);
  const float d2x = __fsub_rn(rx, px);
  const float d2y = __fsub_rn(ry, py);
  const float t1 = __fmul_rn(d1x, d2y);
  const float t2 = __fmul_rn(d1y, d2x);
  det = __fsub_rn(t1, t2);
  const float sd = __fadd_rn(__fadd_rn(__fadd_rn(fabsf(d1x), fabsf(d1y)),
                                       fabsf(d2x)), fabsf(d2y));
  tol = __fadd_rn(__fmul_rn(bd.tol_t, __fadd_rn(fabsf(t1), fabsf(t2))),
                  __fmul_rn(bd.tol_d, sd));
}

// one edge's (crossing, uncertain) terms of _pip_band for point p (the
// orientation only where the edge straddles p's y: elsewhere both terms
// are the tie band's alone)
__device__ __forceinline__ void pip_band_step(const Band& bd, float px,
                                              float py, float x1, float y1,
                                              float x2, float y2, bool& cross,
                                              bool& unc) {
  const bool tie = fabsf(__fsub_rn(y1, py)) <= bd.dy ||
                   fabsf(__fsub_rn(y2, py)) <= bd.dy;
  if ((y1 > py) == (y2 > py)) {
    cross = false;
    unc = tie;
    return;
  }
  float o, t;
  orient_band(bd, x1, y1, x2, y2, px, py, o, t);
  cross = (y2 > y1) ? (o > t) : (o < -t);
  unc = fabsf(o) <= t || tie;
}

// (certain-intersect, certain-miss) of segment (a, b) against edge (c, d)
// (_segpair_band)
__device__ __forceinline__ void segpair_band(const Band& bd, float4 s,
                                             float4 e, bool& hit,
                                             bool& miss) {
  float o1, t1, o2, t2, o3, t3, o4, t4;
  orient_band(bd, s.x, s.y, s.z, s.w, e.x, e.y, o1, t1);
  orient_band(bd, s.x, s.y, s.z, s.w, e.z, e.w, o2, t2);
  orient_band(bd, e.x, e.y, e.z, e.w, s.x, s.y, o3, t3);
  orient_band(bd, e.x, e.y, e.z, e.w, s.z, s.w, o4, t4);
  const bool opp12 = (o1 > t1 && o2 < -t2) || (o1 < -t1 && o2 > t2);
  const bool opp34 = (o3 > t3 && o4 < -t4) || (o3 < -t3 && o4 > t4);
  const bool same12 = (o1 > t1 && o2 > t2) || (o1 < -t1 && o2 < -t2);
  const bool same34 = (o3 > t3 && o4 > t4) || (o3 < -t3 && o4 < -t4);
  hit = opp12 && opp34;
  miss = same12 || same34;
}

__device__ __forceinline__ float4 zin4(float4 v) {
  return make_float4(zin(v.x), zin(v.y), zin(v.z), zin(v.w));
}

__device__ __forceinline__ float2 zin2(float2 v) {
  return make_float2(zin(v.x), zin(v.y));
}

}  // namespace geomk
