// The geometry catalog's predicate program for Hopper (sm_90a): banded
// st_intersects / st_within / st_contains of packed features.
//
// Replaces the reference's `_pred_batch` = jit(vmap(_pred_one))
// (geomesa_tpu/geom/catalog.py:288-354), an XLA program. Per feature b,
// with the literal's edges and points shifted into the feature's frame
// and the masked vertices at 3e9:
//
//   vin/vout  each vertex against the literal's edges     (_pip_band)
//   pin/pout  each literal point against the feature's    (_pip_band,
//             segments, the masked ones left out           evalid)
//   si/sm     each (segment, literal edge) pair, si where the segment is
//             real, sm where it is padding                (_segpair_band)
//   far       min squared distance (as geom_dist.cu) > f32 1.5e-4²
//   op 0 intersects: cin = any si | lit_poly & any(vin & vm)
//                          | poly & any pin;               cout = far
//   op 1 within:     cin = lit_poly & any vm & all(vin | !vm) & all sm;
//                    cout = far | lit_poly & any(vout & vm)
//   op 2 contains:   cin = poly & all pin & all sm;
//                    cout = far | poly & any pout | lit_ext & !poly
//
// The bands are index/scan.py's (unflushed, unfused: the bounds of
// seg_band.cu and pip_refine.cu); the distances are catalog._min_d2's
// (flushed, fused, a NaN kept by the min). Any, all, min and parity do not
// depend on order, so kernel and plain version (catalog._pred_plain) are
// equal bit for bit. Rows neither certainly true nor certainly false go to
// the f64 host oracle (catalog.batch_predicate).
//
// What bounds it on the card: operations at all but the shortest
// literals, about 4 x 11 f32 operations a (segment, literal edge) band, 18
// a (point, edge) band and 25 a distance pair, against a few bytes of pack
// a feature.
//
// Design: geom_pair.cuh's traversal (several features a warp, the literal
// staged once a CTA, lanes over the literal when it is long). The any and
// all terms are bits of one word a lane (an all as "some item fails"), so
// a group meets in one OR and one min.

#include "geom_pair.cuh"

namespace {

using namespace geomk;

enum : unsigned {
  ANY_VIN = 1u << 0,
  SOME_V_NOT_IN = 1u << 1,
  ANY_VOUT = 1u << 2,
  HAS_V = 1u << 3,
  ANY_SI = 1u << 4,
  SOME_S_NOT_MISS = 1u << 5,
  ANY_PIN = 1u << 6,
  SOME_P_NOT_IN = 1u << 7,
  ANY_POUT = 1u << 8,
};

struct PredOp {
  float d2;
  unsigned fl;
  Band bd;

  __device__ explicit PredOp(const PairParams& p)
      : d2(BIG), fl(0u), bd(p.band) {}

  // A: a vertex against a literal edge (banded parity)
  __device__ __forceinline__ void vertex_edge(float vx, float vy, float4 e,
                                              bool& in, bool& unc) {
    bool cr, un;
    pip_band_step(bd, vx, vy, e.x, e.y, e.z, e.w, cr, un);
    in ^= cr;
    unc |= un;
    d2 = nmin(d2, pt_seg_d2(vx, vy, e.x, e.y, e.z, e.w));
  }

  // B: a vertex against a literal point
  __device__ __forceinline__ void vertex_point(float vx, float vy,
                                               float2 q) {
    const float dx = zsub(vx, q.x);
    const float dy = zsub(vy, q.y);
    d2 = nmin(d2, zfma(dx, dx, zmul(dy, dy)));
  }

  __device__ __forceinline__ void vertex_end(bool in, bool unc) {
    fl |= HAS_V;
    fl |= (in && !unc) ? ANY_VIN : SOME_V_NOT_IN;
    if (!in && !unc) fl |= ANY_VOUT;
  }

  // C: a feature segment against a literal edge
  __device__ __forceinline__ void seg_edge(float4 s, float4 e) {
    bool hit, miss;
    segpair_band(bd, s, e, hit, miss);
    if (hit) fl |= ANY_SI;
    if (!miss) fl |= SOME_S_NOT_MISS;
  }

  // D: a literal point against a feature segment (banded parity)
  __device__ __forceinline__ void point_seg(float qx, float qy, float4 s,
                                            bool& in, bool& unc) {
    bool cr, un;
    pip_band_step(bd, qx, qy, s.x, s.y, s.z, s.w, cr, un);
    in ^= cr;
    unc |= un;
    d2 = nmin(d2, pt_seg_d2(qx, qy, s.x, s.y, s.z, s.w));
  }

  __device__ __forceinline__ void point_end(bool, bool in, bool unc) {
    fl |= (in && !unc) ? ANY_PIN : SOME_P_NOT_IN;
    if (!in && !unc) fl |= ANY_POUT;
  }

  __device__ __forceinline__ void reduce(int G) {
    d2 = group_min(d2, G);
    fl = group_or(fl, G);
  }

  __device__ __forceinline__ void write(const PairParams& p, long long b,
                                        bool fpoly) const {
    const bool far = d2 > p.miss2;
    const bool lit_poly = p.lit_poly != 0;
    bool ci, co;
    if (p.op == 0) {
      ci = (fl & ANY_SI) || (lit_poly && (fl & ANY_VIN)) ||
           (fpoly && (fl & ANY_PIN));
      co = far;
    } else if (p.op == 1) {
      ci = lit_poly && (fl & HAS_V) && !(fl & SOME_V_NOT_IN) &&
           !(fl & SOME_S_NOT_MISS);
      co = far || (lit_poly && (fl & ANY_VOUT));
    } else {
      ci = fpoly && !(fl & SOME_P_NOT_IN) && !(fl & SOME_S_NOT_MISS);
      co = far || (fpoly && (fl & ANY_POUT)) || (p.lit_ext && !fpoly);
    }
    p.cin[b] = ci;
    p.cout[b] = co;
  }
};

}  // namespace

// tol_t, tol_d and dy_band in the arguments are index/scan.py's TOL_T,
// TOL_D and DY_BAND; miss2 is catalog.MISS2.
extern "C" int geom_pred_launch(const PairArgs* a, void* stream) {
  return pair_launch<PredOp>(a, stream);
}

extern "C" const char* geom_pred_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
