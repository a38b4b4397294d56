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
// (flushed, fused). Any, all, min and parity do not depend on order, so
// kernel and plain version (catalog._pred_plain) are equal bit for bit.
// Rows neither certainly true nor certainly false go to the f64 host
// oracle (catalog.batch_predicate).
//
// What bounds it on the card: operations, about 4 x 11 f32 operations
// per (segment, literal edge) band, 18 per (point, edge) band and 25 per
// distance pair, against a few bytes of pack per feature.
//
// Design: as geom_dist.cu — one CTA of one warp a feature, the shifted
// literal staged in shared memory in tiles of 256, the lanes over the
// feature's vertices, its segments, then the literal's points, warp votes
// and a warp min at the end.

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
  int op, lit_poly, lit_ext;
  Band band;
  float miss2;            // the certain-miss band, squared in f32
  uint8_t* cin;           // (B,)
  uint8_t* cout;          // (B,)
};

// the literal's edges [e0, e0 + ne) into shared memory, in the frame of
// origin (rx, ry)
__device__ __forceinline__ void stage_edges(const Params& p, float4* s_e,
                                            int e0, int ne, float rx,
                                            float ry) {
  __syncwarp();
  for (int i = threadIdx.x; i < ne; i += THREADS) {
    const float4 e = zin4(p.lsegs[e0 + i]);
    s_e[i] = make_float4(zsub(e.x, rx), zsub(e.y, ry), zsub(e.z, rx),
                         zsub(e.w, ry));
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
geom_pred_kernel(Params p) {
  __shared__ float4 s_e[TILE];
  __shared__ float2 s_p[TILE];
  const int lane = threadIdx.x;
  for (long long b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float rx = zin(p.ref[2 * b]);
    const float ry = zin(p.ref[2 * b + 1]);
    const float4* sg = p.segs + b * p.S;
    const uint8_t* sm = p.smask + b * p.S;
    const bool fpoly = p.poly[b] != 0;
    float d2 = BIG;
    bool any_vin = false, all_vin = true, any_vout = false, has_v = false;
    bool any_si = false, all_sm = true;
    bool any_pin = false, all_pin = true, any_pout = false;
    // the feature's vertices against the literal's edges and points
    for (int k0 = 0; k0 < p.K; k0 += THREADS) {
      const int k = k0 + lane;
      const bool live = k < p.K;
      const bool vm = live && p.vmask[b * p.K + k];
      const float vx = vm ? zin(p.verts[(b * p.K + k) * 2]) : VERT_PAD;
      const float vy = vm ? zin(p.verts[(b * p.K + k) * 2 + 1]) : VERT_PAD;
      bool inside = false, unc = false;
      for (int e0 = 0; e0 < p.L; e0 += TILE) {
        const int ne = min(TILE, p.L - e0);
        stage_edges(p, s_e, e0, ne, rx, ry);
        if (live) {
          for (int i = 0; i < ne; ++i) {
            const float4 e = s_e[i];
            bool cr, un;
            pip_band_step(p.band, vx, vy, e.x, e.y, e.z, e.w, cr, un);
            inside ^= cr;
            unc |= un;
            if (vm) d2 = fminf(d2, pt_seg_d2(vx, vy, e.x, e.y, e.z, e.w));
          }
        }
      }
      if (live) {
        const bool vin = inside && !unc;
        const bool vout = !inside && !unc;
        any_vin |= vin && vm;
        all_vin &= vin || !vm;
        any_vout |= vout && vm;
        has_v |= vm;
      }
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
    // the feature's segments against the literal's edges
    for (int j0 = 0; j0 < p.S; j0 += THREADS) {
      const int j = j0 + lane;
      const bool live = j < p.S;
      const bool real = live && sm[j];
      const float4 s = live ? zin4(sg[j]) : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int e0 = 0; e0 < p.L; e0 += TILE) {
        const int ne = min(TILE, p.L - e0);
        stage_edges(p, s_e, e0, ne, rx, ry);
        if (live) {
          for (int i = 0; i < ne; ++i) {
            bool hit, miss;
            segpair_band(p.band, s, s_e[i], hit, miss);
            any_si |= hit && real;
            all_sm &= miss || !real;
          }
        }
      }
    }
    // the literal's points against the feature's segments
    for (int q0 = 0; q0 < p.P; q0 += THREADS) {
      const int q = q0 + lane;
      if (q < p.P) {
        const float2 pt = p.lpts[q];
        const float qx = zsub(zin(pt.x), rx);
        const float qy = zsub(zin(pt.y), ry);
        bool inside = false, unc = false;
        for (int j = 0; j < p.S; ++j) {
          if (!sm[j]) continue;
          const float4 s = zin4(sg[j]);
          bool cr, un;
          pip_band_step(p.band, qx, qy, s.x, s.y, s.z, s.w, cr, un);
          inside ^= cr;
          unc |= un;
          d2 = fminf(d2, pt_seg_d2(qx, qy, s.x, s.y, s.z, s.w));
        }
        const bool pin = inside && !unc;
        any_pin |= pin;
        all_pin &= pin;
        any_pout |= !inside && !unc;
      }
    }
    d2 = warp_min(d2);
    any_vin = __any_sync(FULL, any_vin);
    all_vin = __all_sync(FULL, all_vin);
    any_vout = __any_sync(FULL, any_vout);
    has_v = __any_sync(FULL, has_v);
    any_si = __any_sync(FULL, any_si);
    all_sm = __all_sync(FULL, all_sm);
    any_pin = __any_sync(FULL, any_pin);
    all_pin = __all_sync(FULL, all_pin);
    any_pout = __any_sync(FULL, any_pout);
    if (lane == 0) {
      const bool far = d2 > p.miss2;
      bool ci, co;
      if (p.op == 0) {
        ci = any_si || (p.lit_poly && any_vin) || (fpoly && any_pin);
        co = far;
      } else if (p.op == 1) {
        ci = p.lit_poly && has_v && all_vin && all_sm;
        co = far || (p.lit_poly && any_vout);
      } else {
        ci = fpoly && all_pin && all_sm;
        co = far || (fpoly && any_pout) || (p.lit_ext && !fpoly);
      }
      p.cin[b] = ci;
      p.cout[b] = co;
    }
  }
}

int g_sms[MAX_DEVICES];

}  // namespace

// Launches on `stream` (PyTorch's current stream of `device`, the current
// device) and returns the launch's cudaError_t (0 on success); the caller
// raises on non-zero. tol_t, tol_d and dy_band are index/scan.py's TOL_T,
// TOL_D and DY_BAND; miss2 is catalog.MISS2.
extern "C" int geom_pred_launch(const float* verts, const uint8_t* vmask,
                                const float* segs, const uint8_t* smask,
                                const uint8_t* poly, const float* ref,
                                const float* lsegs, const float* lpts,
                                long long B, int K, int S, int L, int P,
                                int op, int lit_poly, int lit_ext,
                                float tol_t, float tol_d, float dy_band,
                                float miss2, uint8_t* cin, uint8_t* cout,
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
  p.poly = poly;
  p.ref = ref;
  p.lsegs = reinterpret_cast<const float4*>(lsegs);
  p.lpts = reinterpret_cast<const float2*>(lpts);
  p.B = B;
  p.K = K;
  p.S = S;
  p.L = L;
  p.P = P;
  p.op = op;
  p.lit_poly = lit_poly;
  p.lit_ext = lit_ext;
  p.band.tol_t = tol_t;
  p.band.tol_d = tol_d;
  p.band.dy = dy_band;
  p.miss2 = miss2;
  p.cin = cin;
  p.cout = cout;
  const long long fit = (long long)g_sms[device] * BLOCKS_PER_SM;
  const unsigned grid = (unsigned)(B < fit ? B : fit);
  geom_pred_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* geom_pred_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
