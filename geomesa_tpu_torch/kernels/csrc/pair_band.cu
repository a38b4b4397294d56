// Certainty-banded INTERSECTS of extent×extent join candidate pairs, for
// Hopper (sm_90a), with the verdicts packed into bits.
//
// Replaces the reference's XLA program `_pair_fn` (geomesa_tpu/parallel/
// pair_kernel.py:137) over `_band_core` (:87): each pair (pl, pr) gathers a
// left and a right geometry from two padded segment tables, and is a
// certain hit when a real segment pair certainly crosses (_segpair_band) or
// a side is polygonal and the other's first vertex is certainly inside it
// (_pip_band), a certain miss when every real segment pair certainly misses
// and each polygonal side certainly has the other's (single-part) first
// vertex outside, uncertain otherwise. A pad pair (pl < 0) is neither.
// Verdicts pack as np.packbits packs them: row 0 hits, row 1 uncertain, 8
// pairs a byte, the first pair in the most significant bit.
//
// The bands are index/scan.py's (geom_common.cuh's orient_band,
// pip_band_step, segpair_band: the reference's constants and operation
// order, unflushed, unfused), so the bits equal the plain version's
// (geomesa_tpu_torch/parallel/pair_kernel.py pair_plain). They are also
// the reference's: XLA contracts _orient_band into fused multiply-adds
// when it is jitted alone, but not inside _pair_fn, whose verdicts at
// pairs on a band's edge are the unfused band's
// (tests/test_torch_extent_join.py); and XLA's flush of subnormals changes
// no verdict (a certified sign has |det| > tol >= TOL_D * |d| for its
// largest coordinate difference d, so |d| > 4e-5, where no subnormal term
// moves det's rounding).
//
// What bounds it on the card: operations, four orientation bands a real
// segment pair. The pair vectors are 8 bytes a pair; the tables (each
// geometry's segments once) are small and stay in L2.
//
// Design (a simple first version): a warp a pair, a block of 8 warps an
// output byte (grid-stride over the bytes). The warp's lanes split the
// pair's lc × rc real segment pairs (nothing past the counts is read: the
// masked padded loop's answer); a certain crossing ends the walk (a hit
// needs no more). Otherwise the first-vertex bands run, lanes over the
// other side's real edges, each only when its side is polygonal (else its
// terms cannot change the verdict): the parity a ballot's popcount, the
// uncertainty a vote. Lane 0 of each warp leaves its two bits in shared
// memory and thread 0 writes the byte pair.

#include <cstdint>
#include <cuda_runtime.h>

#include "geom_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // pairs a block round: one output byte
constexpr unsigned FULL = 0xffffffffu;

struct Side {
  const float4* segs;          // (G, S) padded segments [x1, y1, x2, y2]
  const int* cnt;              // (G,) real segments
  const unsigned char* poly;   // (G,) polygonal
  const unsigned char* single; // (G,) single-part
  int G, S;
};

// (certainly inside, certainly outside) of point p against n real edges
// (_pip_band over the edge axis, the padded edges masked out)
__device__ __forceinline__ void pip_band_warp(const geomk::Band& bd, float px,
                                              float py, const float4* e,
                                              int n, int lane, bool& cin,
                                              bool& cout) {
  bool cross = false, unc = false;
  for (int j = lane; j < n; j += 32) {
    const float4 ed = e[j];
    bool c, u;
    geomk::pip_band_step(bd, px, py, ed.x, ed.y, ed.z, ed.w, c, u);
    cross ^= c;
    unc |= u;
  }
  const bool inside = __popc(__ballot_sync(FULL, cross)) & 1;
  const bool any_unc = __any_sync(FULL, unc);
  cin = inside && !any_unc;
  cout = !inside && !any_unc;
}

// the warp's (hit, uncertain) of left geometry l against right geometry r
__device__ __forceinline__ void verdict(const Side& L, const Side& R, int l,
                                        int r, const geomk::Band& bd,
                                        int lane, bool& hit, bool& unc) {
  const float4* ls = L.segs + (long long)l * L.S;
  const float4* rs = R.segs + (long long)r * R.S;
  const int lc = L.cnt[l];
  const int rc = R.cnt[r];
  const int total = lc * rc;
  bool any_hit = false, all_miss = true;
  for (int base = 0; base < total; base += 32) {
    const int k = base + lane;
    if (k < total) {
      const int i = k / rc;
      bool h, m;
      geomk::segpair_band(bd, ls[i], rs[k - i * rc], h, m);
      any_hit |= h;
      all_miss &= m;
    }
    if (__any_sync(FULL, any_hit)) break;
  }
  if (__any_sync(FULL, any_hit)) {
    hit = true;
    unc = false;
    return;
  }
  all_miss = __all_sync(FULL, all_miss);
  const bool lpoly = L.poly[l] != 0;
  const bool rpoly = R.poly[r] != 0;
  bool l_in = false, l_out = false, r_in = false, r_out = false;
  if (rpoly) {
    const float4 v = ls[0];
    pip_band_warp(bd, v.x, v.y, rs, rc, lane, l_in, l_out);
  }
  if (lpoly) {
    const float4 v = rs[0];
    pip_band_warp(bd, v.x, v.y, ls, lc, lane, r_in, r_out);
  }
  hit = (rpoly && l_in) || (lpoly && r_in);
  const bool miss = all_miss && (!rpoly || (l_out && L.single[l])) &&
                    (!lpoly || (r_out && R.single[r]));
  unc = !hit && !miss;
}

__global__ void __launch_bounds__(THREADS)
pair_band_kernel(Side L, Side R, const int* __restrict__ pl,
                 const int* __restrict__ pr, long long n, long long nbytes,
                 geomk::Band bd, unsigned char* __restrict__ out) {
  __shared__ unsigned char s_h[WARPS], s_u[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long byte = blockIdx.x; byte < nbytes; byte += gridDim.x) {
    const long long q = byte * WARPS + warp;
    bool hit = false, unc = false;
    if (q < n && pl[q] >= 0) {
      const int l = min(pl[q], L.G - 1);
      const int r = min(max(pr[q], 0), R.G - 1);
      verdict(L, R, l, r, bd, lane, hit, unc);
    }
    if (lane == 0) {
      s_h[warp] = hit;
      s_u[warp] = unc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned h = 0, u = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        h |= (unsigned)s_h[w] << (7 - w);
        u |= (unsigned)s_u[w] << (7 - w);
      }
      out[byte] = (unsigned char)h;
      out[nbytes + byte] = (unsigned char)u;
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream of device `dev`) and
// returns the launch's cudaError_t (0 on success). out is (2, ceil(n/8))
// bytes.
extern "C" int pair_band_launch(const float4* lsegs, const int* lcnt,
                                const unsigned char* lpoly,
                                const unsigned char* lsingle, int gl, int sl,
                                const float4* rsegs, const int* rcnt,
                                const unsigned char* rpoly,
                                const unsigned char* rsingle, int gr, int sr,
                                const int* pl, const int* pr, long long n,
                                float tol_t, float tol_d, float dy,
                                unsigned char* out, int dev, void* stream) {
  (void)dev;
  if (n < 0 || gl <= 0 || gr <= 0) return (int)cudaErrorInvalidValue;
  const long long nbytes = (n + WARPS - 1) / WARPS;
  if (nbytes == 0) return 0;
  const Side L{lsegs, lcnt, lpoly, lsingle, gl, sl};
  const Side R{rsegs, rcnt, rpoly, rsingle, gr, sr};
  const geomk::Band bd{tol_t, tol_d, dy};
  const long long grid = nbytes < (1ll << 20) ? nbytes : (1ll << 20);
  pair_band_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      L, R, pl, pr, n, nbytes, bd, out);
  return (int)cudaGetLastError();
}

extern "C" const char* pair_band_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
