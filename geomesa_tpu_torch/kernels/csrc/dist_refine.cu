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
// and counts = [sum(hit), sum(unc)] as int32: the first two words of the
// fused program's count_refine/select_refine result.
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
// Design:
// - Where the mask and both flag buffers are 4-byte aligned (every fresh
//   allocation is), a thread takes 4 consecutive candidates a step in a
//   grid-stride loop: one 32-bit word of mask bytes in, one word of hit
//   and of unc bytes out. The ragged tail and unaligned buffers go one
//   candidate a step. (Sixteen candidates a lane, through 16-byte words,
//   leaves a quarter of the threads at the fused program's shapes and is
//   slower there.)
// - Through block starts, a candidate's block is a shift (power-of-two
//   bsz) or one division.
// - The counts come from the same launch: per-thread sums of the flag
//   bytes, warp reductions, one 64-bit atomic a CTA for both sums into a
//   workspace the wrapper keeps per stream; the last CTA to finish copies
//   the totals out and zeroes the workspace for the next call (no memset,
//   no second launch, no torch reduction after it). CTAs of 1,024 threads,
//   two an SM, keep those atomics few: they serialise on one address.
// - The SM count is read once per device; the wrapper passes the device,
//   so a call makes no CUDA runtime query before its launch.
//
// Bit-exactness: the flags must equal the plain version (index/scan.py
// dist_refine, itself equal to the JAX package's composition). The
// subtractions, products, sum and square root are the round-to-nearest
// intrinsics in the plain version's order, so nothing is contracted into
// an FMA (the build also passes -fmad=false) and the square root is the
// IEEE one, not the approximate sqrt of fast math.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* xf;
  const float* yf;
  const uint8_t* mask;       // null: every candidate is live
  const long long* starts;   // null: candidate i is row i
  const int* nlive;          // null, or the live slots of starts: only
                             // their candidates are read and written
  long long bsz;
  int bsz_shift;             // log2(bsz) when bsz is a power of two, else -1
  long long n;               // candidates
  float cx, cy, rlo, rhi;
  uint8_t* hit;
  uint8_t* unc;
  int* counts;               // [hits, uncertain]
  unsigned long long* ws;    // [uncertain << 32 | hits, CTAs done], zero on entry
  int vec;                   // 4 or 1: the bytes every buffer aligns to
};

// (hit, unc) of one live candidate of table row r as 0/1
__device__ __forceinline__ void classify(const Params& p, long long r,
                                         unsigned& h, unsigned& u) {
  const float dx = __fsub_rn(p.xf[r], p.cx);
  const float dy = __fsub_rn(p.yf[r], p.cy);
  const float d = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  h = d <= p.rlo;
  u = !h && !(d >= p.rhi);
}

// the block slot and offset of candidate i (through block starts)
__device__ __forceinline__ void block_of(const Params& p, long long i,
                                         long long& blk, long long& off) {
  if (p.bsz_shift >= 0) {
    blk = i >> p.bsz_shift;
    off = i & (p.bsz - 1);
  } else {
    blk = i / p.bsz;
    off = i - blk * p.bsz;
  }
}

// 4 consecutive candidates from 4 * q: one 32-bit word of mask bytes in,
// one word of hit and of unc bytes out; adds the flags to nh and nu
__device__ __forceinline__ void quad(const Params& p, long long q,
                                     unsigned& nh, unsigned& nu) {
  const uint32_t m =
      p.mask ? reinterpret_cast<const uint32_t*>(p.mask)[q] : 0x01010101u;
  uint32_t hw = 0, uw = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if ((m >> (8 * k)) & 0xffu) {
      long long r = 4 * q + k;
      if (p.starts) {
        long long blk, off;
        block_of(p, r, blk, off);
        r = __ldg(p.starts + blk) + off;
      }
      unsigned h, u;
      classify(p, r, h, u);
      hw |= h << (8 * k);
      uw |= u << (8 * k);
    }
  }
  reinterpret_cast<uint32_t*>(p.hit)[q] = hw;
  reinterpret_cast<uint32_t*>(p.unc)[q] = uw;
  nh += __popc(hw);   // flag bytes are 0 or 1
  nu += __popc(uw);
}

__global__ void __launch_bounds__(THREADS)
dist_refine_kernel(Params p) {
  if (p.nlive) {   // the block list's live candidates, read on the device
    const long long live = (long long)max(*p.nlive, 0) * p.bsz;
    if (live < p.n) p.n = live;
  }
  __shared__ unsigned s_cnt[2][WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  unsigned nh = 0, nu = 0;
  long long done = 0;
  if (p.vec == 4) {
    const long long quads = p.n / 4;
    for (long long q = tid; q < quads; q += stride) quad(p, q, nh, nu);
    done = quads * 4;
  }
  for (long long i = done + tid; i < p.n; i += stride) {
    unsigned h = 0, u = 0;
    if (p.mask == nullptr || p.mask[i]) {
      long long r = i;
      if (p.starts) {
        long long blk, off;
        block_of(p, i, blk, off);
        r = __ldg(p.starts + blk) + off;
      }
      classify(p, r, h, u);
    }
    p.hit[i] = (uint8_t)h;
    p.unc[i] = (uint8_t)u;
    nh += h;
    nu += u;
  }

  // the counts: warp sums, one atomic a CTA; the last CTA copies the
  // totals out and zeroes the workspace
  nh = __reduce_add_sync(FULL, nh);
  nu = __reduce_add_sync(FULL, nu);
  if (lane == 0) {
    s_cnt[0][warp] = nh;
    s_cnt[1][warp] = nu;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned h = 0, u = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      h += s_cnt[0][w];
      u += s_cnt[1][w];
    }
    // one atomic for both sums: each stays under 2^32 (the int32 counts
    // hold at most 2^31 - 1), so the low word never carries
    if (h | u) atomicAdd(p.ws, (unsigned long long)u << 32 | h);
    __threadfence();
    if (atomicAdd(p.ws + 1, 1ull) == gridDim.x - 1) {
      __threadfence();
      const unsigned long long hu = atomicExch(p.ws, 0ull);
      p.counts[0] = (int)(unsigned)hu;
      p.counts[1] = (int)(unsigned)(hu >> 32);
      p.ws[1] = 0ull;
    }
  }
}

int g_sms[MAX_DEVICES];
std::atomic<int> g_ready[MAX_DEVICES];

}  // namespace

// Launches on `stream` (PyTorch's current stream of device `device`, the
// current device) and returns the launch's cudaError_t (0 on success); the
// caller raises on non-zero. `mask`, `starts` and `nlive` (a device count
// of live slots of starts: only their candidates are read) may be null;
// `counts`
// gets int32 [hits, uncertain]; `ws` is this stream's workspace of 2
// zeroed 64-bit words, which the kernel leaves zero.
extern "C" int dist_refine_launch(const float* xf, const float* yf,
                                  const uint8_t* mask, const long long* starts,
                                  const int* nlive,
                                  long long bsz, long long n, float cx,
                                  float cy, float rlo, float rhi,
                                  uint8_t* hit, uint8_t* unc, int* counts,
                                  unsigned long long* ws, int device,
                                  void* stream) {
  if (n <= 0) return 0;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_ready[device].load(std::memory_order_acquire)) {
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    g_sms[device] = sms > 0 ? sms : 1;
    g_ready[device].store(1, std::memory_order_release);
  }
  Params p;
  p.xf = xf;
  p.yf = yf;
  p.mask = mask;
  p.starts = starts;
  p.nlive = nlive;
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
  p.counts = counts;
  p.ws = ws;
  const uintptr_t align = (uintptr_t)mask | (uintptr_t)hit | (uintptr_t)unc;
  p.vec = (align & 3u) == 0 ? 4 : 1;
  const long long per_cta = (long long)THREADS * p.vec;
  const long long want = (n + per_cta - 1) / per_cta;
  const long long fit = (long long)g_sms[device] * BLOCKS_PER_SM;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  dist_refine_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* dist_refine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
