// The fused program's block gate for Hopper (sm_90a): which gather blocks a
// query can touch, listed in ascending order with their count, on the
// device.
//
// Replaces the in-program cover of the reference's _jit_program
// (geomesa_tpu/index/compiled.py:463-474), the OR of branch gates of its
// _jit_union_program (:950 ff.) and jnp.nonzero(alive, size=cap,
// fill_value=-1) (:496). Block b is alive when, for some branch, any gate
// envelope [xmin, ymin, xmax, ymax] meets the block's slack-widened f32
// coordinate envelope (bxmax >= xmin, bxmin <= xmax, bymax >= ymin,
// bymin <= ymax) and, when the branch has windows and the table bins, any
// window's bin range [lo, hi] (lo <= hi) meets the block's [binmin, binmax].
// Outputs: ids (nb int32) the alive blocks ascending, padded with -1;
// starts (nb int64) their clamped first rows clamp(b * bsz, 0, n - bsz)
// (0 in the pad), the starts the refine and density kernels read through;
// count (int32) the number alive. Every later kernel of the program reads
// the count on the device, so no launch is sized by a value read back.
//
// What bounds it on the card: per block 24 bytes of summaries in and at
// most 12 bytes of ids and starts out, and per (block, gate envelope) 4 f32
// compares (per (block, window) 3 int compares). At the main path's 24,415
// blocks that is well under a megabyte: launch latency, not bytes, decides
// its time.
//
// Design: one launch. The query's sections (branch table, gates, window
// bins) are staged into shared memory once a CTA; the blocks run through
// lookback.cuh's ordered pass (tickets, ballot ranks, decoupled look-back),
// so each alive block's id and start are written at their rank with no
// second pass; the last CTA writes the count and pads the lists.

#include "lookback.cuh"

using namespace lookback;

namespace {

struct Params {
  const float* bxmin;
  const float* bxmax;
  const float* bymin;
  const float* bymax;
  const int* binmin;   // null: the table has no bins
  const int* binmax;
  const int4* qbuf;
  int qwords;          // 16-byte words of qbuf
  int br, gate, wbin;  // byte offsets of the sections
  int nbranch;
  long long nb, bsz, n;
  int* ids;
  long long* starts;
  int* count;
  Ws ws;
};

__global__ void __launch_bounds__(THREADS)
block_gate_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = threadIdx.x; i < p.qwords; i += THREADS)
    reinterpret_cast<int4*>(smem)[i] = __ldg(p.qbuf + i);
  __syncthreads();
  const int* br = reinterpret_cast<const int*>(smem + p.br);
  const float4* gate = reinterpret_cast<const float4*>(smem + p.gate);
  const int2* wbin = reinterpret_cast<const int2*>(smem + p.wbin);

  auto alive = [&](long long b) -> bool {
    const float x0 = __ldg(p.bxmin + b), x1 = __ldg(p.bxmax + b);
    const float y0 = __ldg(p.bymin + b), y1 = __ldg(p.bymax + b);
    const int t0 = p.binmin ? __ldg(p.binmin + b) : 0;
    const int t1 = p.binmax ? __ldg(p.binmax + b) : 0;
    for (int k = 0; k < p.nbranch; ++k) {
      const int* r = br + 8 * k;
      bool a = false;
      for (int j = r[0], e = r[0] + r[1]; j < e && !a; ++j) {
        const float4 g = gate[j];
        a = (x1 >= g.x) & (x0 <= g.z) & (y1 >= g.y) & (y0 <= g.w);
      }
      if (a && r[3] > 0 && p.binmin) {
        bool in = false;
        for (int j = r[2], e = r[2] + r[3]; j < e && !in; ++j) {
          const int2 w = wbin[j];
          in = (w.x <= w.y) & (t0 <= w.y) & (t1 >= w.x);
        }
        a = in;
      }
      if (a) return true;
    }
    return false;
  };
  const long long top = p.n > p.bsz ? p.n - p.bsz : 0;
  auto emit = [&](long long at, long long b) {
    p.ids[at] = (int)b;
    const long long s = b * p.bsz;
    p.starts[at] = s > top ? top : s;
  };
  const unsigned long long cta = ordered_pass(p.nb, p.ws, p.nb, alive,
                                              emit);
  finish(p.ws, cta, [&](unsigned long long total) {
    if (threadIdx.x == 0) *p.count = (int)total;
    const long long filled = (long long)total < p.nb ? (long long)total : p.nb;
    for (long long j = filled + threadIdx.x; j < p.nb; j += THREADS) {
      p.ids[j] = -1;
      p.starts[j] = 0;
    }
  });
}

}  // namespace

// The launch's arguments as the wrapper packs them (kernels/gate.py _ARGS):
// 8-byte slots, pointers 0 for none.
struct BlockGateArgs {
  long long bxmin, bxmax, bymin, bymax, binmin, binmax;
  long long qbuf, qbytes, br, gate, wbin, nbranch;
  long long nb, bsz, n;
  long long ids, starts, count;
  long long ws, ws_units, epoch, device;
};
static_assert(sizeof(BlockGateArgs) == 22 * 8, "BlockGateArgs must match _ARGS");


// Lists the alive blocks into ids/starts and their number into count, in
// one launch on `stream` (on device a->device, the current device). a->ws:
// the stream's workspace of 4 + a->ws_units 64-bit words, left as the
// kernel found it; calls that share it run in order, each with a new
// nonzero epoch. Returns the first CUDA error (0 on success).
extern "C" int block_gate_launch(const BlockGateArgs* a, void* stream) {
  if (a->nb <= 0 || a->bsz <= 0 || a->qbytes % 16 || a->epoch == 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.bxmin = reinterpret_cast<const float*>(a->bxmin);
  p.bxmax = reinterpret_cast<const float*>(a->bxmax);
  p.bymin = reinterpret_cast<const float*>(a->bymin);
  p.bymax = reinterpret_cast<const float*>(a->bymax);
  p.binmin = reinterpret_cast<const int*>(a->binmin);
  p.binmax = reinterpret_cast<const int*>(a->binmax);
  p.qbuf = reinterpret_cast<const int4*>(a->qbuf);
  p.qwords = (int)(a->qbytes / 16);
  p.br = (int)a->br;
  p.gate = (int)a->gate;
  p.wbin = (int)a->wbin;
  p.nbranch = (int)a->nbranch;
  p.nb = a->nb;
  p.bsz = a->bsz;
  p.n = a->n;
  p.ids = reinterpret_cast<int*>(a->ids);
  p.starts = reinterpret_cast<long long*>(a->starts);
  p.count = reinterpret_cast<int*>(a->count);
  const long long units = (a->nb + TILE - 1) / TILE;   // the blocks
  if (units > a->ws_units) return (int)cudaErrorInvalidValue;
  p.ws = make_ws(a->ws, (unsigned)a->epoch);
  const size_t smem = (size_t)a->qbytes;
  unsigned grid = 1;
  cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(block_gate_kernel), smem,
      (int)a->device, units, grid);
  if (err != cudaSuccess) return (int)err;
  block_gate_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Candidates a unit (the workspace holds one status word a unit).
extern "C" int block_gate_tile() { return TILE; }

extern "C" const char* block_gate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
