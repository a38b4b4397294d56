// Ordered fixed-capacity compaction for Hopper (sm_90a): the rows of a
// candidate mask's set bytes, in candidate order, the first `cap` of them
// padded with a fill value, and their count, in one launch with no host
// sync.
//
// Replaces jnp.nonzero(size=..., fill_value=...) with its rowids mapping in
// the refine modes of the reference's _jit_program
// (geomesa_tpu/index/compiled.py:555, :559, :571, :574) and in its staged
// select_packed / select_blocks (geomesa_tpu/index/scan.py:825 ff.).
// Candidate i is row starts[i / bsz] + i % bsz through clamped block starts
// (the mask already carries the blocks' membership), or row i over a whole
// table; with nlive, only the first *nlive slots' candidates are read
// (block_gate.cu's count: the refine modes' candidates are the alive
// blocks, whatever their number). Outputs: count (int32) every set
// candidate, past the cap too; rows (cap int32).
//
// What bounds it on the card: one mask byte a candidate in, 4 bytes a kept
// row out (the block starts are 8 bytes a slot, amortised over bsz).
//
// Design: lookback.cuh's ordered pass (a CTA takes 4,096-candidate units by
// ticket; ballot ranks; decoupled look-back on epoch-tagged status words);
// a unit past the cap stops looking back and writes nothing, so a sparse
// capacity costs no chain of waits; the last CTA writes the count and pads.

#include "lookback.cuh"

using namespace lookback;

namespace {

struct Params {
  const uint8_t* mask;
  long long cap;
  int fill;
  int* count;
  int* rows;
  Space space;
  Ws ws;
};

__global__ void __launch_bounds__(THREADS)
ordered_compact_kernel(const __grid_constant__ Params p) {
  const unsigned long long cta = ordered_pass(
      p.space, p.ws, p.cap,
      [&](const Unit& t, int l, long long) -> bool {
        return p.mask[t.cand0 + l] != 0;
      },
      [&](long long at, long long row) { p.rows[at] = (int)row; });
  finish(p.ws, cta, [&](unsigned long long total) {
    if (threadIdx.x == 0) *p.count = (int)total;
    const long long filled = (long long)total < p.cap ? (long long)total : p.cap;
    for (long long j = filled + threadIdx.x; j < p.cap; j += THREADS)
      p.rows[j] = p.fill;
  });
}

}  // namespace

// The launch's arguments as the wrapper packs them (kernels/compact.py
// _ARGS): 8-byte slots, pointers 0 for none.
struct OrderedCompactArgs {
  long long mask, ncand, starts, nlive, slots, bsz;
  long long cap, fill, count, rows;
  long long ws, ws_units, epoch, device;
};
static_assert(sizeof(OrderedCompactArgs) == 14 * 8, "OrderedCompactArgs must match _ARGS");


// Compacts the mask's candidates in one launch on `stream` (on device
// a->device, the current device): with starts, `slots` blocks of bsz
// candidates; else ncand candidates, row i each. a->ws: the stream's
// workspace of 4 + a->ws_units 64-bit words, left as the kernel found it;
// calls that share it run in order, each with a new nonzero epoch. Returns
// the first CUDA error (0 on success).
extern "C" int ordered_compact_launch(const OrderedCompactArgs* a,
                                      void* stream) {
  if (a->cap < 0 || a->epoch == 0 || a->ncand < 0
      || (a->starts && (a->bsz <= 0 || a->slots < 0)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.mask = reinterpret_cast<const uint8_t*>(a->mask);
  p.cap = a->cap;
  p.fill = (int)a->fill;
  p.count = reinterpret_cast<int*>(a->count);
  p.rows = reinterpret_cast<int*>(a->rows);
  p.space.ids = nullptr;
  p.space.starts = reinterpret_cast<const long long*>(a->starts);
  p.space.nlive = reinterpret_cast<const int*>(a->nlive);
  if (a->starts) {
    p.space.slots = a->slots;
    p.space.bsz = a->bsz;
  } else {
    p.space.slots = 1;
    p.space.bsz = a->ncand;
  }
  p.space.n = p.space.bsz;
  p.space.tpb = (int)((p.space.bsz + TILE - 1) / TILE);
  const long long units = p.space.slots * p.space.tpb;
  if (units > a->ws_units || units > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.ws = make_ws(a->ws, (unsigned)a->epoch);
  unsigned grid = 1;
  cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(ordered_compact_kernel), 0,
      (int)a->device, units, grid);
  if (err != cudaSuccess) return (int)err;
  ordered_compact_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int ordered_compact_tile() { return TILE; }

extern "C" const char* ordered_compact_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
