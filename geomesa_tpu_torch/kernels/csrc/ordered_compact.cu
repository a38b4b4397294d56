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
// Design: an ordered pass over mask vectors on lookback.cuh's look-back
// and end.
// - The live candidates are one flat run (a unit does not stop at a
//   block's end), so a unit starts at a multiple of its size and, on a
//   16-byte-aligned mask, a thread reads its candidates as 16-byte vectors
//   (a streaming load: each byte is read once) and turns each into a
//   16-bit flag word. A mask that is not aligned (a view) and the ragged
//   tail take byte loads inside the kernel.
// - A unit is THREADS x V vectors; vector j of thread t is the unit's
//   vector j * THREADS + t, so a warp's loads coalesce. V = 2 (8,192
//   candidates a unit) was chosen by measurement against V = 1 and 4
//   (PERF.md §6): a larger unit shortens the look-back chain and
//   amortises the ticket (V = 4 is 4% faster at 33.5M candidates), but a
//   dense mask's first rows, up to the cap, then fall to fewer CTAs (V = 4
//   is 14% slower at (c)'s hits).
// - Ranks: a thread's V popcounts packed in 16-bit fields of one 64-bit
//   word, one warp shuffle scan of it and one shared-memory step over the
//   warps' sums give every vector's offset in the unit: two barriers a
//   unit. Warp 0 then looks back (so the unit's count is published before
//   any staging), while the other warps put the unit's set candidates in
//   shared memory in rank order (as 16-bit offsets); then they go out
//   coalesced at the exclusive prefix plus their rank, as rows. Thread 0
//   takes the next ticket while the unit loads.
// - The exclusive prefix comes from lookback.cuh's look_back (epoch-tagged
//   status words, stopping once the sum reaches cap).
// - Past the capacity: a unit whose inclusive prefix reaches cap raises
//   the workspace's full word (word 3: epoch << 32 | ~unit, by atomicMax,
//   so the lowest such unit of the call wins and a word of an earlier call
//   reads as lower; kernels/lookback.py zeroes it when the epoch wraps).
//   Tickets go out in candidate order, so a unit past that one, like every
//   later unit of the CTA that ran it, has an exclusive prefix of at least
//   cap: it only loads and popcounts its vectors for the count, and
//   publishes a saturated inclusive prefix with one store (a unit that
//   missed the word and looks back stops there). With cap 0 every unit is
//   past it.
// - The last CTA to finish writes the count and the fill, in 16-byte
//   stores (lookback.cuh's finish). The fill is not spread over the CTAs:
//   at (c)'s shape a cap of 65,536 costs about 0.0005 ms more than one of
//   4,096, pad and rows together (PERF.md §6).

#include "lookback.cuh"

using namespace lookback;

namespace {

constexpr int VEC = 16;               // mask bytes a vector
constexpr int V = 2;                  // vectors a thread a unit
constexpr int UNIT = THREADS * V * VEC;   // candidates a unit
static_assert(V <= 4, "four 16-bit fields a 64-bit word");
static_assert(UNIT <= 65536, "staged offsets are 16-bit");

struct Params {
  const uint8_t* mask;
  long long cap;
  int fill;
  int* count;
  int* rows;
  const long long* starts;    // clamped block starts, or null: row i
  const int* nlive;           // live slots on the device, or null: all
  long long slots, bsz;       // the candidates: slots x bsz
  int shift;                  // log2(bsz) for a power of two, else -1
  bool aligned;               // the mask's base is 16-byte aligned
  unsigned long long* full;   // the workspace's word 3
  Ws ws;
};

// bit b: byte b of w is not 0
__device__ __forceinline__ unsigned nibble(unsigned w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

// the flag word of candidates [c, c + 16) below live, bit b for c + b
__device__ __forceinline__ unsigned flags16(const Params& p, long long c,
                                            long long live) {
  if (p.aligned && c + VEC <= live) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p.mask + c));
    return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8
           | nibble(v.w) << 12;
  }
  unsigned f = 0;
  for (int b = 0; b < VEC; ++b)
    if (c + b < live && p.mask[c + b]) f |= 1u << b;
  return f;
}

// the row of candidate c (< 2^31)
__device__ __forceinline__ int row_of(const Params& p, unsigned c) {
  if (!p.starts) return (int)c;
  const unsigned s = p.shift >= 0 ? c >> p.shift : c / (unsigned)p.bsz;
  return (int)(__ldg(p.starts + s) + (c - s * (unsigned)p.bsz));
}

// rows[lo, cap) = fill by the CTA's threads: 16-byte stores between a
// scalar head and tail
__device__ __forceinline__ void pad(const Params& p, long long lo) {
  const long long hi = p.cap;
  const int g = threadIdx.x;
  const long long mis =
      (long long)((reinterpret_cast<uintptr_t>(p.rows + lo) >> 2) & 3);
  long long a = lo + ((4 - mis) & 3);
  if (a > hi) a = hi;
  const long long nv = (hi - a) >> 2;
  const long long b = a + 4 * nv;
  if (g < a - lo) p.rows[lo + g] = p.fill;
  if (g < hi - b) p.rows[b + g] = p.fill;
  const int4 f4 = make_int4(p.fill, p.fill, p.fill, p.fill);
  int4* body = reinterpret_cast<int4*>(p.rows + a);
  for (long long i = g; i < nv; i += THREADS) body[i] = f4;
}

__global__ void __launch_bounds__(THREADS)
ordered_compact_kernel(const __grid_constant__ Params p) {
  __shared__ unsigned short s_stage[UNIT];      // the unit's set candidates
  __shared__ unsigned long long s_wsum[WARPS];  // a warp's packed counts
  __shared__ unsigned s_red[WARPS];
  __shared__ long long s_u[2], s_excl;
  __shared__ bool s_past[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long live = p.slots * p.bsz;
  if (p.nlive) {
    const long long v = *p.nlive;
    live = (v < 0 ? 0 : (v < p.slots ? v : p.slots)) * p.bsz;
  }
  const long long units = (live + UNIT - 1) / UNIT;
  const unsigned long long tag = (unsigned long long)p.ws.epoch << 32;
  // thread 0: units after `known` are past the cap
  long long known = p.cap == 0 ? -1 : LLONG_MAX;
  auto learn = [&](unsigned long long fw) {
    const long long f = 0xffffffffLL - (long long)(fw & 0xffffffffull);
    if ((unsigned)(fw >> 32) == p.ws.epoch && f < known) known = f;
  };
  if (threadIdx.x == 0) {
    const long long u = atomicAdd(p.ws.ticket, 1u);
    learn(load_status(p.full));
    s_u[0] = u;
    s_past[0] = u > known;
  }
  __syncthreads();
  unsigned cnt = 0;
  int cur = 0;
  for (;;) {
    const long long u = s_u[cur];
    if (u >= units) break;   // uniform over the CTA
    long long nxt = 0;
    unsigned long long fw = 0;
    if (threadIdx.x == 0) {
      nxt = atomicAdd(p.ws.ticket, 1u);
      fw = load_status(p.full);
    }
    const long long c0 = u * UNIT;
    unsigned f[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      f[j] = flags16(p, c0 + (long long)(j * THREADS + threadIdx.x) * VEC,
                     live);
    if (s_past[cur]) {   // uniform: count only
#pragma unroll
      for (int j = 0; j < V; ++j) cnt += __popc(f[j]);
      if (threadIdx.x == 0) {
        store_status(p.ws.status + u, tag | PREFIX | VALUE_MAX);
        s_u[cur ^ 1] = nxt;
        s_past[cur ^ 1] = true;
      }
      __syncthreads();
      cur ^= 1;
      continue;
    }
    unsigned long long pk = 0;
#pragma unroll
    for (int j = 0; j < V; ++j)
      pk |= (unsigned long long)__popc(f[j]) << (16 * j);
    unsigned long long incl = pk;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    unsigned long long before = incl - pk, tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned long long v = s_wsum[w];
      if (w < warp) before += v;
      tot += v;
    }
    int agg = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) agg += (int)((tot >> (16 * j)) & 0xffff);
    if (warp == 0) {
      const long long excl = look_back(p.ws, u, agg, p.cap, lane);
      if (lane == 0) {
        s_excl = excl;
        cnt += (unsigned)agg;
        if (excl + agg >= p.cap && u < known) {
          known = u;
          atomicMax(p.full, tag | (0xffffffffull - (unsigned long long)u));
        }
        learn(fw);
        s_u[cur ^ 1] = nxt;
        s_past[cur ^ 1] = nxt > known;
      }
    }
    int base = 0;   // the unit's set candidates before vector row j
#pragma unroll
    for (int j = 0; j < V; ++j) {
      int at = base + (int)((before >> (16 * j)) & 0xffff);
      const int off = (j * THREADS + threadIdx.x) * VEC;
      for (unsigned m = f[j]; m; m &= m - 1)
        s_stage[at++] = (unsigned short)(off + __ffs(m) - 1);
      base += (int)((tot >> (16 * j)) & 0xffff);
    }
    __syncthreads();
    const long long excl = s_excl;
    if (excl < p.cap) {
      const long long left = p.cap - excl;
      const int nout = agg < left ? agg : (int)left;
#pragma unroll 4
      for (int i = threadIdx.x; i < nout; i += THREADS)
        p.rows[excl + i] = row_of(p, (unsigned)(c0 + s_stage[i]));
    }
    cur ^= 1;
  }
  cnt = __reduce_add_sync(FULL, cnt);
  if (lane == 0) s_red[warp] = cnt;
  __syncthreads();
  unsigned long long cta = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) cta += s_red[w];
  finish(p.ws, cta, [&](unsigned long long total) {
    if (threadIdx.x == 0) *p.count = (int)total;
    if ((long long)total < p.cap) pad(p, (long long)total);
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

// Candidates a unit (the workspace holds one status word a unit).
extern "C" int ordered_compact_unit() { return UNIT; }

// Compacts the mask's candidates in one launch on `stream` (on device
// a->device, the current device): with starts, `slots` blocks of bsz
// candidates; else ncand candidates, row i each. a->ws: the stream's
// workspace of 4 + a->ws_units 64-bit words (one a unit of UNIT
// candidates), left as the kernel found it but for the full word; calls
// that share it run in order, each with a new nonzero epoch. Returns the
// first CUDA error (0 on success).
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
  p.starts = reinterpret_cast<const long long*>(a->starts);
  p.nlive = reinterpret_cast<const int*>(a->nlive);
  if (a->starts) {
    p.slots = a->slots;
    p.bsz = a->bsz;
  } else {
    p.slots = 1;
    p.bsz = a->ncand;
  }
  p.shift = -1;
  if (p.bsz > 0 && (p.bsz & (p.bsz - 1)) == 0)
    for (p.shift = 0; (1LL << p.shift) < p.bsz; ++p.shift) {}
  p.aligned = a->mask % 16 == 0;
  const long long ncand = p.slots * p.bsz;
  const long long units = (ncand + UNIT - 1) / UNIT;
  if (ncand > 0x7fffffffLL || units > a->ws_units)
    return (int)cudaErrorInvalidValue;
  p.full = reinterpret_cast<unsigned long long*>(a->ws) + 3;
  p.ws = make_ws(a->ws, (unsigned)a->epoch);
  unsigned grid = 1;
  cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(ordered_compact_kernel), 0,
      (int)a->device, units, grid);
  if (err != cudaSuccess) return (int)err;
  ordered_compact_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* ordered_compact_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
