// The fused program's candidate scan for Hopper (sm_90a): per candidate of
// the alive blocks, the exact fp62 boxes, time windows and lowered residual
// of every branch, then a count or a mask, in one launch with no host sync.
//
// Replaces mask_of and gathered() of the reference's _jit_program
// (geomesa_tpu/index/compiled.py:476-504): the point primary _point_box_mask
// (scan.py:95, _ge62/_le62 :72-78), _time_mask (:117), the lowered residual
// (compiled._lower_residual :200), __valid__ and the membership of the
// gathered blocks; then jnp.sum (:529); and the same for the K branches of
// _jit_union_program (:950-1052), ORed. Candidate i of the block list is row
// clamp(ids[i / bsz] * bsz, 0, n - bsz) + i % bsz, read in place (no
// gathered copy); it matches when it is its block's own row, __valid__
// holds, and for some branch its point lies in any box, its (bin, off) in
// any window and its residual program holds. Only the first *nlive blocks
// (block_gate.cu's count) are read.
//
// Modes: COUNT writes the int32 count; MASK writes one byte a candidate of
// the live blocks (the input of the refine and density kernels and of
// ordered_compact.cu, which turns it into select's ascending rows) and the
// count.
//
// What bounds it on the card: per candidate 16 bytes of fp62 point planes
// and, where a box holds, 8 bytes of time planes and the residual's
// columns; per (candidate, box) two 64-bit key compares a coordinate. MASK
// writes a byte a candidate. Boxes of a few rows leave it bound by bytes.
//
// Design:
// - Keys, not pairs: the host packs each box bound and window bound as the
//   order-preserving int64 key of box_count.cu (pack62), so a candidate
//   packs its own planes once and compares keys; an empty box (lo > hi)
//   and an empty window hold nothing.
// - The query's packed constants (branch table, box and window keys,
//   residual words and constants: index/scan.py FusedQuery) are staged in
//   shared memory once a CTA.
// - The residual is a postfix program of (op, slot, a, b) words over a
//   stack of booleans kept as the bits of one 64-bit register; its columns
//   are int32, f32 (compared in f32, IEEE, as the plain version's torch
//   compare) or bool bytes (compared as 0/1).
// - Bytes in flight: the live candidates are one flat run, and a thread
//   takes 4 consecutive candidates (a quad) at a time. Where their rows are
//   16-byte aligned, it loads them with one 16-byte streaming load a point
//   plane and one 4-byte load of __valid__, all issued before any compare,
//   and the next quad's loads are issued before this quad's compares (a
//   register double buffer); __valid__ and the membership are tested after
//   the loads. A quad that is not aligned (the clamped last block, a view,
//   a block size that is not a multiple of 4) takes scalar loads, a
//   candidate at a time. In MASK mode a quad's 4 bytes are one 32-bit
//   store.
// - An even split: the live candidates are cut into 1,024-candidate
//   chunks (a quad a thread), and CTA b of the persistent grid (sized by
//   the buffers, never by a value read back) takes chunks b, b + grid, ...,
//   so every CTA's work is equal within one chunk (a stride over
//   4,096-candidate units gave some CTAs twice the mean) and the CTAs'
//   loads stay in one moving window of memory (a contiguous run a CTA
//   was 44% slower over the whole table: PERF.md §6). A CTA with no chunk
//   stages nothing.
// - Three CTAs an SM (__launch_bounds__(THREADS, 3)): the double buffer
//   fits in registers without a spill; four CTAs an SM capped the kernel
//   at 64 registers and spilled, 32% slower over the whole table and 6%
//   at (b)'s mask, 5% faster at (a)'s count (PERF.md §6).
// - One atomic a CTA adds to the workspace total, and the last CTA writes
//   the count (lookback.cuh's finish), so no zeroed output is needed.
// - Tests that fail early skip the loads of the later ones (time planes,
//   residual columns), so a selective box reads only the point planes.

#include "lookback.cuh"

using namespace lookback;

namespace {

constexpr int MAX_SLOTS = 16;
constexpr int QUAD = 4;                  // consecutive candidates a load
constexpr int CHUNK = THREADS * QUAD;    // the split's grain

enum Mode { COUNT = 0, MASK = 1 };
enum Kind { K_I32 = 0, K_F32 = 1, K_BOOL = 2 };
enum Op { OP_TRUE = 0, OP_FALSE, OP_AND, OP_OR, OP_NOT, OP_CMP, OP_IN };

struct Params {
  const int* xi;
  const int* xl;
  const int* yi;
  const int* yl;
  const int* bin;           // null without windows
  const int* off;
  const uint8_t* valid;     // __valid__ per table row, or null
  const void* col[MAX_SLOTS];
  long long kinds;          // 4 bits a slot
  int nslots;
  const int4* qbuf;
  int qwords;               // 16-byte words of qbuf
  int br, box, wkey, prog, cnst;   // byte offsets of the sections
  int nbranch;
  int mode;
  int* out;                 // [count]
  uint8_t* mask;            // MASK: a byte a candidate
  const int* ids;           // block ids, padded with -1
  const int* nlive;         // live blocks on the device
  long long slots, bsz, n;  // candidates: slots x bsz; table rows
  int shift;                // log2(bsz) for a power of two, else -1
  bool vec;                 // quads may take 16-byte loads
  Ws ws;
};

struct BoxKeys {
  long long xlo, xhi, ylo, yhi;
};

// the query's sections in shared memory, and the residual's columns
struct Query {
  const int* br;
  const BoxKeys* box;
  const longlong2* wkey;
  const int4* prog;
  const int* cn;
  const void* const* col;
  const int* kind;
};

__device__ __forceinline__ bool cmp_as(int c, float a, float b) {
  switch (c) {
    case 0: return a == b;
    case 1: return a != b;
    case 2: return a < b;
    case 3: return a <= b;
    case 4: return a > b;
    default: return a >= b;
  }
}

__device__ __forceinline__ bool cmp_as(int c, int a, int b) {
  switch (c) {
    case 0: return a == b;
    case 1: return a != b;
    case 2: return a < b;
    case 3: return a <= b;
    case 4: return a > b;
    default: return a >= b;
  }
}

__device__ __forceinline__ int load_int(const Query& q, int slot,
                                        long long row) {
  const void* c = q.col[slot];
  return q.kind[slot] == K_BOOL
             ? (int)__ldg(reinterpret_cast<const uint8_t*>(c) + row)
             : __ldg(reinterpret_cast<const int*>(c) + row);
}

// the residual program words[0, len) at `row`
__device__ __forceinline__ bool run_program(const Query& q, const int4* words,
                                            int len, long long row) {
  unsigned long long st = 0ull;   // the stack, top at bit 0
  for (int i = 0; i < len; ++i) {
    const int4 w = words[i];
    unsigned long long v;
    switch (w.x) {
      case OP_TRUE: v = 1ull; break;
      case OP_FALSE: v = 0ull; break;
      case OP_AND:
        st = (st >> 2) << 1 | (st & (st >> 1) & 1ull);
        continue;
      case OP_OR:
        st = (st >> 2) << 1 | ((st | (st >> 1)) & 1ull);
        continue;
      case OP_NOT:
        st ^= 1ull;
        continue;
      case OP_CMP:
        if (q.kind[w.y] == K_F32) {
          const float a =
              __ldg(reinterpret_cast<const float*>(q.col[w.y]) + row);
          v = cmp_as(w.z, a, __int_as_float(q.cn[w.w]));
        } else {
          v = cmp_as(w.z, load_int(q, w.y, row), q.cn[w.w]);
        }
        break;
      default: {   // OP_IN
        const int a = load_int(q, w.y, row);
        bool in = false;
        for (int j = 0; j < w.w; ++j) in |= a == q.cn[w.z + j];
        v = in;
      }
    }
    st = st << 1 | v;
  }
  return st & 1ull;
}

// any branch holds at `row`, whose point keys are x, y
__device__ __forceinline__ bool matches(const Params& p, const Query& q,
                                        long long x, long long y,
                                        long long row) {
  bool have_t = false;
  long long tk = 0;
  for (int k = 0; k < p.nbranch; ++k) {
    const int* r = q.br + 8 * k;
    bool in = false;
    for (int j = r[0], e = r[0] + r[1]; j < e && !in; ++j) {
      const BoxKeys b = q.box[j];
      in = (x >= b.xlo) & (x <= b.xhi) & (y >= b.ylo) & (y <= b.yhi);
    }
    if (!in) continue;
    if (r[3] > 0) {
      if (!have_t) {
        tk = pack62(__ldg(p.bin + row), __ldg(p.off + row));
        have_t = true;
      }
      in = false;
      for (int j = r[2], e = r[2] + r[3]; j < e && !in; ++j) {
        const longlong2 w = q.wkey[j];
        in = (tk >= w.x) & (tk <= w.y);
      }
      if (!in) continue;
    }
    if (r[5] > 0 && !run_program(q, q.prog + r[4], r[5], row)) continue;
    return true;
  }
  return false;
}

// the slot of candidate c and the table row of its block's first candidate
// (the clamped start); lo, hi: the rows that are the block's own
__device__ __forceinline__ long long block_of(const Params& p, unsigned c,
                                              unsigned& slot, long long& lo,
                                              long long& hi) {
  slot = p.shift >= 0 ? c >> p.shift : c / (unsigned)p.bsz;
  const int b = __ldg(p.ids + slot);
  const long long start = (long long)b * p.bsz;
  const long long top = p.n > p.bsz ? p.n - p.bsz : 0;
  lo = start;
  hi = b < 0 ? start : (start + p.bsz < p.n ? start + p.bsz : p.n);
  return start < 0 ? 0 : (start > top ? top : start);
}

// a quad's loads: its rows row0 .. row0 + 3, their point planes and
// __valid__ bytes, and the member rows' bits
struct Quad {
  int4 xi, xl, yi, yl;
  unsigned valid;
  unsigned member;   // bit j: row0 + j is its block's own row
  long long row0;
  bool vec;          // loaded; else the scalar path
};

__device__ __forceinline__ int lane_of(const int4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// issue quad q's loads, or mark it for the scalar path
__device__ __forceinline__ void load_quad(const Params& p, long long q,
                                          Quad& d) {
  d.vec = false;
  if (!p.vec) return;
  unsigned slot;
  long long lo, hi;
  const unsigned c = (unsigned)(q * QUAD);
  const long long rs = block_of(p, c, slot, lo, hi);
  d.row0 = rs + (c - slot * (unsigned)p.bsz);
  if (d.row0 & 3) return;
  d.vec = true;
  d.xi = __ldcs(reinterpret_cast<const int4*>(p.xi + d.row0));
  d.xl = __ldcs(reinterpret_cast<const int4*>(p.xl + d.row0));
  d.yi = __ldcs(reinterpret_cast<const int4*>(p.yi + d.row0));
  d.yl = __ldcs(reinterpret_cast<const int4*>(p.yl + d.row0));
  d.valid = p.valid
      ? __ldcs(reinterpret_cast<const unsigned*>(p.valid + d.row0))
      : 0x01010101u;
  d.member = 0;
#pragma unroll
  for (int j = 0; j < QUAD; ++j)
    d.member |= (unsigned)(d.row0 + j >= lo && d.row0 + j < hi) << j;
}

// a loaded quad's flags, 0 or 1 a byte
__device__ __forceinline__ unsigned test_quad(const Params& p,
                                              const Query& q,
                                              const Quad& d) {
  unsigned bytes = 0;
#pragma unroll
  for (int j = 0; j < QUAD; ++j) {
    if (!((d.member >> j) & 1u) || !((d.valid >> (8 * j)) & 0xffu))
      continue;
    const long long x = pack62(lane_of(d.xi, j), lane_of(d.xl, j));
    const long long y = pack62(lane_of(d.yi, j), lane_of(d.yl, j));
    if (matches(p, q, x, y, d.row0 + j)) bytes |= 1u << (8 * j);
  }
  return bytes;
}

// quad q a candidate at a time (loads behind each test); the flags, 0 or
// 1 a byte, of its candidates below live
__device__ __forceinline__ unsigned scalar_quad(const Params& p,
                                                const Query& q, long long qd,
                                                long long live) {
  unsigned bytes = 0;
  for (int j = 0; j < QUAD; ++j) {
    const long long c = qd * QUAD + j;
    if (c >= live) break;
    unsigned slot;
    long long lo, hi;
    const long long rs = block_of(p, (unsigned)c, slot, lo, hi);
    const long long row = rs + ((unsigned)c - slot * (unsigned)p.bsz);
    if (row < lo || row >= hi || (p.valid && !p.valid[row])) continue;
    const long long x = pack62(__ldg(p.xi + row), __ldg(p.xl + row));
    const long long y = pack62(__ldg(p.yi + row), __ldg(p.yl + row));
    if (matches(p, q, x, y, row)) bytes |= 1u << (8 * j);
  }
  return bytes;
}

// COUNT or MASK (p.mode): the live candidates' chunks, strided over the grid
__global__ void __launch_bounds__(THREADS, 3)
fused_scan_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const void* s_col[MAX_SLOTS];
  __shared__ int s_kind[MAX_SLOTS];
  __shared__ unsigned s_cnt[WARPS];
  long long k = *p.nlive;
  k = k < 0 ? 0 : (k < p.slots ? k : p.slots);
  const long long live = k * p.bsz;
  unsigned cnt = 0;
  if ((long long)blockIdx.x * CHUNK < live) {   // uniform over the CTA
    for (int i = threadIdx.x; i < p.qwords; i += THREADS)
      reinterpret_cast<int4*>(smem)[i] = __ldg(p.qbuf + i);
    if (threadIdx.x < p.nslots) {
      s_col[threadIdx.x] = p.col[threadIdx.x];
      s_kind[threadIdx.x] = (int)((p.kinds >> (4 * threadIdx.x)) & 15);
    }
    __syncthreads();
    Query q;
    q.br = reinterpret_cast<const int*>(smem + p.br);
    q.box = reinterpret_cast<const BoxKeys*>(smem + p.box);
    q.wkey = reinterpret_cast<const longlong2*>(smem + p.wkey);
    q.prog = reinterpret_cast<const int4*>(smem + p.prog);
    q.cn = reinterpret_cast<const int*>(smem + p.cnst);
    q.col = s_col;
    q.kind = s_kind;

    const long long quads = (live + QUAD - 1) / QUAD;
    const long long step = (long long)gridDim.x * THREADS;
    long long qd = (long long)blockIdx.x * THREADS + threadIdx.x;
    Quad cur;
    if (qd < quads) load_quad(p, qd, cur);
    while (qd < quads) {
      const long long qn = qd + step;
      Quad nxt;
      if (qn < quads) load_quad(p, qn, nxt);
      const unsigned bytes =
          cur.vec ? test_quad(p, q, cur) : scalar_quad(p, q, qd, live);
      cnt += __popc(bytes);
      if (p.mode == MASK) {
        if (qd * QUAD + QUAD <= live) {
          reinterpret_cast<unsigned*>(p.mask)[qd] = bytes;
        } else {
          for (long long c = qd * QUAD; c < live; ++c)
            p.mask[c] = (uint8_t)((bytes >> (8 * (c - qd * QUAD))) & 1u);
        }
      }
      qd = qn;
      cur = nxt;
    }
  }
  cnt = __reduce_add_sync(FULL, cnt);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  unsigned long long cta = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) cta += s_cnt[w];
  finish(p.ws, cta, [&](unsigned long long total) {
    if (threadIdx.x == 0) p.out[0] = (int)total;
  });
}

}  // namespace

// The launch's arguments as the wrapper packs them (kernels/fused_scan.py
// _ARGS): 8-byte slots, pointers 0 for none.
struct FusedScanArgs {
  long long xi, xl, yi, yl, bin, off, valid;
  long long col[MAX_SLOTS];
  long long kinds, nslots;
  long long qbuf, qbytes, br, box, wkey, prog, cnst, nbranch;
  long long ids, nlive, slots, bsz, n;
  long long mode, out, mask;
  long long ws, epoch, device;
};
static_assert(sizeof(FusedScanArgs) == 44 * 8, "FusedScanArgs must match _ARGS");


// Scans the candidates of the first *nlive of the `slots` blocks of `ids`
// in one launch on `stream` (on device a->device, the current device).
// a->ws: the stream's workspace (its first 4 64-bit words: the count's
// total and done counter), left as the kernel found it; calls that share it
// run in order, each with a new nonzero epoch. Returns the first CUDA error
// (0 on success).
extern "C" int fused_scan_launch(const FusedScanArgs* a, void* stream) {
  if (a->bsz <= 0 || a->slots < 0 || a->qbytes % 16 || a->epoch == 0
      || a->nslots < 0 || a->nslots > MAX_SLOTS || a->mode < COUNT
      || a->mode > MASK || !a->nlive || a->mask % 4
      || a->slots * a->bsz > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xi = reinterpret_cast<const int*>(a->xi);
  p.xl = reinterpret_cast<const int*>(a->xl);
  p.yi = reinterpret_cast<const int*>(a->yi);
  p.yl = reinterpret_cast<const int*>(a->yl);
  p.bin = reinterpret_cast<const int*>(a->bin);
  p.off = reinterpret_cast<const int*>(a->off);
  p.valid = reinterpret_cast<const uint8_t*>(a->valid);
  for (int k = 0; k < MAX_SLOTS; ++k)
    p.col[k] = reinterpret_cast<const void*>(a->col[k]);
  p.kinds = a->kinds;
  p.nslots = (int)a->nslots;
  p.qbuf = reinterpret_cast<const int4*>(a->qbuf);
  p.qwords = (int)(a->qbytes / 16);
  p.br = (int)a->br;
  p.box = (int)a->box;
  p.wkey = (int)a->wkey;
  p.prog = (int)a->prog;
  p.cnst = (int)a->cnst;
  p.nbranch = (int)a->nbranch;
  p.mode = (int)a->mode;
  p.out = reinterpret_cast<int*>(a->out);
  p.mask = reinterpret_cast<uint8_t*>(a->mask);
  p.ids = reinterpret_cast<const int*>(a->ids);
  p.nlive = reinterpret_cast<const int*>(a->nlive);
  p.slots = a->slots;
  p.bsz = a->bsz;
  p.n = a->n;
  p.shift = -1;
  if ((a->bsz & (a->bsz - 1)) == 0)
    for (p.shift = 0; (1LL << p.shift) < a->bsz; ++p.shift) {}
  p.vec = a->bsz % QUAD == 0 && a->xi % 16 == 0 && a->xl % 16 == 0
          && a->yi % 16 == 0 && a->yl % 16 == 0 && a->valid % 4 == 0;
  p.ws = make_ws(a->ws, (unsigned)a->epoch);
  const size_t smem = (size_t)a->qbytes;
  unsigned grid = 1;
  cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(fused_scan_kernel), smem, (int)a->device,
      (a->slots * a->bsz + CHUNK - 1) / CHUNK, grid);
  if (err != cudaSuccess) return (int)err;
  fused_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
