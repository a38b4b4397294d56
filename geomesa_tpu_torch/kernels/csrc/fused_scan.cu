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
// (block_gate.cu's count) are read. A branch flagged boxless (the staged
// scans of a plan without a spatial primary: the reference's _mask_kernel
// with primary "none", index/scan.py:368) has no box test, and a query of
// such branches alone reads no point plane (the kernel's BOXLESS form).
// A query under authorizations also tests the row's visibility code
// (__vis__) against the allowed codes, once for the whole query (the
// reference's vis section, compiled.py:482-485 and :994-997, and the staged
// modes' folded residual, planner.py:283-296; the kernel's VIS form).
//
// The RUNS form replaces the attribute index's staged count_at and
// select_at (geomesa_tpu/index/scan.py:603-619): there the candidates are
// the rows of a plan's sorted, disjoint runs [lo, hi) of index positions,
// which the reference gathers at materialised, padded positions. Here a run
// is cut into pieces, one a block of the candidate space: piece k is block
// ids[k] (read in place, clamped as above) with its own row range
// runs[k] = [lo, hi) inside it, and candidate i of piece k is a member when
// its row lies in that range. A block holding several short runs appears
// once for each; a run that spans many blocks is many pieces. A quad with
// no member row issues no load, so a short run reads its own quads only.
//
// Modes: COUNT writes the int32 count; MASK writes one byte a candidate of
// the live blocks (the input of the refine and density kernels and of
// ordered_compact.cu, which turns it into select's ascending rows) and the
// count.
//
// What bounds it on the card: per candidate 16 bytes of fp62 point planes
// and, where a box holds, 8 bytes of time planes and the residual's
// columns (every branch boxless: the time planes and the residual's
// columns for every candidate); per (candidate, box) two 64-bit key
// compares a coordinate; in the VIS form 4 bytes of __vis__ more a
// candidate. MASK writes a byte a candidate. Boxes of a few rows leave it
// bound by bytes.
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
// - A query without boxes (every branch boxless, as the staged scans of a
//   plan without a spatial primary) needs every candidate's time planes
//   and residual columns, so a quad is tested as one: the vector loads
//   take the time planes and the residual's first two columns (yi, yl;
//   the others load at the test, 16 bytes at a time where aligned), and
//   each branch row, window key and program word is read and decoded once
//   a quad, its compares made for the four lanes together (four stacks,
//   one a lane). Decoding a candidate at a time held the boxless scan at
//   the same device time whether or not its column was a vector load. The
//   form is a template instantiation of its own (BOXLESS): in one body
//   with the boxed form it spilled the boxed form's registers, 3-4% slower
//   at the boxed shapes (PERF.md section 6).
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
// - Visibility as a bitmap: the allowed codes are one bit a code in the
//   query buffer (index/scan.py FusedQuery's vis section, staged in shared
//   memory with the rest), and the __vis__ plane is one more 16-byte load
//   of the quad, beside __valid__: 4 bytes and one shared-memory bit probe
//   a candidate, before the boxes. A list of allowed codes would cost a
//   compare a code a candidate, and a residual slot would take one of the
//   user's MAX_SLOTS columns. The VIS form is a template instantiation of
//   its own, so a query without authorizations runs the code it ran before
//   (its registers and spills unchanged).
// - RUNS is a template instantiation of its own for the same reason: the
//   block form reads no run bounds and keeps its code.
//
// The ENV form replaces the envelope primary of extent layers (lines and
// polygons): the reference's _bbox_overlap_pairwise through _mask_kernel
// (geomesa_tpu/index/scan.py:100-114, :368), which the staged modes of an
// XZ2/XZ3 layer run for their counts, masks, selects and densities. A row
// is then an envelope, eight fp62 planes (bxmin, bxmax, bymin, bymax, each
// an int/frac pair), and it lies in a box when the envelope overlaps it:
// bxmin <= qxhi, bxmax >= qxlo, bymin <= qyhi and bymax >= qylo, compared
// as pack62 keys like the point form's (so the host packs the same box
// keys). Its design, a first one:
// - ENV is a template instantiation of its own (as BOXLESS, VIS and RUNS
//   are), so the point form's registers stay as they were; it takes the
//   block, table, RUNS and VIS shapes and both modes. A branch without
//   boxes keeps the r[6] flag; a query of such branches alone takes the
//   BOXLESS form, which reads no spatial plane of either kind.
// - A quad loads its eight envelope planes with eight 16-byte streaming
//   loads, all issued before any compare, but without the point form's
//   register double buffer: two quads of eight planes would hold 64
//   registers of loads a thread and spill at three CTAs an SM. The three
//   CTAs' 24 warps an SM keep the loads in flight instead.
// - What bounds it: 32 bytes of envelope planes a candidate, __valid__'s
//   byte, and in MASK mode a byte written; per (candidate, box) four
//   64-bit key compares.

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
  const int* xi;            // ENV: the envelope's bxmin planes, then bymin
  const int* xl;
  const int* yi;
  const int* yl;
  const int* hxi;           // ENV: bxmax_i, bxmax_l, bymax_i, bymax_l
  const int* hxl;
  const int* hyi;
  const int* hyl;
  const int* bin;           // null without windows
  const int* off;
  const uint8_t* valid;     // __valid__ per table row, or null
  const void* col[MAX_SLOTS];
  long long kinds;          // 4 bits a slot
  int nslots;
  const int4* qbuf;
  int qwords;               // 16-byte words of qbuf
  int br, box, wkey, prog, cnst;   // byte offsets of the sections
  const int* vis_col;       // VIS: the __vis__ codes per table row
  int vis, vis_words;       // VIS: the bitmap's byte offset and words
  int nbranch;
  int npre;                 // boxless: residual slots in the quad's loads
  unsigned aligned;         // bit k: residual slot k loads 16 (bool 4) bytes
  int mode;
  int* out;                 // [count]
  uint8_t* mask;            // MASK: a byte a candidate
  const int* ids;           // block ids, padded with -1
  const int2* runs;         // RUNS: each slot's rows [lo, hi)
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
  const unsigned* vis;   // VIS: the allowed codes' bitmap
  int vis_bits;
};

// code c is allowed: its bit is set in the bitmap (codes past it are not)
__device__ __forceinline__ bool vis_ok(const Query& q, int c) {
  return (unsigned)c < (unsigned)q.vis_bits
         && ((q.vis[(unsigned)c >> 5] >> (c & 31)) & 1u);
}

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

// any branch holds at `row`, whose point keys are x, y (ENV: whose
// envelope keys are x..x1, y..y1)
template <bool ENV>
__device__ __forceinline__ bool matches(const Params& p, const Query& q,
                                        long long x, long long y,
                                        long long x1, long long y1,
                                        long long row) {
  bool have_t = false;
  long long tk = 0;
  for (int k = 0; k < p.nbranch; ++k) {
    const int* r = q.br + 8 * k;
    bool in = r[6] != 0;   // a boxless branch: every row is in its boxes
    for (int j = r[0], e = r[0] + r[1]; j < e && !in; ++j) {
      const BoxKeys b = q.box[j];
      in = ENV ? (x <= b.xhi) & (x1 >= b.xlo) & (y <= b.yhi) & (y1 >= b.ylo)
               : (x >= b.xlo) & (x <= b.xhi) & (y >= b.ylo) & (y <= b.yhi);
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
// (the clamped start); lo, hi: the rows that are members, the block's own
// (RUNS: the slot's run piece)
template <bool RUNS>
__device__ __forceinline__ long long block_of(const Params& p, unsigned c,
                                              unsigned& slot, long long& lo,
                                              long long& hi) {
  slot = p.shift >= 0 ? c >> p.shift : c / (unsigned)p.bsz;
  const int b = __ldg(p.ids + slot);
  const long long start = (long long)b * p.bsz;
  const long long top = p.n > p.bsz ? p.n - p.bsz : 0;
  if (RUNS) {
    const int2 r = __ldg(p.runs + slot);
    lo = b < 0 ? 0 : r.x;
    hi = b < 0 ? 0 : r.y;
  } else {
    lo = start;
    hi = b < 0 ? start : (start + p.bsz < p.n ? start + p.bsz : p.n);
  }
  return start < 0 ? 0 : (start > top ? top : start);
}

// a quad's loads: its rows row0 .. row0 + 3, their point planes (or, in a
// query without boxes, their time planes bin and off in xi and xl and the
// residual's slots 0 and 1 in yi and yl) and __valid__ bytes, and the
// member rows' bits
struct Quad {
  int4 xi, xl, yi, yl;
  int4 vc;           // VIS: the rows' __vis__ codes
  unsigned valid;
  unsigned member;   // bit j: row0 + j is its block's own row
  long long row0;
  bool vec;          // loaded; else the scalar path
};

// ENV: a quad's envelope maxima beside its minima (xi..yl)
template <bool ENV>
struct QuadT : Quad {};
template <>
struct QuadT<true> : Quad {
  int4 hxi, hxl, hyi, hyl;
};

__device__ __forceinline__ int lane_of(const int4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// residual slot `slot` at rows row0 .. row0 + 3 (bool bytes widened to
// 0/1 ints), in one load where the column is aligned
__device__ __forceinline__ int4 load_slot(const Params& p, int slot,
                                          long long row0) {
  const bool b = ((p.kinds >> (4 * slot)) & 15) == K_BOOL;
  const bool vec = (p.aligned >> slot) & 1u;
  if (b) {
    const uint8_t* c = static_cast<const uint8_t*>(p.col[slot]) + row0;
    if (!vec)
      return make_int4(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3));
    const unsigned u = __ldcs(reinterpret_cast<const unsigned*>(c));
    return make_int4(u & 0xffu, (u >> 8) & 0xffu, (u >> 16) & 0xffu, u >> 24);
  }
  const int* c = static_cast<const int*>(p.col[slot]) + row0;
  if (!vec)
    return make_int4(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3));
  return __ldcs(reinterpret_cast<const int4*>(c));
}

// issue quad q's loads, or mark it for the scalar path
template <bool BOXLESS, bool VIS, bool RUNS, bool ENV>
__device__ __forceinline__ void load_quad(const Params& p, long long q,
                                          QuadT<ENV>& d) {
  d.vec = false;
  if (!p.vec) return;
  unsigned slot;
  long long lo, hi;
  const unsigned c = (unsigned)(q * QUAD);
  const long long rs = block_of<RUNS>(p, c, slot, lo, hi);
  d.row0 = rs + (c - slot * (unsigned)p.bsz);
  if (d.row0 & 3) return;
  d.vec = true;
  if (RUNS) {   // a quad outside its piece's run loads nothing
    d.member = 0;
#pragma unroll
    for (int j = 0; j < QUAD; ++j)
      d.member |= (unsigned)(d.row0 + j >= lo && d.row0 + j < hi) << j;
    if (!d.member) return;
  }
  if (!BOXLESS) {
    d.xi = __ldcs(reinterpret_cast<const int4*>(p.xi + d.row0));
    d.xl = __ldcs(reinterpret_cast<const int4*>(p.xl + d.row0));
    d.yi = __ldcs(reinterpret_cast<const int4*>(p.yi + d.row0));
    d.yl = __ldcs(reinterpret_cast<const int4*>(p.yl + d.row0));
    if constexpr (ENV) {
      d.hxi = __ldcs(reinterpret_cast<const int4*>(p.hxi + d.row0));
      d.hxl = __ldcs(reinterpret_cast<const int4*>(p.hxl + d.row0));
      d.hyi = __ldcs(reinterpret_cast<const int4*>(p.hyi + d.row0));
      d.hyl = __ldcs(reinterpret_cast<const int4*>(p.hyl + d.row0));
    }
  } else {   // no box: the time planes and residual columns take them
    const int4 z = make_int4(0, 0, 0, 0);
    d.xi = p.bin ? __ldcs(reinterpret_cast<const int4*>(p.bin + d.row0)) : z;
    d.xl = p.bin ? __ldcs(reinterpret_cast<const int4*>(p.off + d.row0)) : z;
    d.yi = p.npre > 0 ? load_slot(p, 0, d.row0) : z;
    d.yl = p.npre > 1 ? load_slot(p, 1, d.row0) : z;
  }
  d.valid = p.valid
      ? __ldcs(reinterpret_cast<const unsigned*>(p.valid + d.row0))
      : 0x01010101u;
  if (VIS) d.vc = __ldcs(reinterpret_cast<const int4*>(p.vis_col + d.row0));
  if (RUNS) return;
  d.member = 0;
#pragma unroll
  for (int j = 0; j < QUAD; ++j)
    d.member |= (unsigned)(d.row0 + j >= lo && d.row0 + j < hi) << j;
}

// a loaded quad's flags, 0 or 1 a byte
template <bool VIS, bool ENV>
__device__ __forceinline__ unsigned test_quad(const Params& p,
                                              const Query& q,
                                              const QuadT<ENV>& d) {
  unsigned bytes = 0;
#pragma unroll
  for (int j = 0; j < QUAD; ++j) {
    if (!((d.member >> j) & 1u) || !((d.valid >> (8 * j)) & 0xffu))
      continue;
    if (VIS && !vis_ok(q, lane_of(d.vc, j))) continue;
    const long long x = pack62(lane_of(d.xi, j), lane_of(d.xl, j));
    const long long y = pack62(lane_of(d.yi, j), lane_of(d.yl, j));
    long long x1 = x, y1 = y;
    if constexpr (ENV) {
      x1 = pack62(lane_of(d.hxi, j), lane_of(d.hxl, j));
      y1 = pack62(lane_of(d.hyi, j), lane_of(d.hyl, j));
    }
    if (matches<ENV>(p, q, x, y, x1, y1, d.row0 + j))
      bytes |= 1u << (8 * j);
  }
  return bytes;
}

// the lanes (bit j: lane j) where compare c of a's four lanes with b holds
template <typename T>
__device__ __forceinline__ unsigned cmp4(int c, T a0, T a1, T a2, T a3,
                                         T b) {
#define GM_LANES(OP)                                                    \
  ((unsigned)(a0 OP b) | (unsigned)(a1 OP b) << 1 |                     \
   (unsigned)(a2 OP b) << 2 | (unsigned)(a3 OP b) << 3)
  switch (c) {
    case 0: return GM_LANES(==);
    case 1: return GM_LANES(!=);
    case 2: return GM_LANES(<);
    case 3: return GM_LANES(<=);
    case 4: return GM_LANES(>);
    default: return GM_LANES(>=);
  }
#undef GM_LANES
}

// residual slot `slot` at the quad's four rows
__device__ __forceinline__ int4 slot_lanes(const Params& p, const Quad& d,
                                           int slot) {
  if (slot < p.npre) return slot == 0 ? d.yi : d.yl;
  return load_slot(p, slot, d.row0);
}

// the residual program words[0, len) at a quad's four rows: the lanes
// where it holds. One stack a lane, top at bit 0, each word decoded once.
__device__ __forceinline__ unsigned run_program4(const Params& p,
                                                 const Query& q,
                                                 const int4* words, int len,
                                                 const Quad& d) {
  unsigned long long s0 = 0ull, s1 = 0ull, s2 = 0ull, s3 = 0ull;
  for (int i = 0; i < len; ++i) {
    const int4 w = words[i];
    unsigned v;
    switch (w.x) {
      case OP_TRUE: v = 15u; break;
      case OP_FALSE: v = 0u; break;
      case OP_AND:
        s0 = (s0 >> 2) << 1 | (s0 & (s0 >> 1) & 1ull);
        s1 = (s1 >> 2) << 1 | (s1 & (s1 >> 1) & 1ull);
        s2 = (s2 >> 2) << 1 | (s2 & (s2 >> 1) & 1ull);
        s3 = (s3 >> 2) << 1 | (s3 & (s3 >> 1) & 1ull);
        continue;
      case OP_OR:
        s0 = (s0 >> 2) << 1 | ((s0 | (s0 >> 1)) & 1ull);
        s1 = (s1 >> 2) << 1 | ((s1 | (s1 >> 1)) & 1ull);
        s2 = (s2 >> 2) << 1 | ((s2 | (s2 >> 1)) & 1ull);
        s3 = (s3 >> 2) << 1 | ((s3 | (s3 >> 1)) & 1ull);
        continue;
      case OP_NOT:
        s0 ^= 1ull;
        s1 ^= 1ull;
        s2 ^= 1ull;
        s3 ^= 1ull;
        continue;
      case OP_CMP: {
        const int4 a = slot_lanes(p, d, w.y);
        v = q.kind[w.y] == K_F32
                ? cmp4(w.z, __int_as_float(a.x), __int_as_float(a.y),
                       __int_as_float(a.z), __int_as_float(a.w),
                       __int_as_float(q.cn[w.w]))
                : cmp4(w.z, a.x, a.y, a.z, a.w, q.cn[w.w]);
        break;
      }
      default: {   // OP_IN
        const int4 a = slot_lanes(p, d, w.y);
        v = 0u;
        for (int j = 0; j < w.w; ++j) v |= cmp4(0, a.x, a.y, a.z, a.w,
                                                q.cn[w.z + j]);
      }
    }
    s0 = s0 << 1 | (v & 1u);
    s1 = s1 << 1 | ((v >> 1) & 1u);
    s2 = s2 << 1 | ((v >> 2) & 1u);
    s3 = s3 << 1 | ((v >> 3) & 1u);
  }
  return (unsigned)(s0 & 1ull) | (unsigned)(s1 & 1ull) << 1
         | (unsigned)(s2 & 1ull) << 2 | (unsigned)(s3 & 1ull) << 3;
}

// a loaded quad's flags in a query without boxes (time planes in xi, xl),
// 0 or 1 a byte: each branch's windows and program for the four lanes
template <bool VIS>
__device__ __forceinline__ unsigned test_quad_boxless(const Params& p,
                                                      const Query& q,
                                                      const Quad& d) {
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < QUAD; ++j)
    live |= (unsigned)(((d.member >> j) & 1u)
                       && ((d.valid >> (8 * j)) & 0xffu)
                       && (!VIS || vis_ok(q, lane_of(d.vc, j)))) << j;
  unsigned hit = 0;
  for (int k = 0; k < p.nbranch && (live & ~hit); ++k) {
    const int* r = q.br + 8 * k;
    unsigned in = live & ~hit;
    if (r[3] > 0) {   // the time keys live only here (registers)
      const long long t0 = pack62(d.xi.x, d.xl.x);
      const long long t1 = pack62(d.xi.y, d.xl.y);
      const long long t2 = pack62(d.xi.z, d.xl.z);
      const long long t3 = pack62(d.xi.w, d.xl.w);
      unsigned win = 0;
      for (int j = r[2], e = r[2] + r[3]; j < e && (in & ~win); ++j) {
        const longlong2 w = q.wkey[j];
        win |= (unsigned)((t0 >= w.x) & (t0 <= w.y))
               | (unsigned)((t1 >= w.x) & (t1 <= w.y)) << 1
               | (unsigned)((t2 >= w.x) & (t2 <= w.y)) << 2
               | (unsigned)((t3 >= w.x) & (t3 <= w.y)) << 3;
      }
      in &= win;
    }
    if (in && r[5] > 0) in &= run_program4(p, q, q.prog + r[4], r[5], d);
    hit |= in;
  }
  return (hit & 1u) | ((hit >> 1) & 1u) << 8 | ((hit >> 2) & 1u) << 16
         | ((hit >> 3) & 1u) << 24;
}

// quad q a candidate at a time (loads behind each test); the flags, 0 or
// 1 a byte, of its candidates below live
template <bool BOXLESS, bool VIS, bool RUNS, bool ENV>
__device__ __forceinline__ unsigned scalar_quad(const Params& p,
                                                const Query& q, long long qd,
                                                long long live) {
  unsigned bytes = 0;
  for (int j = 0; j < QUAD; ++j) {
    const long long c = qd * QUAD + j;
    if (c >= live) break;
    unsigned slot;
    long long lo, hi;
    const long long rs = block_of<RUNS>(p, (unsigned)c, slot, lo, hi);
    const long long row = rs + ((unsigned)c - slot * (unsigned)p.bsz);
    if (row < lo || row >= hi || (p.valid && !p.valid[row])) continue;
    if (VIS && !vis_ok(q, __ldg(p.vis_col + row))) continue;
    const long long x =
        BOXLESS ? 0 : pack62(__ldg(p.xi + row), __ldg(p.xl + row));
    const long long y =
        BOXLESS ? 0 : pack62(__ldg(p.yi + row), __ldg(p.yl + row));
    const long long x1 =
        ENV ? pack62(__ldg(p.hxi + row), __ldg(p.hxl + row)) : x;
    const long long y1 =
        ENV ? pack62(__ldg(p.hyi + row), __ldg(p.hyl + row)) : y;
    if (matches<ENV>(p, q, x, y, x1, y1, row)) bytes |= 1u << (8 * j);
  }
  return bytes;
}

// COUNT or MASK (p.mode): the live candidates' chunks, strided over the
// grid. BOXLESS: every branch is boxless (its own instantiation, so the
// boxed form keeps its registers); VIS: the query tests visibility; RUNS:
// each slot is a run piece (its members p.runs[slot]); ENV: the rows are
// envelopes (never with BOXLESS)
template <bool BOXLESS, bool VIS, bool RUNS, bool ENV>
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
    q.vis = reinterpret_cast<const unsigned*>(smem + p.vis);
    q.vis_bits = p.vis_words * 32;

    const long long quads = (live + QUAD - 1) / QUAD;
    const long long step = (long long)gridDim.x * THREADS;
    long long qd = (long long)blockIdx.x * THREADS + threadIdx.x;
    QuadT<ENV> cur;   // ENV loads each quad as it comes (no double buffer)
    if (!ENV && qd < quads) load_quad<BOXLESS, VIS, RUNS, ENV>(p, qd, cur);
    while (qd < quads) {
      const long long qn = qd + step;
      QuadT<ENV> nxt;
      if (ENV)
        load_quad<BOXLESS, VIS, RUNS, ENV>(p, qd, cur);
      else if (qn < quads)
        load_quad<BOXLESS, VIS, RUNS, ENV>(p, qn, nxt);
      const unsigned bytes =
          !cur.vec ? scalar_quad<BOXLESS, VIS, RUNS, ENV>(p, q, qd, live)
                   : (BOXLESS ? test_quad_boxless<VIS>(p, q, cur)
                              : test_quad<VIS, ENV>(p, q, cur));
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
      if (!ENV) cur = nxt;
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
// _ARGS): 8-byte slots, pointers 0 for none. vis_col 0: no visibility test;
// runs 0: the block form (else int2 [lo, hi) a slot, the RUNS form); env 1:
// the rows are envelopes, xi..yl their bxmin_i, bxmin_l, bymin_i, bymin_l
// planes and hxi..hyl their bxmax_i, bxmax_l, bymax_i, bymax_l (the ENV
// form, when the query has boxes).
struct FusedScanArgs {
  long long xi, xl, yi, yl, bin, off, valid;
  long long col[MAX_SLOTS];
  long long kinds, nslots;
  long long qbuf, qbytes, br, box, wkey, prog, cnst, nbranch, points;
  long long vis_col, vis, vis_words;
  long long ids, runs, nlive, slots, bsz, n;
  long long mode, out, mask;
  long long ws, epoch, device;
  long long hxi, hxl, hyi, hyl, env;
};
static_assert(sizeof(FusedScanArgs) == 54 * 8, "FusedScanArgs must match _ARGS");


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
      || a->slots * a->bsz > 0xffffffffLL || a->runs % 8
      || (a->vis_col && (a->vis_words <= 0 || a->vis < 0 || a->vis % 16
                         || a->vis + 4 * a->vis_words > a->qbytes)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xi = reinterpret_cast<const int*>(a->xi);
  p.xl = reinterpret_cast<const int*>(a->xl);
  p.yi = reinterpret_cast<const int*>(a->yi);
  p.yl = reinterpret_cast<const int*>(a->yl);
  const bool env = a->env && a->points;
  p.hxi = reinterpret_cast<const int*>(a->hxi);
  p.hxl = reinterpret_cast<const int*>(a->hxl);
  p.hyi = reinterpret_cast<const int*>(a->hyi);
  p.hyl = reinterpret_cast<const int*>(a->hyl);
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
  p.vis_col = reinterpret_cast<const int*>(a->vis_col);
  p.vis = (int)a->vis;
  p.vis_words = a->vis_col ? (int)a->vis_words : 0;
  p.nbranch = (int)a->nbranch;
  p.mode = (int)a->mode;
  p.out = reinterpret_cast<int*>(a->out);
  p.mask = reinterpret_cast<uint8_t*>(a->mask);
  p.ids = reinterpret_cast<const int*>(a->ids);
  p.runs = reinterpret_cast<const int2*>(a->runs);
  p.nlive = reinterpret_cast<const int*>(a->nlive);
  p.slots = a->slots;
  p.bsz = a->bsz;
  p.n = a->n;
  p.shift = -1;
  if ((a->bsz & (a->bsz - 1)) == 0)
    for (p.shift = 0; (1LL << p.shift) < a->bsz; ++p.shift) {}
  p.vec = a->bsz % QUAD == 0 && a->valid % 4 == 0 && a->vis_col % 16 == 0
          && (a->points ? a->xi % 16 == 0 && a->xl % 16 == 0
                             && a->yi % 16 == 0 && a->yl % 16 == 0
                       : a->bin % 16 == 0 && a->off % 16 == 0)
          && (!env || (a->hxi % 16 == 0 && a->hxl % 16 == 0
                       && a->hyi % 16 == 0 && a->hyl % 16 == 0));
  p.aligned = 0;   // the residual slots that load a quad at a time
  for (int k = 0; k < p.nslots; ++k) {
    const bool b = ((a->kinds >> (4 * k)) & 15) == K_BOOL;
    p.aligned |= (unsigned)(a->col[k] % (b ? 4 : 16) == 0) << k;
  }
  p.npre = 0;   // of them, the leading two take the double buffer
  while (!a->points && p.npre < 2 && ((p.aligned >> p.npre) & 1u)) ++p.npre;
  p.ws = make_ws(a->ws, (unsigned)a->epoch);
  const size_t smem = (size_t)a->qbytes;
  unsigned grid = 1;
  const bool vis = a->vis_col != 0;
  using Kernel = void (*)(const Params);
  static const Kernel forms[12] = {
      fused_scan_kernel<false, false, false, false>,
      fused_scan_kernel<false, true, false, false>,
      fused_scan_kernel<true, false, false, false>,
      fused_scan_kernel<true, true, false, false>,
      fused_scan_kernel<false, false, true, false>,
      fused_scan_kernel<false, true, true, false>,
      fused_scan_kernel<true, false, true, false>,
      fused_scan_kernel<true, true, true, false>,
      fused_scan_kernel<false, false, false, true>,
      fused_scan_kernel<false, true, false, true>,
      fused_scan_kernel<false, false, true, true>,
      fused_scan_kernel<false, true, true, true>};
  const Kernel kernel =
      env ? forms[8 | (vis ? 1 : 0) | (a->runs ? 2 : 0)]
          : forms[(vis ? 1 : 0) | (a->points ? 0 : 2) | (a->runs ? 4 : 0)];
  cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(kernel), smem, (int)a->device,
      (a->slots * a->bsz + CHUNK - 1) / CHUNK, grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
