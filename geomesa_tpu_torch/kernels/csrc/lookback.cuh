// Ordered compaction by decoupled look-back for Hopper (sm_90a): the
// ordered pass of block_gate.cu; ordered_compact.cu takes its look-back,
// workspace and end (finish), and fused_scan.cu its end for the count.
//
// Replaces the fixed-size jnp.nonzero(size=..., fill_value=...) of the
// reference's fused programs (geomesa_tpu/index/compiled.py:496, :532,
// :541, :555, :559, :571, :574) and of its staged selects: the flagged
// candidates' rows in candidate order, the first `cap` of them, padded with
// a fill value, and the count of every flagged candidate, in one launch with
// no host sync.
//
// The pass (ordered_pass) over candidates 0 .. n - 1, a unit of TILE
// candidates at a time. A CTA takes units by an atomic ticket, so units
// start in candidate order; a thread holds ITEMS = 16 candidates of the
// unit (4,096 candidates a unit: the per-unit ticket, barriers and
// look-back amortise over them), strided by the CTA width, so a warp's
// loads coalesce. The unit's flagged candidates rank by a CTA-wide ballot
// scan: a ballot a (item, warp), and warp 0's exclusive scan of their 128
// counts. The unit publishes its count in a status word of its own, warp 0
// sums its predecessors' words from the nearest back until one holds an
// inclusive prefix (32 a step), and the unit publishes its inclusive
// prefix; its rows go straight from registers to the output at the
// exclusive prefix plus their rank. A unit
// whose exclusive prefix reaches `cap` stops looking back and writes
// nothing: the prefix it publishes is a lower bound that is itself at least
// `cap`. A status word is epoch (32 bits) | prefix flag | value (31 bits);
// the wrapper passes a new epoch each call, so a word of an earlier call
// reads as unpublished and the workspace needs no memset between calls.
//
// The end (finish). Each CTA adds its flagged count to a workspace total
// with one atomic; the last CTA to finish reads the total, writes the
// count, pads the output, and zeroes the ticket, the done counter and the
// total for the next call. A kernel allocates nothing and never waits on
// the host.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace lookback {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                // candidates a thread a unit
constexpr int TILE = THREADS * ITEMS;    // candidates a unit
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long PREFIX = 1ull << 31;
constexpr unsigned long long VALUE_MAX = 0x7fffffffull;
constexpr int MAX_DEVICES = 64;
// warp 0 scans the (item, warp) counts, four a lane
static_assert(ITEMS * WARPS == 4 * 32, "the rank scan takes 4 counts a lane");

// a stream's workspace: 4 words (word 2 is seg_band's, word 3
// ordered_compact.cu's full word), then one status word a unit
struct Ws {
  unsigned* ticket;             // units handed out
  unsigned* done;               // CTAs finished
  unsigned long long* total;    // flagged candidates
  unsigned long long* status;
  unsigned epoch;
};

inline Ws make_ws(long long base, unsigned epoch) {
  unsigned long long* w = reinterpret_cast<unsigned long long*>(base);
  Ws s;
  s.ticket = reinterpret_cast<unsigned*>(w);
  s.done = s.ticket + 1;
  s.total = w + 1;
  s.status = w + 4;
  s.epoch = epoch;
  return s;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Warp 0 of the CTA that holds unit u with `agg` flagged candidates:
// publishes the aggregate, sums the predecessors back to the nearest
// inclusive prefix (stopping once the sum reaches cap), publishes the
// inclusive prefix and returns the exclusive one (on every lane).
__device__ __forceinline__ long long look_back(const Ws& w, long long u,
                                               int agg, long long cap,
                                               int lane) {
  const unsigned long long tag = (unsigned long long)w.epoch << 32;
  if (lane == 0)
    store_status(w.status + u, tag | (u == 0 ? PREFIX : 0ull) | (unsigned)agg);
  long long excl = 0;
  long long j0 = u - 1;
  while (j0 >= 0 && excl < cap) {
    const long long j = j0 - lane;
    const unsigned long long st =
        j >= 0 ? load_status(w.status + j) : (tag | PREFIX);
    const bool ok = (unsigned)(st >> 32) == w.epoch;
    const unsigned okm = __ballot_sync(FULL, ok);
    const unsigned prem = __ballot_sync(FULL, ok && (st & PREFIX));
    const int first = prem ? __ffs(prem) - 1 : 31;
    const unsigned need = first == 31 ? FULL : (2u << first) - 1u;
    if ((okm & need) != need) {   // a predecessor has not published
      __nanosleep(20);
      continue;
    }
    long long val = lane <= first ? (long long)(st & VALUE_MAX) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) val += __shfl_xor_sync(FULL, val, d);
    excl += val;
    if (prem) break;
    j0 -= 32;
  }
  if (lane == 0 && u > 0) {
    const long long incl = excl + agg;
    store_status(w.status + u,
                 tag | PREFIX
                     | (unsigned long long)(incl < (long long)VALUE_MAX
                                                ? incl : VALUE_MAX));
  }
  return excl;
}

// The ordered pass over candidates 0 .. n - 1: flag(i) says whether
// candidate i is flagged; emit(rank, i) writes the flagged ones of rank
// below cap. Returns the CTA's flagged count (on thread 0).
template <class Flag, class Emit>
__device__ __forceinline__ unsigned long long ordered_pass(long long n,
                                                           const Ws& w,
                                                           long long cap,
                                                           Flag flag,
                                                           Emit emit) {
  __shared__ int s_cnt[ITEMS][WARPS];   // flagged a (item, warp)
  __shared__ int s_off[ITEMS][WARPS];   // their exclusive prefix in the unit
  __shared__ long long s_unit, s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long units = (n + TILE - 1) / TILE;
  unsigned long long cta = 0;
  for (;;) {
    if (threadIdx.x == 0) s_unit = (long long)atomicAdd(w.ticket, 1u);
    __syncthreads();   // also: the previous unit's reads of s_off, s_excl
    const long long u = s_unit;
    if (u >= units) break;   // uniform over the CTA
    const long long first = u * TILE;
    unsigned bm[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = first + k * THREADS + threadIdx.x;
      bm[k] = __ballot_sync(FULL, i < n && flag(i));
      if (lane == 0) s_cnt[k][warp] = __popc(bm[k]);
    }
    __syncthreads();
    if (warp == 0) {
      // the (item, warp) counts in candidate order, four a lane: an
      // exclusive scan gives each its offset in the unit
      const int* cnt = &s_cnt[0][0];
      int* off = &s_off[0][0];
      int v[4], sum = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = cnt[4 * lane + j];
        sum += v[j];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
      }
      int run = incl - sum;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        off[4 * lane + j] = run;
        run += v[j];
      }
      const int agg = __shfl_sync(FULL, incl, 31);
      const long long excl = look_back(w, u, agg, cap, lane);
      if (lane == 0) {
        s_excl = excl;
        cta += (unsigned)agg;
      }
    }
    __syncthreads();
    const long long excl = s_excl;
    if (excl < cap) {   // uniform over the CTA
      const unsigned lower = (1u << lane) - 1u;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if ((bm[k] >> lane) & 1u) {
          const long long at = excl + s_off[k][warp] + __popc(bm[k] & lower);
          if (at < cap) emit(at, first + k * THREADS + threadIdx.x);
        }
      }
    }
  }
  return cta;
}

// Every CTA, at its end, with its flagged count `cta` on thread 0: the last
// CTA calls pad(total) on all its threads and zeroes the workspace's
// counters for the next call.
template <class Pad>
__device__ __forceinline__ void finish(const Ws& w, unsigned long long cta,
                                       Pad pad) {
  __shared__ bool s_last;
  __shared__ unsigned long long s_tot;
  if (threadIdx.x == 0) {
    if (cta) atomicAdd(w.total, cta);
    __threadfence();
    const bool last = atomicAdd(w.done, 1u) == gridDim.x - 1;
    s_last = last;
    if (last) {
      __threadfence();
      s_tot = atomicAdd(w.total, 0ull);
      *w.total = 0ull;
      *w.ticket = 0u;
      *w.done = 0u;
    }
  }
  __syncthreads();
  if (s_last) pad(s_tot);
}

// the int64 key of an fp62 (hi, lo) pair: signed 64-bit order is the
// reference's signed lexicographic _ge62/_le62 order (box_count.cu)
__device__ __forceinline__ long long pack62(int hi, int lo) {
  return (long long)(((unsigned long long)(unsigned)hi << 32)
                     | (unsigned)(lo ^ (int)0x80000000));
}

// A persistent grid for `kernel`: as many CTAs as fit on the device's SMs
// with `smem` dynamic shared memory, at most `want`, at least 1.
inline cudaError_t persistent_grid(const void* kernel, size_t smem, int dev,
                                   long long want, unsigned& grid) {
  static int sms[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err;
  if (sms[dev] == 0) {
    int v = 0;
    if ((err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    sms[dev] = v > 0 ? v : 1;
  }
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  int occ = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  long long g = (long long)sms[dev] * occ;
  if (g > want) g = want;
  if (g < 1) g = 1;
  grid = (unsigned)g;
  return cudaSuccess;
}

}  // namespace lookback
