// Ordered compaction by decoupled look-back for Hopper (sm_90a): the
// look-back, workspace and end (finish) of ordered_compact.cu, and the end
// fused_scan.cu takes for its count.
//
// Replaces the fixed-size jnp.nonzero(size=..., fill_value=...) of the
// reference's fused programs (geomesa_tpu/index/compiled.py:532, :541,
// :555, :559, :571, :574) and of its staged selects: the flagged
// candidates' rows in candidate order, the first `cap` of them, padded with
// a fill value, and the count of every flagged candidate, in one launch with
// no host sync.
//
// The look-back (look_back). A CTA takes units of candidates by an atomic
// ticket, so units start in candidate order, and ranks a unit's flagged
// candidates itself. The unit publishes its count in a status word of its
// own, warp 0 sums its predecessors' words from the nearest back until one
// holds an inclusive prefix (32 a step), and the unit publishes its
// inclusive prefix; its rows go to the output at the exclusive prefix plus
// their rank. A unit whose exclusive prefix reaches `cap` stops looking
// back: the prefix it publishes is a lower bound that is itself at least
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
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long PREFIX = 1ull << 31;
constexpr unsigned long long VALUE_MAX = 0x7fffffffull;
constexpr int MAX_DEVICES = 64;

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
