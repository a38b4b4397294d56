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
// What bounds it on the card: per block 24 bytes of summaries in (16 with
// no bins) and 12 bytes of ids and starts out, and per (block, gate
// envelope) 4 f32 compares (per (block, window) 3 int compares). At the
// main path's 24,415 blocks that is under a megabyte, 0.0003 ms of HBM
// time: the kernel's time is latency — one round trip for the summaries,
// the ranks, one for the writes — and the launch.
//
// Design: one launch of one thread-block cluster, with no global atomic, no
// ticket, no look-back and no workspace.
// - The cluster's CLUSTER = 16 CTAs (a non-portable size) of THREADS = 512
//   threads, the fastest of 8 and 16 CTAs of 512 and 1,024 threads at the
//   main path's shapes (PERF.md §6), split the blocks: CTA rank r owns
//   the contiguous slice [r S, (r + 1) S), S = THREADS x items,
//   items = ceil(nb / (CLUSTER THREADS));
//   warp w of it the run [w 32 items, (w + 1) 32 items) of the slice, and
//   item k of lane l is block 32 k + l of the run, so a warp's loads
//   coalesce. Slice, warp and item order are block order.
// - A thread issues the summary loads of BATCH of its items before it
//   tests any (8 gave no gain: PERF.md §6); the first batch's loads go out
//   before the query's sections (branch table, gates, window bins) are
//   staged into shared memory.
// - Ranks in a CTA: one ballot a (warp, item), kept in shared memory; a
//   warp sums its ballots, and warp 0 scans the warps' sums.
// - Ranks across the cluster: after one cluster barrier, warp 0 of each CTA
//   reads every CTA's count from that CTA's shared memory (distributed
//   shared memory), which gives its exclusive offset and the total.
// - Out: each CTA writes its alive ids and starts at offset + rank, then
//   the pad entries of [total, nb) that fall in its own slice of output
//   positions, in 16-byte stores between a scalar head and tail; rank 0
//   writes the count.
// - End: a CTA arrives at a second cluster barrier once its reads of the
//   others' counts are done and waits on it last, so no CTA's shared
//   memory goes before every CTA has read it.
// - A cluster that does not fit (the occupancy calculator finds none, or
//   the masks and the query pass the shared memory) is an error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CLUSTER = 16;   // CTAs of the cluster (kernels/gate.py CLUSTER)
constexpr int THREADS = 512;  // threads a CTA (kernels/gate.py THREADS)
constexpr int BATCH = 4;      // items a thread with their loads in flight
constexpr int MAX_DEVICES = 64;
// the launcher's code when the cluster does not fit
constexpr int NO_CLUSTER = 100000;

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
  int items;           // blocks a thread
  long long nb, bsz, n;
  int* ids;
  long long* starts;
  int* count;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// out[lo, hi) = v by the CTA's threads: V-wide 16-byte stores vv between a
// scalar head and tail (out is 16-byte aligned)
template <int V, class T, class VT>
__device__ __forceinline__ void fill(T* out, long long lo, long long hi, T v,
                                     VT vv) {
  long long a = (lo + V - 1) / V * V, e = hi / V * V;
  if (a > e) a = e = hi;
  for (long long j = lo + threadIdx.x; j < a; j += THREADS) out[j] = v;
  for (long long j = e + threadIdx.x; j < hi; j += THREADS) out[j] = v;
  VT* o = reinterpret_cast<VT*>(out);
  for (long long j = a / V + threadIdx.x; j < e / V; j += THREADS) o[j] = vv;
}

__global__ void __launch_bounds__(THREADS)
block_gate_kernel(const __grid_constant__ Params p) {
  constexpr int WARPS = THREADS / 32;
  static_assert(WARPS <= 32, "warp 0 scans the warps' counts");
  static_assert(CLUSTER <= 32, "warp 0 reads one CTA's count a lane");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[WARPS];   // warps' alive counts, then their offsets
  __shared__ int s_count;         // the CTA's alive count, read by the cluster
  __shared__ int s_excl, s_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long slice = (long long)THREADS * p.items;
  // the block of this lane's item 0; item k is 32 k blocks on
  const long long first = rank * slice + (long long)warp * 32 * p.items
                          + lane;
  unsigned* s_mask = reinterpret_cast<unsigned*>(smem + 16 * p.qwords)
                     + warp * p.items;

  float x0[BATCH] = {}, x1[BATCH] = {}, y0[BATCH] = {}, y1[BATCH] = {};
  int t0[BATCH] = {}, t1[BATCH] = {};
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (k0 + j >= p.items) break;
      long long b = first + 32LL * (k0 + j);
      b = b < p.nb ? b : p.nb - 1;   // past the end: tested as not alive
      x0[j] = __ldg(p.bxmin + b);
      x1[j] = __ldg(p.bxmax + b);
      y0[j] = __ldg(p.bymin + b);
      y1[j] = __ldg(p.bymax + b);
      t0[j] = p.binmin ? __ldg(p.binmin + b) : 0;
      t1[j] = p.binmin ? __ldg(p.binmax + b) : 0;
    }
  };
  load(0);
  for (int i = threadIdx.x; i < p.qwords; i += THREADS)
    reinterpret_cast<int4*>(smem)[i] = __ldg(p.qbuf + i);
  __syncthreads();
  const int* br = reinterpret_cast<const int*>(smem + p.br);
  const float4* gate = reinterpret_cast<const float4*>(smem + p.gate);
  const int2* wbin = reinterpret_cast<const int2*>(smem + p.wbin);

  auto alive = [&](float ax0, float ax1, float ay0, float ay1, int at0,
                   int at1) -> bool {
    for (int k = 0; k < p.nbranch; ++k) {
      const int* r = br + 8 * k;
      bool a = false;
      for (int g = r[0], e = r[0] + r[1]; g < e && !a; ++g) {
        const float4 q = gate[g];
        a = (ax1 >= q.x) & (ax0 <= q.z) & (ay1 >= q.y) & (ay0 <= q.w);
      }
      if (a && r[3] > 0 && p.binmin) {
        bool in = false;
        for (int w = r[2], e = r[2] + r[3]; w < e && !in; ++w) {
          const int2 q = wbin[w];
          in = (q.x <= q.y) & (at0 <= q.y) & (at1 >= q.x);
        }
        a = in;
      }
      if (a) return true;
    }
    return false;
  };

  int wcount = 0;   // the warp's alive blocks (uniform over the warp)
  for (int k0 = 0; k0 < p.items; k0 += BATCH) {
    if (k0) load(k0);
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int k = k0 + j;
      const bool in = k < p.items && first + 32LL * k < p.nb;
      const unsigned m = __ballot_sync(
          FULL, in && alive(x0[j], x1[j], y0[j], y1[j], t0[j], t1[j]));
      if (lane == 0 && k < p.items) s_mask[k] = m;
      wcount += __popc(m);
    }
  }
  if (lane == 0) s_warp[warp] = wcount;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < WARPS ? s_warp[lane] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane < WARPS) s_warp[lane] = incl - v;
    if (lane == 31) s_count = incl;
  }
  cluster.sync();   // every CTA's count is in its shared memory
  if (warp == 0) {
    int c = lane < CLUSTER ? *cluster.map_shared_rank(&s_count, lane) : 0;
    int below = lane < rank ? c : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      c += __shfl_xor_sync(FULL, c, d);
      below += __shfl_xor_sync(FULL, below, d);
    }
    if (lane == 0) {
      s_excl = below;
      s_total = c;
    }
  }
  cluster_arrive();   // this CTA's reads of the others' counts are done
  __syncthreads();

  const int total = s_total;
  if (wcount) {
    const long long top = p.n > p.bsz ? p.n - p.bsz : 0;
    const unsigned lower = (1u << lane) - 1u;
    int at = s_excl + s_warp[warp];
    for (int k = 0; k < p.items; ++k) {
      const unsigned m = s_mask[k];
      if ((m >> lane) & 1u) {
        const long long b = first + 32LL * k;
        const int pos = at + __popc(m & lower);
        p.ids[pos] = (int)b;
        const long long s = b * p.bsz;
        p.starts[pos] = s < top ? s : top;
      }
      at += __popc(m);
    }
  }
  // the pad of this CTA's slice of output positions
  const long long lo = rank * slice > total ? rank * slice : total;
  const long long hi = (rank + 1) * slice < p.nb ? (rank + 1) * slice : p.nb;
  if (lo < hi) {
    fill<4>(p.ids, lo, hi, -1, make_int4(-1, -1, -1, -1));
    fill<2>(p.starts, lo, hi, 0LL, make_longlong2(0, 0));
  }
  if (rank == 0 && threadIdx.x == 0) *p.count = total;
  cluster_wait();
}

// The launch configuration of the one cluster (the grid)
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(size_t smem, cudaStream_t stream) : attr(), cfg() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;   // cfg points into attr
};

// per device: one past the largest dynamic shared memory the cluster was
// found to fit with (0: none yet)
std::atomic<size_t> g_fits[MAX_DEVICES];
std::mutex g_mu;

// Whether the cluster with `smem` bytes of dynamic shared memory fits on
// device `dev` (the current device): sets the kernel's attributes at its
// first call and asks the occupancy calculator, once a size.
cudaError_t fits(int dev, size_t smem, bool& ok) {
  std::atomic<size_t>& known = g_fits[dev];
  ok = smem < known.load(std::memory_order_acquire);
  if (ok) return cudaSuccess;
  std::lock_guard<std::mutex> hold(g_mu);
  const void* kernel = reinterpret_cast<const void*>(block_gate_kernel);
  cudaError_t err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return err;
  int optin = 0;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
      != cudaSuccess)
    return err;
  const size_t room = (size_t)optin - fa.sharedSizeBytes;
  if (smem > room) return cudaSuccess;   // ok stays false
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)room))
      != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
      != cudaSuccess)
    return err;
  const ClusterLaunch one(smem, nullptr);
  int n = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&n, kernel, &one.cfg))
      != cudaSuccess)
    return err;
  ok = n > 0;
  if (ok && smem + 1 > known.load(std::memory_order_relaxed))
    known.store(smem + 1, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

// The launch's arguments as the wrapper packs them (kernels/gate.py _ARGS):
// 8-byte slots, pointers 0 for none.
struct BlockGateArgs {
  long long bxmin, bxmax, bymin, bymax, binmin, binmax;
  long long qbuf, qbytes, br, gate, wbin, nbranch;
  long long nb, bsz, n;
  long long ids, starts, count;
  long long device;
};
static_assert(sizeof(BlockGateArgs) == 19 * 8,
              "BlockGateArgs must match _ARGS");

// Lists the alive blocks into ids/starts and their number into count, in
// one launch of one cluster of CLUSTER CTAs of THREADS threads on `stream`
// (on device a->device, the current device). ids and starts must be 16-byte
// aligned. Returns the first CUDA error, NO_CLUSTER when the cluster does
// not fit, 0 on success.
extern "C" int block_gate_launch(const BlockGateArgs* a, void* stream) {
  if (a->nb <= 0 || a->nb > 0x7fffffffLL || a->bsz <= 0 || a->qbytes % 16 ||
      a->ids % 16 || a->starts % 16 || a->device < 0 ||
      a->device >= MAX_DEVICES)
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
  constexpr long long PER = (long long)CLUSTER * THREADS;
  p.items = (int)((a->nb + PER - 1) / PER);
  p.nb = a->nb;
  p.bsz = a->bsz;
  p.n = a->n;
  p.ids = reinterpret_cast<int*>(a->ids);
  p.starts = reinterpret_cast<long long*>(a->starts);
  p.count = reinterpret_cast<int*>(a->count);
  const size_t smem = 16 * (size_t)p.qwords
                      + sizeof(unsigned) * (THREADS / 32) * (size_t)p.items;
  bool ok = false;
  cudaError_t err = fits((int)a->device, smem, ok);
  if (err != cudaSuccess) return (int)err;
  if (!ok) return NO_CLUSTER;
  const ClusterLaunch one(smem, (cudaStream_t)stream);
  if ((err = cudaLaunchKernelEx(&one.cfg, block_gate_kernel, p))
      != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* block_gate_error_string(int code) {
  if (code == NO_CLUSTER)
    return "no cluster of its CTAs, threads and shared memory fits on the "
           "device";
  return cudaGetErrorString((cudaError_t)code);
}
