// Merge-scatter of a sorted delta run into the resident sorted run, for
// Hopper (sm_90a): the device half of the LSM merge build.
//
// Replaces the reference's `_build_merge_scatter`, an XLA program
// (geomesa_tpu/index/device.py:241, called by DeviceTable.merge_scatter,
// :160-238). Given the resident columns `old` (n_old rows, index-sorted),
// the delta columns `delta` (n_delta rows, sorted among themselves) and
// `r[j]`, the number of resident keys <= delta key j (non-decreasing, in
// [0, n_old]; residents win ties), every column of the merged table is
//
//     out[i + #{j : r[j] <= i}] = old[i]      for each resident row i
//     out[r[j] + j]             = delta[j]    for each delta row j
//
// One launch moves every column of one merge (the device columns and the
// permutation, which merges as one more 8-byte column): a small device
// array of column descriptors (old, delta, out, element bytes 1/2/4/8).
//
// What bounds it on the card: bytes. It is pure data movement: each
// column's n_old + n_delta elements read once and n_old + n_delta written
// once, plus r; no arithmetic to speak of.
//
// Design (a simple first version): blocks [0, res_tiles) take TILE
// resident rows each, the rest TILE delta rows each.
//  - A resident tile [t0, t1) finds the slice r[a, b) of delta ranks that
//    fall inside it with two warp-wide 32-ary searches (one warp each, 5
//    dependent loads on a 2M-row delta instead of 21), and stages the slice
//    in shared memory when it fits (2,048 ranks; a longer run of equal
//    ranks is searched in global memory instead). Each row's shift is a +
//    its upper bound within the slice, found once and kept in registers
//    for all columns. Reads of `old` are coalesced; writes form runs broken
//    only where delta rows land.
//  - A delta tile writes out[r[j] + j] = delta[j] for its rows: reads of
//    r and `delta` are coalesced, writes runs of equal rank are
//    contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 8;                    // rows a thread, per tile
constexpr int TILE = THREADS * ROWS;       // 2,048 rows a block
constexpr int SLICE_CAP = 2048;            // ranks staged in shared memory
constexpr int MAX_COLS = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Col {
  const char* old;
  const char* delta;
  char* out;
  long long bytes;
};

// First j in [0, n) with r[j] >= v (n when none), r non-decreasing; the
// whole warp calls it and gets the same answer. Invariant: every j < lo
// has r[j] < v, every j >= hi has r[j] >= v.
__device__ long long warp_lower_bound(const int* __restrict__ r, long long n,
                                      long long v) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long probe = lo + (lane + 1) * step - 1;
    const bool less = probe < hi && (long long)r[probe] < v;
    const int k = __popc(__ballot_sync(FULL, less));
    const long long nhi = lo + (long long)(k + 1) * step - 1;
    lo += (long long)k * step;
    hi = nhi < hi ? nhi : hi;
  }
  const long long probe = lo + lane;
  const bool less = probe < hi && (long long)r[probe] < v;
  return lo + __popc(__ballot_sync(FULL, less));
}

// Count of s[0, len) <= v, s non-decreasing.
template <typename P>
__device__ __forceinline__ long long upper_bound(P s, long long len,
                                                 long long v) {
  long long lo = 0, hi = len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)s[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ void move_rows(const T* __restrict__ src,
                                          T* __restrict__ dst,
                                          const long long (&from)[ROWS],
                                          const long long (&to)[ROWS]) {
  T v[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
    if (from[k] >= 0) v[k] = src[from[k]];
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
    if (from[k] >= 0) dst[to[k]] = v[k];
}

__device__ __forceinline__ void move_all(const Col* cols, int ncols,
                                         bool resident,
                                         const long long (&from)[ROWS],
                                         const long long (&to)[ROWS]) {
  for (int c = 0; c < ncols; ++c) {
    const char* src = resident ? cols[c].old : cols[c].delta;
    switch (cols[c].bytes) {
      case 8:
        move_rows(reinterpret_cast<const uint64_t*>(src),
                  reinterpret_cast<uint64_t*>(cols[c].out), from, to);
        break;
      case 4:
        move_rows(reinterpret_cast<const uint32_t*>(src),
                  reinterpret_cast<uint32_t*>(cols[c].out), from, to);
        break;
      case 2:
        move_rows(reinterpret_cast<const uint16_t*>(src),
                  reinterpret_cast<uint16_t*>(cols[c].out), from, to);
        break;
      default:
        move_rows(reinterpret_cast<const uint8_t*>(src),
                  reinterpret_cast<uint8_t*>(cols[c].out), from, to);
        break;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
merge_scatter_kernel(const long long* __restrict__ desc, int ncols,
                     const int* __restrict__ r, long long n_old,
                     long long n_delta, long long res_tiles) {
  __shared__ Col cols[MAX_COLS];
  __shared__ int slice[SLICE_CAP];
  __shared__ long long bounds[2];
  const int tid = threadIdx.x;
  if (tid < ncols) {
    cols[tid].old = reinterpret_cast<const char*>(desc[4 * tid]);
    cols[tid].delta = reinterpret_cast<const char*>(desc[4 * tid + 1]);
    cols[tid].out = reinterpret_cast<char*>(desc[4 * tid + 2]);
    cols[tid].bytes = desc[4 * tid + 3];
  }
  long long from[ROWS], to[ROWS] = {};
  if (blockIdx.x < res_tiles) {
    const long long t0 = (long long)blockIdx.x * TILE;
    const long long t1 = t0 + TILE < n_old ? t0 + TILE : n_old;
    const int warp = tid >> 5;
    if (warp < 2) {
      const long long b = warp_lower_bound(r, n_delta, warp == 0 ? t0 : t1);
      if ((tid & 31) == 0) bounds[warp] = b;
    }
    __syncthreads();
    const long long a = bounds[0];
    const long long len = bounds[1] - a;
    const bool staged = len <= SLICE_CAP;
    if (staged)
      for (long long k = tid; k < len; k += THREADS) slice[k] = r[a + k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const long long i = t0 + (long long)k * THREADS + tid;
      from[k] = i < t1 ? i : -1;
      if (i < t1)
        to[k] = i + a + (staged ? upper_bound(slice, len, i)
                                : upper_bound(r + a, len, i));
    }
    move_all(cols, ncols, true, from, to);
  } else {
    __syncthreads();
    const long long j0 = (long long)(blockIdx.x - res_tiles) * TILE;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const long long j = j0 + (long long)k * THREADS + tid;
      from[k] = j < n_delta ? j : -1;
      if (j < n_delta) to[k] = (long long)r[j] + j;
    }
    move_all(cols, ncols, false, from, to);
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns the launch's
// cudaError_t (0 on success); the caller raises on non-zero. `desc` is a
// device array of ncols x {old, delta, out, element bytes} (pointers as
// 64-bit integers); `r` holds n_delta int32 ranks.
extern "C" int merge_scatter_launch(const long long* desc, int ncols,
                                    const int* r, long long n_old,
                                    long long n_delta, void* stream) {
  if (ncols < 0 || ncols > MAX_COLS) return (int)cudaErrorInvalidValue;
  if (ncols == 0 || n_old + n_delta == 0) return 0;
  const long long res_tiles = (n_old + TILE - 1) / TILE;
  const long long del_tiles = (n_delta + TILE - 1) / TILE;
  const long long grid = res_tiles + del_tiles;
  if (grid > 0x7fffffffll) return (int)cudaErrorInvalidConfiguration;
  merge_scatter_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      desc, ncols, r, n_old, n_delta, res_tiles);
  return (int)cudaGetLastError();
}

extern "C" int merge_scatter_tile() { return TILE; }

extern "C" int merge_scatter_max_cols() { return MAX_COLS; }

extern "C" const char* merge_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
