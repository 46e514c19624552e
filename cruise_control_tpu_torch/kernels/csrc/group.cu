// group_by_broker: a stable counting sort of rows by segment id.
//
// Replaces (cruise_control_tpu/analyzer/engine.py): the count / start /
// order of `_plan_build` (:1597) — `segment_sum(ones, seg)`, the exclusive
// cumsum of the counts and `jnp.argsort(seg)` (stable) — and the sort that
// PyTorch's `index_put_(accumulate=True)` runs inside the aggregates.
// Input: seg i32[N], each in [0, nbins) with nbins = n_seg + 1 (the last
// bin is the padding sentinel).  Output: the per-bin start of every bin
// (nbins), and order i32[N], the row ids bin by bin, each bin's rows in
// row order: exactly torch.argsort(seg, stable=True).
//
// What bounds it on this card: bytes, and the passes' launches.  N = 500k
// rows are read twice (8 B a row) and written once, a few MB: a couple of
// microseconds of HBM time.  Design, four passes, no sort and no float:
//  1. group_hist_kernel: one block per chunk of kChunk rows builds the
//     chunk's histogram in shared memory (integer atomics: the counts do
//     not depend on order) and writes it out as a row of hist[chunk][bin].
//  2. group_colscan_kernel: one thread per bin turns its column into the
//     exclusive prefix over chunks (where the chunk's rows of the bin
//     start inside the bin) and writes the bin's total.
//  3. group_scan_kernel: one block, the exclusive prefix over bins of the
//     totals: each bin's start.
//  4. group_scatter_kernel: one warp per chunk walks its rows in order,
//     32 at a time; the lanes holding one bin find each other with
//     __match_any_sync, and a lane's rank among the lower lanes of its bin
//     is its place after the bin's earlier rows: stable by construction.
#include "common.cuh"

constexpr int kChunk = 2048;

__global__ void group_hist_kernel(const int* __restrict__ seg, int n, int nbins, int* __restrict__ hist) {
  extern __shared__ int h[];
  for (int j = threadIdx.x; j < nbins; j += blockDim.x) h[j] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kChunk;
  const long long end = base + kChunk < n ? base + kChunk : n;
  for (long long i = base + threadIdx.x; i < end; i += blockDim.x) atomicAdd(&h[seg[i]], 1);
  __syncthreads();
  int* row = hist + (size_t)blockIdx.x * nbins;
  for (int j = threadIdx.x; j < nbins; j += blockDim.x) row[j] = h[j];
}

__global__ void group_colscan_kernel(int* __restrict__ hist, int nchunks, int nbins, int* __restrict__ total) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nbins) return;
  int run = 0;
  for (int c = 0; c < nchunks; ++c) {
    int* p = hist + (size_t)c * nbins + s;
    const int v = *p;
    *p = run;
    run += v;
  }
  total[s] = run;
}

constexpr int kScanThreads = 1024;

// One block: exclusive prefix over nbins totals, kScanThreads at a time.
__global__ void group_scan_kernel(const int* __restrict__ total, int nbins, int* __restrict__ start) {
  __shared__ int buf[kScanThreads];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nbins; base += kScanThreads) {
    const int j = base + threadIdx.x;
    const int v = j < nbins ? total[j] : 0;
    buf[threadIdx.x] = v;
    __syncthreads();
    for (int off = 1; off < kScanThreads; off <<= 1) {
      const int add = threadIdx.x >= off ? buf[threadIdx.x - off] : 0;
      __syncthreads();
      buf[threadIdx.x] += add;
      __syncthreads();
    }
    if (j < nbins) start[j] = carry + buf[threadIdx.x] - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry += buf[threadIdx.x];
    __syncthreads();
  }
}

__global__ void group_scatter_kernel(const int* __restrict__ seg, int n, int nbins,
                                     const int* __restrict__ hist, const int* __restrict__ start,
                                     int* __restrict__ order) {
  extern __shared__ int off[];
  const int lane = threadIdx.x;
  const int* row = hist + (size_t)blockIdx.x * nbins;
  for (int j = lane; j < nbins; j += 32) off[j] = start[j] + row[j];
  __syncwarp();
  const long long base = (long long)blockIdx.x * kChunk;
  const long long end = base + kChunk < n ? base + kChunk : n;
  const unsigned lower = (1u << lane) - 1u;
  for (long long t = base; t < end; t += 32) {
    const long long i = t + lane;
    const bool act = i < end;
    // idle lanes take distinct negative ids, so they match nobody
    const int s = act ? seg[i] : -1 - lane;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, s);
    const int at = act ? off[s] + __popc(peers & lower) : 0;
    __syncwarp();
    if (act) {
      order[at] = (int)i;
      // the bin's highest lane moves the bin's cursor past this tile
      if ((peers >> lane) == 1u) off[s] += __popc(peers);
    }
    __syncwarp();
  }
}

// hist: scratch i32[nchunks * nbins]; total: scratch i32[nbins];
// start: out i32[nbins]; order: out i32[n].
CC_EXPORT int cc_group_by_broker(const void* seg, int n, int nbins, void* hist, void* total,
                                 void* start, void* order, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nchunks = (int)cc_blocks(n, kChunk);
  const size_t smem = sizeof(int) * (size_t)nbins;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(group_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(group_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (nchunks > 0) {
    group_hist_kernel<<<nchunks, 256, smem, st>>>((const int*)seg, n, nbins, (int*)hist);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  group_colscan_kernel<<<cc_blocks(nbins, 256), 256, 0, st>>>((int*)hist, nchunks, nbins, (int*)total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  group_scan_kernel<<<1, kScanThreads, 0, st>>>((const int*)total, nbins, (int*)start);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (nchunks > 0) {
    group_scatter_kernel<<<nchunks, 32, smem, st>>>((const int*)seg, n, nbins, (const int*)hist,
                                                    (const int*)start, (int*)order);
  }
  return (int)cudaGetLastError();
}
