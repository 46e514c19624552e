// group_by_broker: a stable counting sort of rows by segment id, in one
// cooperative launch.
//
// Replaces (cruise_control_tpu/analyzer/engine.py): the count / start /
// order of `_plan_build` (:1597) — `segment_sum(ones, seg)`, the exclusive
// cumsum of the counts and `jnp.argsort(seg)` (stable) — and the sort that
// PyTorch's `index_put_(accumulate=True)` runs inside the aggregates.
// Input: the segment of each row, either given (seg i32[N], each in
// [0, nbins); an id outside that range counts as the last bin's) or
// computed from a placement (valid[i] && 0 <= broker[i] < nbins - 1 ?
// broker[i] : nbins - 1).  The last bin is the padding sentinel.  Output:
// count and start of every bin but the sentinel, and order i32[N], the row
// ids bin by bin, each bin's rows in row order: exactly
// torch.argsort(seg, stable=True).
//
// What bounds it on this card: latency.  N = 500k rows are read twice and
// written once (~4.5 MB: about a microsecond of HBM time); what costs is
// the chain of dependent passes, the shared-memory work on W bin tables
// per block, and the 500k scattered 4-byte stores of the order.  The first
// design took four launches: a histogram, a prefix per bin in which one
// thread walked its bin's column over all 245 chunks (a serial chain of L2
// round trips), a one-block scan of the bins, and a scatter of one warp
// per chunk.  This one is a single launch of at most as many blocks as are
// resident at once (W warps each, W = 16 while W + 1 bin tables fit shared
// memory), each warp owning a contiguous run of `rows_per_warp` rows, with
// grid.sync() between passes; every load of a pass is issued in batches,
// so a pass waits on memory about once, not once a tile:
//  1. each warp loads its rows' segments (8 tiles of 32 at once; at the
//     north star that is all of them, kept in registers for the scatter)
//     and counts them per bin into its own shared-memory table (shared
//     integer atomics: a count needs no order);
//     the block turns its W tables into exclusive prefixes over its warps
//     and writes its totals bin-major, hist[bin][block];
//  2. one warp per bin (grid-stride) scans the bin's contiguous column of
//     block totals with all lanes (8 a lane, a warp scan) into exclusive
//     offsets, and writes the bin's total into count;
//  3. every block scans the bin totals itself (each thread a contiguous
//     run of bins, one block scan), so no third barrier is needed; block 0
//     writes start.  A warp's cursor in a bin is the bin's start + the
//     block's offset + the earlier warps' rows, and the warp scatters its
//     rows in order, 32 at a time, ranked by __match_any_sync: a row lands
//     after every earlier row of its bin, stable by construction.
// Shared-memory loops over the W tables load all W entries of a bin before
// storing (otherwise each load waits for the previous store).  No float,
// no global atomic; the only scratch is hist, bins x blocks.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxWarps = 16;
// shared memory the per-warp tables and base may take (below the card's 227 KB)
constexpr int kSmemMax = 200 * 1024;
// column entries a lane scans at once in pass 2, bins a thread reads at
// once in pass 3, and tiles of 32 rows whose ids a warp loads at once
constexpr int kPer = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct GroupArgs {
  const int* seg;     // [n] segment ids, or null: from broker / valid
  const int* broker;  // [n]
  const bool* valid;  // [n]
  int* hist;          // [nbins * gridDim.x] scratch, bin-major
  int* count;         // [nbins - 1]
  int* start;         // [nbins - 1]
  int* order;         // [n]
  int n, nbins, rows_per_warp;
};

__device__ __forceinline__ int seg_at(const GroupArgs& a, int i) {
  const int top = a.nbins - 1;
  if (a.seg != nullptr) {
    const int s = a.seg[i];
    return (unsigned)s < (unsigned)a.nbins ? s : top;
  }
  const int b = a.broker[i];
  return (a.valid[i] && (unsigned)b < (unsigned)top) ? b : top;
}

// The segments of rows t0 + 32 k + lane, k < kPer (loads issued together);
// rows at or past hi take distinct negative ids, so they match nobody.
__device__ __forceinline__ void load_ids(const GroupArgs& a, int t0, int hi, int lane, int (&ids)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = t0 + 32 * k + lane;
    ids[k] = i < hi ? seg_at(a, i) : -1 - lane;
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// The totals (0 for the sentinel) and this block's offsets of bins
// s .. s + kPer - 1 below s_hi (loads issued together).
__device__ __forceinline__ void load_bins(const GroupArgs& a, int s, int s_hi, int G, int blk,
                                          int (&c)[kPer], int (&o)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool in = s + k < s_hi;
    c[k] = in && s + k < a.nbins - 1 ? __ldcg(a.count + s + k) : 0;
    o[k] = in ? __ldcg(a.hist + (size_t)(s + k) * G + blk) : 0;
  }
}

// Exclusive prefix of v over the block's threads (wsum: 32 ints of shared).
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int inc = warp_inclusive_scan(v, lane);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int x = warp_inclusive_scan(lane < nw ? wsum[lane] : 0, lane);
    wsum[lane] = x;
  }
  __syncthreads();
  return (warp > 0 ? wsum[warp - 1] : 0) + inc - v;
}

__global__ void group_by_broker_kernel(GroupArgs a) {
  extern __shared__ __align__(16) int tables[];  // [W][nbins], one table a warp, then base[nbins]
  __shared__ int wsum[32];
  cg::grid_group grid = cg::this_grid();
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = a.nbins, G = gridDim.x, blk = blockIdx.x;
  const unsigned lower = (1u << lane) - 1u;
  int* mine = tables + warp * nb;
  int* base = tables + W * nb;  // a bin's start + this block's offset in it
  const long long first = ((long long)blk * W + warp) * a.rows_per_warp;
  const int lo = (int)(first < a.n ? first : a.n);
  const int hi = (int)(first + a.rows_per_warp < a.n ? first + a.rows_per_warp : a.n);

  // pass 1: the warp's rows counted per bin, their ids loaded kPer tiles
  // at a time; the first batch stays in registers for the scatter
  const int nz = W * nb;  // cleared 16 bytes at a time, then the tail
  for (int j = threadIdx.x; j < nz / 4; j += blockDim.x) reinterpret_cast<int4*>(tables)[j] = make_int4(0, 0, 0, 0);
  for (int j = nz / 4 * 4 + threadIdx.x; j < nz; j += blockDim.x) tables[j] = 0;
  __syncthreads();
  int first_ids[kPer];
  load_ids(a, lo, hi, lane, first_ids);
  for (int t0 = lo; t0 < hi; t0 += 32 * kPer) {
    int ids[kPer];
    if (t0 == lo) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) ids[k] = first_ids[k];
    } else {
      load_ids(a, t0, hi, lane, ids);
    }
    // a count needs no order: shared atomics
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (ids[k] >= 0) atomicAdd(&mine[ids[k]], 1);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < nb; s += blockDim.x) {
    int v[kMaxWarps];
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) v[w] = w < W ? tables[w * nb + s] : 0;
    int run = 0;
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {
      if (w < W) tables[w * nb + s] = run;
      run += v[w];
    }
    a.hist[(size_t)s * G + blk] = run;
  }
  grid.sync();

  // pass 2: each bin's column of block totals -> exclusive offsets
  for (int s = blk * W + warp; s < nb; s += G * W) {
    int* col = a.hist + (size_t)s * G;
    int carry = 0;
    for (int b0 = 0; b0 < G; b0 += 32 * kPer) {
      const int j0 = b0 + lane * kPer;  // the lane's kPer consecutive entries
      int v[kPer];
      int sum = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = j0 + k < G ? __ldcg(col + j0 + k) : 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) sum += v[k];
      const int inc = warp_inclusive_scan(sum, lane);
      int run = carry + inc - sum;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (j0 + k < G) col[j0 + k] = run;
        run += v[k];
      }
      carry += __shfl_sync(kFull, inc, 31);
    }
    if (lane == 0 && s < nb - 1) a.count[s] = carry;
  }
  grid.sync();

  // pass 3: the bins' starts, scanned by every block, plus the block's
  // offsets into base; a warp's cursor in bin s is base[s] + its table's
  // (a thread takes a contiguous run of bins, kPer at a time; its first
  // kPer counts and offsets stay in registers across the block scan)
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int s_lo = min((int)threadIdx.x * per, nb), s_hi = min(s_lo + per, nb);
  int c0[kPer], o0[kPer];
  load_bins(a, s_lo, s_hi, G, blk, c0, o0);
  int tsum = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) tsum += c0[k];
  for (int s = s_lo + kPer; s < s_hi; s += kPer) {
    int c[kPer], o[kPer];
    load_bins(a, s, s_hi, G, blk, c, o);
#pragma unroll
    for (int k = 0; k < kPer; ++k) tsum += c[k];
  }
  int run = block_exclusive_scan(tsum, wsum);
  for (int s = s_lo; s < s_hi; s += kPer) {
    int c[kPer], o[kPer];
    if (s == s_lo) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) c[k] = c0[k], o[k] = o0[k];
    } else {
      load_bins(a, s, s_hi, G, blk, c, o);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (s + k < s_hi) {
        base[s + k] = run + o[k];
        if (blk == 0 && s + k < nb - 1) a.start[s + k] = run;
        run += c[k];
      }
    }
  }
  __syncthreads();

  // the scatter, over the same batches (the first from registers)
  for (int t0 = lo; t0 < hi; t0 += 32 * kPer) {
    int ids[kPer];
    if (t0 == lo) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) ids[k] = first_ids[k];
    } else {
      load_ids(a, t0, hi, lane, ids);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = ids[k];
      const unsigned peers = __match_any_sync(kFull, s);
      const int at = s >= 0 ? base[s] + mine[s] + __popc(peers & lower) : 0;
      __syncwarp();
      if (s >= 0) {
        a.order[at] = t0 + 32 * k + lane;
        // the bin's highest lane moves the bin's cursor past this tile
        if ((peers >> lane) == 1u) mine[s] += __popc(peers);
      }
      __syncwarp();
    }
  }
}

// The launch geometry for n rows and nbins bins on the current device:
// out[0] blocks (all resident at once), out[1] warps a block, out[2] rows a
// warp (a multiple of 32).  Raises the kernel's shared-memory cap once.
CC_EXPORT int cc_group_geometry(int n, int nbins, int* out) {
  if (nbins < 1 || n < 0 || 8LL * nbins > kSmemMax) return (int)cudaErrorInvalidValue;
  int W = kSmemMax / (4 * nbins) - 1;
  W = W > kMaxWarps ? kMaxWarps : W;
  const size_t smem = sizeof(int) * (size_t)(W + 1) * nbins;
  cudaError_t e = cudaFuncSetAttribute(group_by_broker_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_by_broker_kernel, 32 * W, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long warps = (long long)n_sm * per_sm * W;
  long long rpw = (n + warps - 1) / warps;
  rpw = rpw < 32 ? 32 : (rpw + 31) / 32 * 32;
  long long blocks = (n + W * rpw - 1) / (W * rpw);
  out[0] = (int)(blocks < 1 ? 1 : blocks);
  out[1] = W;
  out[2] = (int)rpw;
  return 0;
}

// One cooperative launch of `blocks` x `warps` warps (cc_group_geometry's).
CC_EXPORT int cc_group_by_broker(GroupArgs a, int blocks, int warps, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(32u * (unsigned)warps);
  cfg.dynamicSmemBytes = sizeof(int) * (size_t)(warps + 1) * a.nbins;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, group_by_broker_kernel, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
