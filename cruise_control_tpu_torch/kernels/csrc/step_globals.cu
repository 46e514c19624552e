// step_globals: the per-step frozen global scalars of the anneal, from the
// carry's broker aggregates, into the f32 vector the candidates kernel
// reads (kernels/step_globals.py LAYOUT) and the per-topic averages.
//
// Replaces (cruise_control_tpu/analyzer/engine.py): `_globals` (:1623), the
// masked sums over brokers (load, counts, leader bytes-in, disk load, the
// tiebreak's utilization sums) and over topic x broker, and the packing of
// them (move_delta.pack_globals).
//
// What bounds it on this card: latency.  It reads B broker rows (~45 B
// each) and the T x B topic counts (2.2 MB at the north star): ~0.7 us of
// HBM time.  The first design ran 14 blocks on the 132 SMs, each part a
// serial chain: block 0 alone summed every broker row (~5 rows a thread)
// and then ran a 9-level shared-memory tree over 14 arrays, and each topic
// row went to one warp (82 dependent 4-byte loads a lane at the north
// star, each with a 1-byte alive load).
//
// Design: one launch, in thread-block clusters of kCluster blocks.  The
// first cluster sums the broker rows: each of its kCluster x kThreads
// threads a fixed strided slice of brokers in order (two rows' loads in
// flight at once), then a fixed shuffle tree in each warp and a fixed
// pairwise tree over the warps; each block pushes its partials into block
// 0's shared memory (distributed shared memory), and after one cluster
// barrier block 0 adds them in a fixed pairwise tree.  So the vector is the
// same bits run after run, without float atomics, scratch memory or a
// second launch.  Every other block sums one topic row with 16-byte loads
// (four counts and their four alive bytes a load, when B is a multiple of
// 4) and a shuffle tree; integers, exact in any order.  What is left is
// fixed latency: the launch, one round trip of loads, the trees, the
// cluster barrier.  n_alive, a value of the model generation, is read from
// the engine's generation block with the block's first loads (not passed
// by value), so a captured round replays with the generation it runs on.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// offsets into the output vector (kernels/step_globals.py LAYOUT)
#define G_AVG_PCT 0
#define G_TOTAL_LOAD 4
#define G_PCT_SUM 8
#define G_PCT_SUMSQ 12
#define G_AVG_COUNT 16
#define G_TOTAL_COUNT 17
#define G_AVG_LCOUNT 18
#define G_TOTAL_LCOUNT 19
#define G_AVG_LBIN 20
#define G_TOTAL_LBIN 21
#define G_TOTAL_DISK 22
#define G_TOPIC_AVG 23

struct GlobalsIn {
  const bool* alive;         // [B]
  const float* broker_load;  // [B, 4]
  const float* capacity;     // [B, 4]
  const int* rcount;
  const int* lcount;
  const float* lbin;
  const int* topic_count;  // [T, B]
  const bool* disk_alive;  // [B, D]
  const float* disk_load;  // [B, D]
  const float* total_cap;  // [4]
  const GenParams* gen;    // the engine's generation block: n_alive
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kNF = 14;  // load[4], pct[4], pctsq[4], lbin, disk
constexpr int kNV = 16;  // the floats, then the replica and leader counts (as int bits)
constexpr unsigned int kFull = 0xFFFFFFFFu;

// v[0] + ... + v[n-1] in a fixed pairwise tree (n a power of two), in place
template <int N>
__device__ __forceinline__ float tree_sum(float* v) {
#pragma unroll
  for (int half = N / 2; half > 0; half >>= 1) {
#pragma unroll
    for (int i = 0; i < half; ++i) v[i] = __fadd_rn(v[i], v[i + half]);
  }
  return v[0];
}

// One broker's row: every load issued before anything tests it, so that
// they overlap; `disk` is the sum of its live disks' loads in disk order.
struct Row {
  bool alive = false;
  float4 load, cap;
  int rc, lc;
  float lbin, disk;
};

__device__ __forceinline__ Row load_row(const GlobalsIn& in, int b, int D) {
  Row r;
  r.alive = in.alive[b];
  r.load = reinterpret_cast<const float4*>(in.broker_load)[b];
  r.cap = reinterpret_cast<const float4*>(in.capacity)[b];
  r.rc = in.rcount[b];
  r.lc = in.lcount[b];
  r.lbin = in.lbin[b];
  r.disk = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float v = in.disk_load[(size_t)b * D + d];
    r.disk = in.disk_alive[(size_t)b * D + d] ? __fadd_rn(r.disk, v) : r.disk;
  }
  return r;
}

__device__ void topic_row(const GlobalsIn& in, int B, int t, bool vec, float* out,
                          int* warp_sum) {
  const float n_alive = threadIdx.x == 0 ? in.gen->n_alive : 0.0f;
  int sum = 0;
  const int* row = in.topic_count + (size_t)t * B;
  if (vec) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    const unsigned int* alive4 = reinterpret_cast<const unsigned int*>(in.alive);
    for (int j = threadIdx.x; j < B / 4; j += kThreads) {
      const int4 c = row4[j];
      const unsigned int a = alive4[j];  // four bools, one a byte
      sum += ((a & 0xFFu) ? c.x : 0) + ((a & 0xFF00u) ? c.y : 0) + ((a & 0xFF0000u) ? c.z : 0) +
             ((a & 0xFF000000u) ? c.w : 0);
    }
  } else {
    for (int b = threadIdx.x; b < B; b += kThreads) sum += in.alive[b] ? row[b] : 0;
  }
  sum = __reduce_add_sync(kFull, sum);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < kWarps ? warp_sum[threadIdx.x] : 0;
    v = __reduce_add_sync(kFull, v);
    if (threadIdx.x == 0) out[G_TOPIC_AVG + t] = __fdiv_rn((float)v, n_alive);
  }
}

__global__ void __launch_bounds__(kThreads) step_globals_kernel(GlobalsIn in, int B, int T, int D,
                                                                int vec, float* out) {
  __shared__ float warp_part[kNV][kWarps];
  __shared__ int warp_sum[kWarps];
  if (blockIdx.x >= kCluster) {  // a topic block (whole clusters of them)
    const int t = blockIdx.x - kCluster;
    if (t < T) topic_row(in, B, t, vec != 0, out, warp_sum);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float parts[kCluster][kNV];  // block 0's: every block's partials
  // every block of the cluster has started before one writes another's
  // shared memory: arrive now, wait just before the write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the epilogue's capacity totals, loaded now rather than at the end
  const float cap_total = blockIdx.x == 0 && threadIdx.x < 4 ? in.total_cap[threadIdx.x] : 0.0f;
  const float n_alive = blockIdx.x == 0 && threadIdx.x == 0 ? in.gen->n_alive : 0.0f;
  float f[kNF];
  for (int k = 0; k < kNF; ++k) f[k] = 0.0f;
  int cnt = 0, lcnt = 0;
  // brokers b, b + stride, b + 2 stride, ... in order, two rows loaded at once
  const int stride = kCluster * kThreads;
  for (int b = blockIdx.x * kThreads + threadIdx.x; b < B; b += 2 * stride) {
    const Row rows[2] = {load_row(in, b, D), b + stride < B ? load_row(in, b + stride, D) : Row{}};
    for (int j = 0; j < 2; ++j) {
      const Row& r = rows[j];
      if (!r.alive) continue;
      const float lv[4] = {r.load.x, r.load.y, r.load.z, r.load.w};
      const float cv[4] = {r.cap.x, r.cap.y, r.cap.z, r.cap.w};
      for (int k = 0; k < 4; ++k) {
        const float pct = __fdiv_rn(lv[k], __fadd_rn(cv[k], 1e-12f));
        f[k] = __fadd_rn(f[k], lv[k]);
        f[4 + k] = __fadd_rn(f[4 + k], pct);
        f[8 + k] = __fadd_rn(f[8 + k], __fmul_rn(pct, pct));
      }
      cnt += r.rc;
      lcnt += r.lc;
      f[12] = __fadd_rn(f[12], r.lbin);
      f[13] = __fadd_rn(f[13], r.disk);
    }
  }
  // a fixed shuffle tree in each warp
  for (int off = 16; off > 0; off >>= 1) {
    for (int k = 0; k < kNF; ++k) f[k] = __fadd_rn(f[k], __shfl_down_sync(kFull, f[k], off));
  }
  cnt = __reduce_add_sync(kFull, cnt);
  lcnt = __reduce_add_sync(kFull, lcnt);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < kNF; ++k) warp_part[k][warp] = f[k];
    warp_part[kNF][warp] = __int_as_float(cnt);
    warp_part[kNF + 1][warp] = __int_as_float(lcnt);
  }
  __syncthreads();
  // a fixed pairwise tree over the warps, one value a thread, pushed into
  // block 0's shared memory (distributed shared memory)
  float part = 0.0f;
  const int k = threadIdx.x;
  if (k < kNV) {
    if (k < kNF) {
      float v[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v[w] = warp_part[k][w];
      part = tree_sum<kWarps>(v);
    } else {
      int v = 0;
      for (int w = 0; w < kWarps; ++w) v += __float_as_int(warp_part[k][w]);
      part = __int_as_float(v);
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (k < kNV) cluster.map_shared_rank(&parts[0][0], 0)[blockIdx.x * kNV + k] = part;
  cluster.sync();
  if (blockIdx.x != 0) return;
  __shared__ float total[kNV];
  if (k < kNV) {
    if (k < kNF) {
      float v[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r) v[r] = parts[r][k];
      total[k] = tree_sum<kCluster>(v);
    } else {
      int v = 0;
      for (int r = 0; r < kCluster; ++r) v += __float_as_int(parts[r][k]);
      total[k] = __int_as_float(v);
    }
  }
  __syncthreads();
  if (k < 4) {
    out[G_TOTAL_LOAD + k] = total[k];
    out[G_AVG_PCT + k] = __fdiv_rn(total[k], cap_total);
    out[G_PCT_SUM + k] = total[4 + k];
    out[G_PCT_SUMSQ + k] = total[8 + k];
  }
  if (k != 0) return;
  const float tc = (float)__float_as_int(total[kNF]), tl = (float)__float_as_int(total[kNF + 1]);
  const float lbin = total[12];
  out[G_AVG_COUNT] = __fdiv_rn(tc, n_alive);
  out[G_TOTAL_COUNT] = tc > 1.0f ? tc : 1.0f;
  out[G_AVG_LCOUNT] = __fdiv_rn(tl, n_alive);
  out[G_TOTAL_LCOUNT] = tl > 1.0f ? tl : 1.0f;
  out[G_AVG_LBIN] = __fdiv_rn(lbin, n_alive);
  out[G_TOTAL_LBIN] = __fadd_rn(lbin, 1e-12f);
  out[G_TOTAL_DISK] = __fadd_rn(total[13], 1e-12f);
}

CC_EXPORT int cc_step_globals(GlobalsIn in, int B, int T, int D, void* out, void* stream) {
  // four counts and their four alive bytes a 16-byte load: rows of a
  // multiple of 4 counts, both arrays aligned
  const int vec = B % 4 == 0 && (uintptr_t)in.topic_count % 16 == 0 && (uintptr_t)in.alive % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * (1 + cc_blocks(T, kCluster)));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, step_globals_kernel, in, B, T, D, vec, (float*)out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
