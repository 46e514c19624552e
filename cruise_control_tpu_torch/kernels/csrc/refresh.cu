// refresh_aggregates: every per-broker aggregate of a placement, from the
// replica rows grouped by broker (group_by_broker's order), the partition x
// rack counts from the partitions' member table, and the per-host load from
// the brokers grouped by host, in one cooperative launch.
//
// Replaces (cruise_control_tpu/models/aggregates.py): `compute_aggregates`
// (:56) and `host_load` (:117), as the engine's `_refresh_impl`
// (cruise_control_tpu/analyzer/engine.py:1433) runs them between rounds.
// Each float aggregate of a broker adds the broker's rows in row order
// starting from 0 with __fadd_rn, which is the order of the reference's
// scatter and of `index_add_` on the CPU: the result is bit for bit the
// plain version's.  Every output cell is written once; no atomic leaves
// shared memory.
//
// What bounds it on this card: bytes by count — the partition x rack table
// (P x racks ints, 41.6 MB at the north star) written once and each replica
// row read once (~33 B): ~65 MB, ~20 us of HBM time.  In practice, the
// memory system's rate of small random requests: a row's fields lie in five
// arrays at a random row id, so each costs a request of its own (~2.8M at
// the north star, with the members' brokers), and no schedule of the work
// below changed the total on the card.  The first design took
// three launches: a clear of both integer tables (the 41.6 MB written
// twice), one warp a broker that added the rows' cells with 1M scattered
// global atomics and shuffled each row's 7 floats to all 32 lanes, which
// all ran the same 7 sums, and a host pass.  Design, blocks of 8 warps, at
// most as many as are resident, over a list of work items:
//  - a broker tile (8 brokers, one a warp).  The warp gathers 64 of its
//    broker's rows at a time with all lanes (order ids one tile ahead of
//    the rows, so the dependent loads overlap the sums; a leader's
//    follower row is not read), stages each row's 7 addends in shared
//    memory, counts the rows' topics into the tile's shared T x 8 table
//    and its leaders with ballots; then one lane per accumulator (4 loads,
//    potential NW-out, leader bytes-in, one lane per disk, D <= 32) adds
//    the tile's rows in order.  The block writes its brokers' columns of
//    the topic x broker table, each cell once.  (Gathering a tile's rows
//    with the whole block between barriers, which spreads a hot broker's
//    rows over all its threads, was slower on the card: it loses the
//    overlap of one tile's gathers with the previous tile's sums.)
//  - a partition tile (256 partitions): the racks of each partition's
//    members (member table -> broker -> rack) into shared memory, then the
//    tile's rows of the partition x rack table, zeros included, with
//    16-byte stores.
//  - after grid.sync() (only when both brokers and hosts are asked for),
//    one thread a host adds its brokers' load rows in broker order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRpl = 2;                 // rows a lane gathers per tile
constexpr int kTile = 32 * kRpl;        // rows of a broker per tile
constexpr int kWords = 7;               // staged words a row
constexpr int kSum = 16;                // staged rows an accumulator lane loads at once
constexpr int kPartTile = kThreads;     // partitions per partition tile
constexpr int kMaxMembers = 16;         // members a partition may have (the wrapper checks)
constexpr int kSmemMax = 200 * 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct RefreshDims {
  int R, B, T, P, racks, D, H, M;
};

struct RefreshIn {
  const int* order;  // [R] rows grouped by broker
  const int* start;  // [B]
  const int* count;  // [B]
  const bool* is_leader;
  const int* replica_disk;
  const float* load_leader;    // [R, 4]
  const float* load_follower;  // [R, 4]
  const int* topic;
  const int* replica_broker;  // [R]
  const int* members;         // [P, M] valid replica ids of each partition, padded with R
  const int* broker_rack;
  const int* host_order;  // [B] brokers grouped by host (nullptr: no host pass)
  const int* host_start;  // [H]
  const int* host_count;  // [H]
};

struct RefreshOut {
  float* broker_load;  // [B, 4]
  int* rcount;
  int* lcount;
  float* pot;
  float* lbin;
  int* topic_count;      // [T, B]
  int* part_rack_count;  // [P, racks]
  float* disk_load;      // [B, D]
  float* host_load;      // [H, 4]
};

// One tile of a broker's rows as a lane holds it.
struct Rows {
  float4 L[kRpl], F[kRpl];
  int disk[kRpl], topic[kRpl];
  bool lead[kRpl], act[kRpl];
};

__device__ __forceinline__ void load_ids(const RefreshIn& in, int s0, int cnt, int t, int lane,
                                         int (&ids)[kRpl]) {
#pragma unroll
  for (int k = 0; k < kRpl; ++k) {
    const int j = t + 32 * k + lane;
    ids[k] = j < cnt ? __ldg(in.order + s0 + j) : -1;
  }
}

__device__ __forceinline__ void load_rows(const RefreshIn& in, const int (&ids)[kRpl], Rows& x) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < kRpl; ++k) {
    const int r = ids[k];
    x.act[k] = r >= 0;
    const int q = r >= 0 ? r : 0;
    x.lead[k] = r >= 0 && in.is_leader[q];
    x.L[k] = r >= 0 ? __ldg(reinterpret_cast<const float4*>(in.load_leader) + q) : z;
    // a leader's follower row is not needed (one random request fewer)
    x.F[k] = r >= 0 && !x.lead[k] ? __ldg(reinterpret_cast<const float4*>(in.load_follower) + q) : z;
    x.disk[k] = r >= 0 ? __ldg(in.replica_disk + q) : -1;
    x.topic[k] = r >= 0 ? __ldg(in.topic + q) : -1;
  }
}

// The warp's broker b: rows gathered a tile at a time, summed in row order.
// st: the warp's staging rows [kTile][kWords]; tc: the broker's topic counts [T].
__device__ void broker_rows(const RefreshDims& n, const RefreshIn& in, const RefreshOut& out, int b,
                            float* st, int* tc) {
  const int lane = threadIdx.x & 31;
  const int s0 = in.start[b], cnt = in.count[b];
  // accumulators: lane a sums column a (0-3 load, 4 potential NW-out, 5
  // leader bytes-in) or, from a = 6, disk a - 6 (lanes 0-5 also take
  // disks 26-31)
  const int n_acc = 6 + n.D;
  float acc0 = 0.0f, acc1 = 0.0f;
  int leaders = 0;
  int ids[kRpl];
  Rows x;
  load_ids(in, s0, cnt, 0, lane, ids);
  load_rows(in, ids, x);
  load_ids(in, s0, cnt, kTile, lane, ids);
  for (int t = 0; t < cnt; t += kTile) {
#pragma unroll
    for (int k = 0; k < kRpl; ++k) {
      if (x.act[k]) {
        float* w = st + (32 * k + lane) * kWords;
        const float4 v = x.lead[k] ? x.L[k] : x.F[k];
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
        w[4] = x.L[k].z;                        // NW_OUT of the leader row
        w[5] = x.lead[k] ? x.L[k].y : 0.0f;     // NW_IN served as leader
        w[6] = __int_as_float(x.disk[k]);
        if ((unsigned)x.topic[k] < (unsigned)n.T) atomicAdd(&tc[x.topic[k]], 1);
      }
      leaders += __popc(__ballot_sync(kFull, x.act[k] && x.lead[k]));
    }
    __syncwarp();
    // the next tile's rows and the one after's ids, in flight during the sums
    if (t + kTile < cnt) {
      load_rows(in, ids, x);
      load_ids(in, s0, cnt, t + 2 * kTile, lane, ids);
    }
    const int m = cnt - t < kTile ? cnt - t : kTile;
    for (int a = lane, i = 0; a < n_acc; a += 32, ++i) {
      const int col = a < 6 ? a : 3;
      float acc = i == 0 ? acc0 : acc1;
      // kSum rows' addends loaded before they are added: the adds wait on
      // each other, the loads do not
      for (int k0 = 0; k0 < m; k0 += kSum) {
        float v[kSum];
        bool take[kSum];
#pragma unroll
        for (int u = 0; u < kSum; ++u) {
          const int k = k0 + u < m ? k0 + u : m - 1;
          v[u] = st[k * kWords + col];
          take[u] = k0 + u < m && (a < 6 || __float_as_int(st[k * kWords + 6]) == a - 6);
        }
#pragma unroll
        for (int u = 0; u < kSum; ++u) acc = take[u] ? __fadd_rn(acc, v[u]) : acc;
      }
      if (i == 0) {
        acc0 = acc;
      } else {
        acc1 = acc;
      }
    }
    __syncwarp();
  }
  for (int a = lane, i = 0; a < n_acc; a += 32, ++i) {
    const float v = i == 0 ? acc0 : acc1;
    if (a < 4) {
      out.broker_load[(size_t)b * 4 + a] = v;
    } else if (a == 4) {
      out.pot[b] = v;
    } else if (a == 5) {
      out.lbin[b] = v;
    } else {
      out.disk_load[(size_t)b * n.D + a - 6] = v;
    }
  }
  if (lane == 0) {
    out.rcount[b] = cnt;
    out.lcount[b] = leaders;
  }
}

__device__ void broker_tile(const RefreshDims& n, const RefreshIn& in, const RefreshOut& out, int b0,
                            float* stage, int* tc) {
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kWarps * n.T; j += kThreads) tc[j] = 0;
  __syncthreads();
  if (b0 + warp < n.B) broker_rows(n, in, out, b0 + warp, stage + warp * kTile * kWords, tc + warp * n.T);
  __syncthreads();
  const int nbk = n.B - b0 < kWarps ? n.B - b0 : kWarps;
  for (int j = threadIdx.x; j < n.T * nbk; j += kThreads) {
    const int t = j / nbk, w = j - t * nbk;
    out.topic_count[(size_t)t * n.B + b0 + w] = tc[w * n.T + t];
  }
  __syncthreads();
}

__device__ void part_tile(const RefreshDims& n, const RefreshIn& in, const RefreshOut& out, int p0,
                          int* rk) {
  const int np = n.P - p0 < kPartTile ? n.P - p0 : kPartTile;
  // a thread's M entries (kPartTile == kThreads), four chains at a time:
  // member -> its broker -> the broker's rack, each level's loads together
  for (int q0 = 0; q0 < n.M; q0 += 4) {
    int j[4], r[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      j[u] = threadIdx.x + (q0 + u) * kThreads;
      r[u] = q0 + u < n.M && j[u] < np * n.M ? __ldg(in.members + (size_t)p0 * n.M + j[u]) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) b[u] = (unsigned)r[u] < (unsigned)n.R ? __ldg(in.replica_broker + r[u]) : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = (unsigned)b[u] < (unsigned)n.B ? __ldg(in.broker_rack + b[u]) : -1;
      if (q0 + u < n.M && j[u] < np * n.M) rk[j[u]] = (unsigned)k < (unsigned)n.racks ? k : -1;
    }
  }
  __syncthreads();
  // the tile's cells, flat from p0 * racks (16-byte aligned: p0 is a
  // multiple of 256), four at a time
  const int cells = np * n.racks;
  int* base = out.part_rack_count + (size_t)p0 * n.racks;
  // four cells span at most two partitions when racks >= 4: their
  // members' racks first; fewer racks take the cell-by-cell loop below
  const int vec = n.racks >= 4 ? cells / 4 : 0;
  for (int v = threadIdx.x; v < vec; v += kThreads) {
    const int pl = 4 * v / n.racks, k0 = 4 * v - pl * n.racks;
    const int pl2 = pl + 1 < np ? pl + 1 : pl;
    int ra[kMaxMembers], rb[kMaxMembers];
#pragma unroll
    for (int m = 0; m < kMaxMembers; ++m) {
      if (m >= n.M) break;
      ra[m] = rk[pl * n.M + m];
      rb[m] = rk[pl2 * n.M + m];
    }
    int c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool next = k0 + q >= n.racks;
      const int k = next ? k0 + q - n.racks : k0 + q;
      int x = 0;
#pragma unroll
      for (int m = 0; m < kMaxMembers; ++m) {
        if (m >= n.M) break;
        x += (next ? rb[m] : ra[m]) == k;
      }
      c[q] = x;
    }
    reinterpret_cast<int4*>(base)[v] = make_int4(c[0], c[1], c[2], c[3]);
  }
  for (int c = 4 * vec + threadIdx.x; c < cells; c += kThreads) {
    const int pl = c / n.racks, k = c - pl * n.racks;
    int x = 0;
    for (int m = 0; m < n.M; ++m) x += rk[pl * n.M + m] == k;
    base[c] = x;
  }
  __syncthreads();
}

// (three blocks an SM: at most 85 registers a thread)
__global__ void __launch_bounds__(kThreads, 3) refresh_aggregates_kernel(RefreshDims n, RefreshIn in,
                                                                      RefreshOut out, int brokers) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [kWarps][kTile][kWords]
  int* tc = reinterpret_cast<int*>(stage + kWarps * kTile * kWords);  // [kWarps][T]
  int* rk = tc + kWarps * n.T;  // [kPartTile][M]
  if (brokers) {
    const int n_bt = (n.B + kWarps - 1) / kWarps, n_pt = (n.P + kPartTile - 1) / kPartTile;
    for (int item = blockIdx.x; item < n_bt + n_pt; item += gridDim.x) {
      if (item < n_bt) {
        broker_tile(n, in, out, item * kWarps, stage, tc);
      } else {
        part_tile(n, in, out, (item - n_bt) * kPartTile, rk);
      }
    }
  }
  if (in.host_order == nullptr) return;
  if (brokers) cg::this_grid().sync();  // its fence makes every broker row visible
  const float4* bl = reinterpret_cast<const float4*>(out.broker_load);
  for (int h = blockIdx.x * kThreads + threadIdx.x; h < n.H; h += gridDim.x * kThreads) {
    const int s0 = in.host_start[h], cnt = in.host_count[h];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < cnt; ++j) {
      const float4 v = __ldcg(bl + in.host_order[s0 + j]);
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    reinterpret_cast<float4*>(out.host_load)[h] = acc;
  }
}

static size_t refresh_smem(int T, int M) {
  return sizeof(float) * kWarps * kTile * kWords + sizeof(int) * ((size_t)kWarps * T + (size_t)kPartTile * M);
}

// The most blocks that are resident at once with T topics and M members a
// partition on the current device (0: the shared memory does not fit).
// Raises the kernel's shared-memory cap once.
CC_EXPORT int cc_refresh_geometry(int T, int M, int* blocks) {
  *blocks = 0;
  const size_t smem = refresh_smem(T, M);
  if (T < 0 || M < 0 || smem > (size_t)kSmemMax) return 0;
  cudaError_t e = cudaFuncSetAttribute(refresh_aggregates_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refresh_aggregates_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = n_sm * per_sm;
  return 0;
}

// brokers: the broker and partition tiles; in.host_order != nullptr: the
// host pass (reading out.broker_load).  One cooperative launch of at most
// `blocks` blocks (cc_refresh_geometry's for the same T and M).
CC_EXPORT int cc_refresh_aggregates(RefreshDims n, RefreshIn in, RefreshOut out, int brokers, int blocks,
                                    void* stream) {
  const long long items = brokers ? (long long)(n.B + kWarps - 1) / kWarps + (n.P + kPartTile - 1) / kPartTile : 0;
  const long long host_blocks = in.host_order ? (n.H + kThreads - 1) / kThreads : 0;
  long long need = items > host_blocks ? items : host_blocks;
  need = need < 1 ? 1 : need;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(need < blocks ? need : blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = brokers ? refresh_smem(n.T, n.M) : 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, refresh_aggregates_kernel, n, in, out, brokers);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
