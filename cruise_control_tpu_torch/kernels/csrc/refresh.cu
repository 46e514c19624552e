// refresh_aggregates: every per-broker aggregate of a placement, from the
// replica rows grouped by broker (group_by_broker's order), and the
// per-host load from the brokers grouped by host.
//
// Replaces (cruise_control_tpu/models/aggregates.py): `compute_aggregates`
// (:56) and `host_load` (:117), as the engine's `_refresh_impl`
// (cruise_control_tpu/analyzer/engine.py:1433) runs them between rounds.
// Each float aggregate of a broker adds the broker's rows in row order
// starting from 0, which is the order of the reference's scatter and of
// `index_add_` on the CPU: the result is bit for bit the plain version's.
// The integer cells (topic x broker, partition x rack) are counted with
// atomics, which are exact in any order.
//
// What bounds it on this card: bytes.  Each replica row is read once
// (order id, leader flag, disk, topic, partition, two load rows: ~50 B),
// ~25 MB at 500k rows, plus clearing the partition x rack cells (P x racks
// ints, 42 MB at the north star): ~20 us of HBM time.  Design:
//  - refresh_zero_kernel clears the two integer cell tables;
//  - refresh_broker_kernel, one warp per broker: the lanes load 32 of the
//    broker's rows at once, add their integer cells with atomics, and then
//    every lane runs the same sequential float sums over the 32 values,
//    taken lane by lane with shuffles, so the order is the row order.  A
//    broker's disk d is summed by lane d (D <= 32);
//  - refresh_host_kernel, one thread per host, adds its brokers' load rows
//    in broker order.
#include "common.cuh"

struct RefreshDims {
  int R, B, T, P, racks, D, H;
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
  const int* partition;
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

__global__ void refresh_zero_kernel(int* a, long long na, int* b, long long nb) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < na + nb; i += stride) {
    if (i < na) {
      a[i] = 0;
    } else {
      b[i - na] = 0;
    }
  }
}

__global__ void refresh_broker_kernel(RefreshDims n, RefreshIn in, RefreshOut out) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= n.B) return;
  const int s0 = in.start[b];
  const int cnt = in.count[b];
  const int rack = in.broker_rack[b];
  float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f, l3 = 0.0f, pot = 0.0f, lbin = 0.0f, disk = 0.0f;
  int leaders = 0;
  for (int t = 0; t < cnt; t += 32) {
    const int j = t + lane;
    const bool act = j < cnt;
    float4 ld = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float p = 0.0f, lb = 0.0f;
    int d = -1;
    bool lead = false;
    if (act) {
      const int r = in.order[s0 + j];
      lead = in.is_leader[r];
      const float4 L = reinterpret_cast<const float4*>(in.load_leader)[r];
      ld = lead ? L : reinterpret_cast<const float4*>(in.load_follower)[r];
      p = L.z;                  // NW_OUT of the leader row
      lb = lead ? L.y : 0.0f;   // NW_IN served as leader
      d = in.replica_disk[r];
      atomicAdd(&out.topic_count[(size_t)in.topic[r] * n.B + b], 1);
      atomicAdd(&out.part_rack_count[(size_t)in.partition[r] * n.racks + rack], 1);
    }
    leaders += __popc(__ballot_sync(0xFFFFFFFFu, act && lead));
    const int m = cnt - t < 32 ? cnt - t : 32;
    for (int k = 0; k < m; ++k) {
      l0 = __fadd_rn(l0, __shfl_sync(0xFFFFFFFFu, ld.x, k));
      l1 = __fadd_rn(l1, __shfl_sync(0xFFFFFFFFu, ld.y, k));
      l2 = __fadd_rn(l2, __shfl_sync(0xFFFFFFFFu, ld.z, k));
      const float w = __shfl_sync(0xFFFFFFFFu, ld.w, k);
      l3 = __fadd_rn(l3, w);
      pot = __fadd_rn(pot, __shfl_sync(0xFFFFFFFFu, p, k));
      lbin = __fadd_rn(lbin, __shfl_sync(0xFFFFFFFFu, lb, k));
      if (__shfl_sync(0xFFFFFFFFu, d, k) == lane) disk = __fadd_rn(disk, w);
    }
  }
  if (lane == 0) {
    reinterpret_cast<float4*>(out.broker_load)[b] = make_float4(l0, l1, l2, l3);
    out.rcount[b] = cnt;
    out.lcount[b] = leaders;
    out.pot[b] = pot;
    out.lbin[b] = lbin;
  }
  if (lane < n.D) out.disk_load[(size_t)b * n.D + lane] = disk;
}

__global__ void refresh_host_kernel(RefreshDims n, RefreshIn in, RefreshOut out) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= n.H) return;
  const int s0 = in.host_start[h];
  const int cnt = in.host_count[h];
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < cnt; ++j) {
    const float4 v = reinterpret_cast<const float4*>(out.broker_load)[in.host_order[s0 + j]];
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
  }
  reinterpret_cast<float4*>(out.host_load)[h] = acc;
}

// brokers: run the zero and broker passes; in.host_order != nullptr: run
// the host pass (reading out.broker_load).
CC_EXPORT int cc_refresh_aggregates(RefreshDims n, RefreshIn in, RefreshOut out, int brokers,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (brokers) {
    const long long na = (long long)n.T * n.B, nb = (long long)n.P * n.racks;
    refresh_zero_kernel<<<1024, 256, 0, st>>>(out.topic_count, na, out.part_rack_count, nb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (n.B > 0) {
      refresh_broker_kernel<<<cc_blocks((long long)n.B * 32, 128), 128, 0, st>>>(n, in, out);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  if (in.host_order != nullptr && n.H > 0) {
    refresh_host_kernel<<<cc_blocks(n.H, 128), 128, 0, st>>>(n, in, out);
  }
  return (int)cudaGetLastError();
}
