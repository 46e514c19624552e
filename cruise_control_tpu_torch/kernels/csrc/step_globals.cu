// step_globals: the per-step frozen global scalars of the anneal, from the
// carry's broker aggregates, into the f32 vector the candidates kernel
// reads (kernels/step_globals.py LAYOUT) and the per-topic averages.
//
// Replaces (cruise_control_tpu/analyzer/engine.py): `_globals` (:1623), the
// masked sums over brokers (load, counts, leader bytes-in, disk load, the
// tiebreak's utilization sums) and over topic x broker, and the packing of
// them (move_delta.pack_globals).
//
// What bounds it on this card: latency.  It reads B broker rows (~40 B
// each) and the T x B topic counts (2 MB at the north star): under a
// microsecond of HBM time; a single launch of a few blocks is what it
// costs.  Design: one launch; block 0 sums the broker rows, each thread a
// fixed strided slice sequentially, then a fixed tree over the block, so
// the result is the same run after run; blocks 1.. sum the topic rows,
// one warp a topic (integers, exact in any order).
#include "common.cuh"

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
};

constexpr int kThreads = 512;  // 14 x 512 floats of shared memory for the tree
constexpr int kNF = 14;  // load[4], pct[4], pctsq[4], lbin, disk

__global__ void __launch_bounds__(kThreads) step_globals_kernel(GlobalsIn in, int B, int T, int D,
                                                                float n_alive, float* out) {
  if (blockIdx.x > 0) {
    const int t = (blockIdx.x - 1) * (kThreads / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (t >= T) return;
    int sum = 0;
    const int* row = in.topic_count + (size_t)t * B;
    for (int b = lane; b < B; b += 32) sum += in.alive[b] ? row[b] : 0;
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
    if (lane == 0) out[G_TOPIC_AVG + t] = __fdiv_rn((float)sum, n_alive);
    return;
  }
  __shared__ float sf[kNF][kThreads];
  __shared__ int si[2][kThreads];
  float f[kNF];
  for (int k = 0; k < kNF; ++k) f[k] = 0.0f;
  int cnt = 0, lcnt = 0;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    if (!in.alive[b]) continue;
    const float4 l = reinterpret_cast<const float4*>(in.broker_load)[b];
    const float4 c = reinterpret_cast<const float4*>(in.capacity)[b];
    const float lv[4] = {l.x, l.y, l.z, l.w};
    const float cv[4] = {c.x, c.y, c.z, c.w};
    for (int r = 0; r < 4; ++r) {
      const float pct = __fdiv_rn(lv[r], __fadd_rn(cv[r], 1e-12f));
      f[r] = __fadd_rn(f[r], lv[r]);
      f[4 + r] = __fadd_rn(f[4 + r], pct);
      f[8 + r] = __fadd_rn(f[8 + r], __fmul_rn(pct, pct));
    }
    cnt += in.rcount[b];
    lcnt += in.lcount[b];
    f[12] = __fadd_rn(f[12], in.lbin[b]);
    for (int d = 0; d < D; ++d) {
      if (in.disk_alive[(size_t)b * D + d]) f[13] = __fadd_rn(f[13], in.disk_load[(size_t)b * D + d]);
    }
  }
  for (int k = 0; k < kNF; ++k) sf[k][threadIdx.x] = f[k];
  si[0][threadIdx.x] = cnt;
  si[1][threadIdx.x] = lcnt;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      for (int k = 0; k < kNF; ++k) {
        sf[k][threadIdx.x] = __fadd_rn(sf[k][threadIdx.x], sf[k][threadIdx.x + half]);
      }
      si[0][threadIdx.x] += si[0][threadIdx.x + half];
      si[1][threadIdx.x] += si[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  for (int r = 0; r < 4; ++r) {
    out[G_TOTAL_LOAD + r] = sf[r][0];
    out[G_AVG_PCT + r] = __fdiv_rn(sf[r][0], in.total_cap[r]);
    out[G_PCT_SUM + r] = sf[4 + r][0];
    out[G_PCT_SUMSQ + r] = sf[8 + r][0];
  }
  const float tc = (float)si[0][0], tl = (float)si[1][0], lbin = sf[12][0];
  out[G_AVG_COUNT] = __fdiv_rn(tc, n_alive);
  out[G_TOTAL_COUNT] = tc > 1.0f ? tc : 1.0f;
  out[G_AVG_LCOUNT] = __fdiv_rn(tl, n_alive);
  out[G_TOTAL_LCOUNT] = tl > 1.0f ? tl : 1.0f;
  out[G_AVG_LBIN] = __fdiv_rn(lbin, n_alive);
  out[G_TOTAL_LBIN] = __fadd_rn(lbin, 1e-12f);
  out[G_TOTAL_DISK] = __fadd_rn(sf[13][0], 1e-12f);
}

CC_EXPORT int cc_step_globals(GlobalsIn in, int B, int T, int D, float n_alive, void* out,
                              void* stream) {
  const unsigned int blocks = 1 + cc_blocks(T, kThreads / 32);
  step_globals_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(in, B, T, D, n_alive,
                                                                      (float*)out);
  return (int)cudaGetLastError();
}
