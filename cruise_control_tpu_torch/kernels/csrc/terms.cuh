// The per-broker, per-host, intra-broker disk and dispersion terms of the
// anneal's objective, shared by move_delta.cu and candidates.cu.  The
// arithmetic follows broker_terms(), host_terms(), disk_terms() and
// tie_term() of kernels/move_delta.py term for term (sequential sums over
// the four resources and over a broker's logdirs in disk order;
// -fmad=false keeps every multiply and add rounded on its own).
//
// bf16 scoring (score_dtype "bfloat16", `broker_terms<true>`): each term is
// computed in f32 as before; their running sum is bf16 as XLA:CPU computes
// the JAX package's `out += term.astype(bf16)` chain: each term rounded to
// bf16, each add taken in f32 and rounded to bf16 with
// __float2bfloat16_rn, except the last add, whose f32 result is kept (XLA
// drops the bf16 round trip before the final cast to f32).  No native bf16
// add: it would round once where f32-then-bf16 rounds twice.
#pragma once
#include <cuda_bf16.h>

#include "common.cuh"

// Goal weights and thresholds, fixed by the engine's chain and constraint:
// mirror of kernels/move_delta.py `MDParams` (field order matters).  What a
// model generation changes (capacity totals, counts) is in `GenParams`.
struct MDParams {
  float cth[4];
  float t_bal[4];
  float t_low[4];
  float w_dist[4];
  int host_res[4];
  int max_replicas;
  float w_replica_cap;
  float w_pot_nw_out;
  float cth_nw_out;
  float w_replica_dist;
  float t_rc;
  float t_rc_low;
  float w_leader_dist;
  float t_lc;
  float t_lc_low;
  float w_lbin_dist;
  float t_lbin;
  float w_tie;
  // intra-broker disk goals (has_disk: either weighs in the chain)
  int has_disk;
  float w_intra_cap;
  float w_intra_dist;
  float d_thresh;
  float t_disk;
  float t_disk_low;
};

// g layout (pack_globals): avg_pct[4] total_load[4] pct_sum[4] pct_sumsq[4]
// avg_count total_count avg_lcount total_lcount avg_lbin total_lbin
// total_disk_load (step_globals' layout; move_delta.cu reads the first 22)
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
#define G_TOTAL_DISK_LOAD 22

// f32 x rounded to the nearest bf16 (ties to even), as f32
__device__ __forceinline__ float cc_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The running sum of broker_terms' terms: f32, or bf16 (see the top).
template <bool BF16>
struct TermSum {
  float v;
  __device__ __forceinline__ void first(float t) { v = BF16 ? cc_round_bf16(t) : t; }
  __device__ __forceinline__ void add(float t) {
    v = BF16 ? cc_round_bf16(v + cc_round_bf16(t)) : v + t;
  }
  __device__ __forceinline__ float last(float t) const { return BF16 ? v + cc_round_bf16(t) : v + t; }
};

template <bool BF16 = false>
__device__ float broker_terms(const MDParams& p, const GenParams& q, const float* __restrict__ g,
                              const float cap[4],
                              bool alive, bool single, const float load[4], int rcount,
                              int lcount, float pot, float lbin) {
  // capacity goals (broker granularity)
  float cap_t = 0.0f;
  for (int r = 0; r < 4; ++r) {
    const float excess = cc_relu(load[r] - p.cth[r] * cap[r]);
    const bool gate = alive && (single || !p.host_res[r]);
    const float t = (gate ? excess : 0.0f) * q.w_cap_tc[r];
    cap_t = (r == 0) ? t : cap_t + t;
  }
  TermSum<BF16> out;
  out.first(cap_t);
  // replica capacity
  float exc = cc_relu((float)(rcount - p.max_replicas));
  out.add((p.w_replica_cap * (alive ? exc : 0.0f)) / q.n_valid);
  // potential nw out
  exc = cc_relu(pot - p.cth_nw_out * cap[2]);
  out.add((p.w_pot_nw_out * (alive ? exc : 0.0f)) / q.total_cap_nw_out);
  // resource distribution bands
  float s = 0.0f;
  for (int r = 0; r < 4; ++r) {
    const float upper = (g[G_AVG_PCT + r] * p.t_bal[r]) * cap[r];
    const float lower = (g[G_AVG_PCT + r] * p.t_low[r]) * cap[r];
    const float term = cc_relu(load[r] - upper) + cc_relu(lower - load[r]);
    const float wd = p.w_dist[r] / (g[G_TOTAL_LOAD + r] + 1e-12f);
    const float t = (alive ? term : 0.0f) * wd;
    s = (r == 0) ? t : s + t;
  }
  out.add(s);
  // replica count distribution
  {
    const float upper = ceilf(g[G_AVG_COUNT] * p.t_rc);
    const float lower = floorf(g[G_AVG_COUNT] * p.t_rc_low);
    const float rc = (float)rcount;
    const float term = cc_relu(rc - upper) + cc_relu(lower - rc);
    out.add((p.w_replica_dist * (alive ? term : 0.0f)) / g[G_TOTAL_COUNT]);
  }
  // leader count distribution
  {
    const float upper = ceilf(g[G_AVG_LCOUNT] * p.t_lc);
    const float lower = floorf(g[G_AVG_LCOUNT] * p.t_lc_low);
    const float lc = (float)lcount;
    const float term = cc_relu(lc - upper) + cc_relu(lower - lc);
    out.add((p.w_leader_dist * (alive ? term : 0.0f)) / g[G_TOTAL_LCOUNT]);
  }
  // leader bytes-in distribution (upper band only)
  const float term = cc_relu(lbin - g[G_AVG_LBIN] * p.t_lbin);
  return out.last((p.w_lbin_dist * (alive ? term : 0.0f)) / g[G_TOTAL_LBIN]);
}

__device__ float host_terms(const MDParams& p, const GenParams& q, bool multi,
                            const float hload[4], const float hcap[4]) {
  float out = 0.0f;
  for (int r = 0; r < 4; ++r) {
    const float excess = cc_relu(hload[r] - p.cth[r] * hcap[r]);
    const float t = (multi ? excess : 0.0f) * q.w_cap_host_tc[r];
    out = (r == 0) ? t : out + t;
  }
  return out;
}

// One resource's dispersion: the std of the alive brokers' utilization from
// its sum s and sum of squares sq.
__device__ __forceinline__ float tie_part(const GenParams& q, float s, float sq) {
  const float mean = s / q.n_alive;
  const float var = cc_relu(sq / q.n_alive - mean * mean);
  return sqrtf(var + 1e-18f);
}

__device__ float tie_term(const MDParams& p, const GenParams& q, const float s[4],
                         const float sq[4]) {
  float out = 0.0f;
  for (int r = 0; r < 4; ++r) {
    const float t = tie_part(q, s[r], sq[r]);
    out = (r == 0) ? t : out + t;
  }
  return p.w_tie * out;
}

// A hypothetical logdir row of one broker: its current row with one or two
// cells changed, as the plain version writes it (so that the same
// products and sums round the same way).
struct DiskEdit {
  int mode;  // 0: row; 1: row - onehot(a) * x; 2: row + onehot(a) * x;
             // 3: row + (onehot(a) - onehot(b)) * x
  int a, b;
  float x;
};

__device__ __forceinline__ float disk_cell(const DiskEdit& m, int d, float v) {
  const float ia = d == m.a ? 1.0f : 0.0f;
  if (m.mode == 1) return v - ia * m.x;
  if (m.mode == 2) return v + ia * m.x;
  if (m.mode == 3) return v + (ia - (d == m.b ? 1.0f : 0.0f)) * m.x;
  return v;
}

// IntraBrokerDiskCapacityGoal + IntraBrokerDiskUsageDistributionGoal of one
// broker: its D logdirs' loads `row` edited by `m`, their sum `bsum`, its
// logdirs' capacities and health, whether the broker is alive.
__device__ float disk_terms(const MDParams& p, const GenParams& q, float total_disk_load, int D,
                            const float* __restrict__ row, const float* __restrict__ dcap,
                            const bool* __restrict__ dalive, bool alive, const DiskEdit& m,
                            float bsum) {
  float cap_term = 0.0f, bcap = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float v = disk_cell(m, d, row[d]);
    const bool ok = alive && dalive[d];
    const float t = ok ? cc_relu(v - p.d_thresh * dcap[d]) : v;
    cap_term = d == 0 ? t : cap_term + t;
    const float c = ok ? dcap[d] : 0.0f;
    bcap = d == 0 ? c : bcap + c;
  }
  const float out = (p.w_intra_cap * cap_term) / q.total_disk_cap;
  const float avg_pct = bsum / (bcap + 1e-12f);
  float dist = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float v = disk_cell(m, d, row[d]);
    const float upper = (avg_pct * p.t_disk) * dcap[d];
    const float lower = (avg_pct * p.t_disk_low) * dcap[d];
    const float t = (alive && dalive[d]) ? cc_relu(v - upper) + cc_relu(lower - v) : 0.0f;
    dist = d == 0 ? t : dist + t;
  }
  return out + (p.w_intra_dist * dist) / total_disk_load;
}
