// candidates: one anneal step's K candidate moves, drawn, scored and
// accepted in registers, written straight into the layouts that
// select_survivors and apply_moves read.
//
// Replaces (cruise_control_tpu/analyzer/engine.py): the draws of
// `_uniform_idx` (:958) and `_sample_sources` (:1810), `_replica_candidates`
// (:1954) or, in the rebalance_disk mode, `_intra_disk_candidates` (:2078),
// `_swap_candidates` (:2160), `_leadership_candidates` (:2348), their
// `_move_delta` (:2439) with `_disk_terms` (:1767) when the chain weighs
// the intra-broker disk goals, `_assemble_prop` (:2580) and the Metropolis
// acceptance of `_accept_select_apply` (:2669).  The arithmetic follows
// candidates_plain() in kernels/candidates.py term for term, branching
// where it branches (topic cells, preferred leader, pricing), so that no
// `0 * x` turns a -0.0 into +0.0.
//
// What bounds it on this card: latency.  The bytes a north-star step needs
// (K = 16,384 candidates: replica rows, member rows, src/dst broker, host
// and disk rows, CDF probes, ~22 B of bundle and a 53/64 B payload row
// each) are a few MB, about a microsecond of HBM time; the ALU work is a
// few hundred flops a candidate.  What is left is each candidate's chain
// of dependent gathers (source draw -> replica row -> broker row ->
// aggregates), so the design keeps that chain short:
//  - Old-state terms once per broker: broker_terms() of a broker's
//    current row depends on the broker and the step's globals only, so a
//    prologue launch (B + H + 1 threads) writes them to f32[B], the host
//    terms to f32[H] and the old tiebreak to f32[1].  A candidate then
//    evaluates only its two "new" lanes.  The same function of the same
//    inputs: the bits do not change.  The intra mode reads none of them
//    and skips the prologue.
//  - Draws inline: each candidate hashes its own threefry counters
//    (common.cuh) under the step's keys, read from the run's key table at
//    the device-side round index (so a captured step replays with the
//    keys of the round it runs in), and no draw touches HBM.  The counter of uniform draw i under a key is i, as in the
//    `uniform(key, n)` call it replaces; the importance branch uses
//    i - (n - n_imp), the Metropolis u the candidate's index in K.
//  - The broker CDF (B floats, 10.4 KB at B = 2,600) is staged in shared
//    memory by the blocks that hold importance-sampled sources, so the
//    ~12 dependent probes of the upper-bound search hit shared memory.
//  - One launch for all K candidates, each move kind in its own block
//    range; one thread per candidate.  K = 16,384 is ~124 threads an SM,
//    so occupancy is low; splitting a candidate over 2-4 threads (the
//    src/dst lanes, the member scan) joined by shuffles is the next step
//    if the profile shows the chain, not the launch, dominating.
//  - The JBOD path: a lane whose move touches logdirs loads the D-wide
//    disk rows (load, capacity, health) of its src and dst beside their
//    broker rows and evaluates the intra-broker disk terms of the four
//    rows (src and dst, after and before) in registers, summing over the
//    logdirs in disk order as the plain version does.  An intra-broker
//    lane (rebalance_disk) draws no destination broker: it picks the
//    most-free other alive logdir of its replica's broker and writes a
//    relocation row with src == dst.
//  - The learned prior (PRIOR; `_sample_dests`, engine.py:1832-1873): a
//    relocation's destination position is the uniform draw, or, where a
//    third draw falls below prior_mix (a device scalar, so that a captured
//    step reads the value of the run), the upper bound of a fourth draw in
//    its source topic's prior CDF (f32[T, B], a fixed buffer refilled by
//    Engine.rebind_prior), clamped to n_dest - 1.  The reference counts
//    u >= cdf over the whole row; the CDF is a sequential f32 prefix sum
//    of non-negative values (non-decreasing) and 1.0 past n_dest (never
//    <= u < 1), so a binary search over the first n_dest entries gives the
//    same index in ~12 probes of one 10.4 KB row (the table, 2.08 MB at the
//    north star, stays in L2).  The two draws' keys are a table of their
//    own (`prior_keys`), so the default key table is unchanged.  The lane
//    also writes whether it took the prior (`from_prior`, read by the
//    diagnostics' counts in select_survivors).
//  - bf16 scoring (BF16): the broker terms' running sum in bf16
//    (terms.cuh), here and in the prologue; every other term stays f32.
//  DISK, INTRA, PRIOR and BF16 are template parameters, so each mode
//  compiles apart and the default lanes are the ones without them; the
//  intra kind has no prior and no broker terms, so it has no PRIOR or BF16
//  variant: 10 instantiations of candidates_kernel, 2 of the prologue.
// Tensor cores do not apply (there is no matrix product), and TMA is not
// worth it for scattered row gathers.
#include "terms.cuh"

struct Key2 {
  uint32_t k0, k1;
};

// A row of the run's key table (kernels/candidates.py KEY_WORDS words).
struct StepKeys {
  Key2 rel_src[4];  // uniform source, CDF u, slot u, fallback (split(4))
  Key2 rel_dst;
  Key2 swap_src[4];
  Key2 swap_q;
  Key2 lead;
  Key2 u;
};

struct CandDims {
  int K_r, K_s, K_l, n_imp_r, n_imp_s;
  int R, B, P, T, D, H, racks, max_rf;
  int n_source, n_dest, n_brokers;
  int has_plan, has_topic, has_pref, price_r, price_l, cdf_in_smem;
  int intra;  // the K_r lanes are intra-broker disk moves
  int step, steps_per_round;  // this step's row: (*rnd) * steps_per_round + step
  int prior;  // relocation destinations mixed from the learned prior
  int bf16;   // the broker terms summed in bf16
};

struct CandScalars {
  float w_rack, w_offline, w_topic, w_pref, topic_tt, topic_tt_low, num_parts;
  float u_min, u_span;
};

struct CandInputs {
  // state
  const int* orig_broker;
  const int* part_of;
  const int* topic_of;
  const bool* valid;
  const int* pos;
  const bool* orig_lead;
  const int* orig_disk;
  const float* load_leader;    // [R, 4]
  const float* load_follower;  // [R, 4]
  const bool* broker_alive;
  const int* broker_rack;
  const int* broker_host;
  const float* capacity;  // [B, 4]
  const bool* disk_alive;        // [B, D]
  const float* disk_capacity;    // [B, D]
  // statics
  const int* part_replicas;  // [P, max_rf], padded with R
  const bool* alive;
  const int* dest_ids;
  const bool* dest_ok;
  const bool* lead_ok;
  const bool* topic_movable;
  const bool* host_multi;
  const float* host_cap;  // [H, 4]
  // carry
  const int* replica_broker;
  const bool* replica_is_leader;
  const int* replica_disk;
  const float* broker_load;  // [B, 4]
  const int* rcount;
  const int* lcount;
  const float* pot;
  const float* lbin;
  const int* topic_count;      // [T, B]
  const int* part_rack_count;  // [P, racks]
  const float* disk_load;      // [B, D]
  const float* host_load;      // [H, 4]
  // per-step globals (step_globals: the first 23 floats) and the round's plan
  const float* g;
  const float* topic_avg;  // [T]
  const float* cdf;        // [B]
  const int* order;        // [R]
  const int* start;        // [B]
  const int* count;        // [B]
  const float* replica_cost;
  const float* lead_cost;
  // the run's key table, the round index and the round's temperature
  const StepKeys* key_table;
  const int* rnd;
  const float* temperature;
  // the learned prior: per key-table row its two draws' keys (mix, CDF u),
  // the per-topic CDF over destination positions, f32[T, B], and the mix
  const Key2* prior_keys;
  const float* prior_cdf;
  const float* prior_mix;
};

struct CandOutputs {
  float* delta;
  bool* feas;
  bool* accept;
  int* src;
  int* dst;
  int* part1;
  int* part2;
  // relocation rows: K_r relocations, then each swap at K_r + i and K_r + K_s + i
  int* r;
  int* r_src;
  int* r_dst;
  int* d_src;
  int* d_dst;
  float* load;  // [K_r + 2 K_s, 4]
  bool* is_lead;
  float* pot;
  float* lbin;
  int* topic;
  int* part;
  // leadership rows
  int* rf;
  int* rt;
  int* src_b;
  int* dst_b;
  float* dl_f;  // [K_l, 4]
  float* dl_t;  // [K_l, 4]
  float* dlbin_src;
  float* dlbin_dst;
  int* d_f;
  int* d_t;
  // old-state terms (the prologue's output)
  float* old_broker;  // [B]
  float* old_host;    // [H]
  float* old_tie;     // [1]
  // the relocations' took-the-prior mask [K_r] (PRIOR)
  bool* from_prior;
};

struct Ctx {
  CandDims n;
  MDParams p;
  CandScalars s;
  CandInputs in;
  CandOutputs out;
};

__device__ __forceinline__ const StepKeys& keys(const Ctx& c) {
  return c.in.key_table[(size_t)(*c.in.rnd) * c.n.steps_per_round + c.n.step];
}

__device__ __forceinline__ float f01(bool b) { return b ? 1.0f : 0.0f; }

__device__ __forceinline__ float unit(const Key2& k, unsigned long long i) {
  return cc_unit_float(k.k0, k.k1, i);
}

__device__ __forceinline__ void row4(const float* __restrict__ a, int i, float v[4]) {
  const float4 x = reinterpret_cast<const float4*>(a)[i];
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void put4(float* __restrict__ a, int i, const float v[4]) {
  reinterpret_cast<float4*>(a)[i] = make_float4(v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------------------
// prologue: old-state terms
// ---------------------------------------------------------------------------

template <bool BF16>
__global__ void candidates_prologue_kernel(Ctx c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const CandInputs& in = c.in;
  if (i < c.n.B) {
    float cap[4], load[4];
    row4(in.capacity, i, cap);
    row4(in.broker_load, i, load);
    const bool single = !in.host_multi[in.broker_host[i]];
    c.out.old_broker[i] = broker_terms<BF16>(c.p, in.g, cap, in.alive[i], single, load,
                                             in.rcount[i], in.lcount[i], in.pot[i], in.lbin[i]);
  } else if (i < c.n.B + c.n.H) {
    const int h = i - c.n.B;
    float hl[4], hc[4];
    row4(in.host_load, h, hl);
    row4(in.host_cap, h, hc);
    c.out.old_host[h] = host_terms(c.p, in.host_multi[h], hl, hc);
  } else if (i == c.n.B + c.n.H) {
    c.out.old_tie[0] = tie_term(c.p, in.g + G_PCT_SUM, in.g + G_PCT_SUMSQ);
  }
}

// ---------------------------------------------------------------------------
// per-candidate pieces
// ---------------------------------------------------------------------------

// Source replica i of n (_sample_sources): the last n_imp by the plan's
// two-stage draw (broker by upper-bound search of the CDF, then a slot of
// its replica group), the rest uniform over the valid prefix.
__device__ int sample_source(const Ctx& c, const Key2* ks, int i, int n, int n_imp,
                             const float* cdf) {
  const int n_uni = n - n_imp;
  if (i < n_uni) return cc_uniform_idx(unit(ks[0], i), c.n.n_source);
  const int ii = i - n_uni;
  const float u = unit(ks[1], ii);
  // torch.searchsorted(right=True): the first index whose value is > u
  int lo = 0, hi = c.n.B;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(cdf[mid] > u)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int bsel = max(0, min(lo, c.n.n_brokers - 1));
  const int cnt = c.in.count[bsel];
  const int j = __float2int_rz(__fmul_rn(unit(ks[2], ii), (float)cnt));
  const int slot = max(0, min(c.in.start[bsel] + j, c.n.R - 1));
  const int fallback = cc_uniform_idx(unit(ks[3], ii), c.n.n_source);
  return cnt > 0 ? c.in.order[slot] : fallback;
}

// Does a replica of partition `part` (other than padding) sit on broker b?
__device__ bool member_on(const Ctx& c, int part, int b) {
  const int* m = c.in.part_replicas + (size_t)part * c.n.max_rf;
  bool hit = false;
  for (int k = 0; k < c.n.max_rf; ++k) {
    const int id = m[k];
    const int v = id < c.n.R ? c.in.replica_broker[min(id, c.n.R - 1)] : -1;
    hit = hit || v == b;
  }
  return hit;
}

// A topic cell's violation: its count's distance outside [lower, upper].
__device__ __forceinline__ float cell_topic(float cnt, float upper, float lower) {
  return cc_relu(cnt - upper) + cc_relu(lower - cnt);
}

// Topic-distribution cell change of one replica of topic t moving b_from -> b_to.
__device__ float topic_cell_delta(const Ctx& c, int t, int b_from, int b_to) {
  const float avg = c.in.topic_avg[t];
  const float upper = ceilf(avg * c.s.topic_tt);
  const float lower = floorf(avg * c.s.topic_tt_low);
  const float ct_f = (float)c.in.topic_count[(size_t)t * c.n.B + b_from];
  const float ct_t = (float)c.in.topic_count[(size_t)t * c.n.B + b_to];
  return (cell_topic(ct_f - 1.0f, upper, lower) - cell_topic(ct_f, upper, lower)) +
         (cell_topic(ct_t + 1.0f, upper, lower) - cell_topic(ct_t, upper, lower));
}

// Rack-cell change of one replica of partition `part` moving rack_from -> rack_to.
__device__ float rack_delta(const Ctx& c, int part, int rack_from, int rack_to) {
  const int* row = c.in.part_rack_count + (size_t)part * c.n.racks;
  const float c_f = (float)row[rack_from];
  const float c_t = (float)row[rack_to];
  const float d = (cc_relu(c_f - 2.0f) - cc_relu(c_f - 1.0f)) + (cc_relu(c_t) - cc_relu(c_t - 1.0f));
  return rack_from != rack_to ? d : 0.0f;
}

// The disk-load sum of broker b's logdirs in disk order.
__device__ __forceinline__ float disk_sum(const Ctx& c, int b) {
  const float* row = c.in.disk_load + (size_t)b * c.n.D;
  float s = 0.0f;
  for (int d = 0; d < c.n.D; ++d) s = d == 0 ? row[d] : s + row[d];
  return s;
}

// disk_terms() of broker b's logdir row edited by m.
__device__ __forceinline__ float broker_disk_terms(const Ctx& c, int b, const DiskEdit& m,
                                                   float bsum) {
  const size_t o = (size_t)b * c.n.D;
  return disk_terms(c.p, c.in.g[G_TOTAL_DISK_LOAD], c.n.D, c.in.disk_load + o,
                    c.in.disk_capacity + o, c.in.disk_alive + o, c.in.alive[b], m, bsum);
}

// move_delta_plain's intra-broker disk block: src's row less ddisk_src at
// d_src and dst's row plus ddisk at d_dst, against both as they are.
__device__ float disk_move_delta(const Ctx& c, int s, int d, int d_src, int d_dst,
                                 float ddisk_src, float ddisk) {
  const float bsum_s = disk_sum(c, s), bsum_d = disk_sum(c, d);
  const DiskEdit none{0, 0, 0, 0.0f};
  const float td0 = broker_disk_terms(c, s, DiskEdit{1, d_src, 0, ddisk_src}, bsum_s - ddisk_src);
  const float td1 = broker_disk_terms(c, s, none, bsum_s);
  const float td2 = broker_disk_terms(c, d, DiskEdit{2, d_dst, 0, ddisk}, bsum_d + ddisk);
  const float td3 = broker_disk_terms(c, d, none, bsum_d);
  return ((td0 - td1) + td2) - td3;
}

// move_delta_plain: the two new broker lanes against the prologue's old
// ones, the host terms, the intra-broker disk terms (DISK: the chain
// weighs them), the tiebreak.
template <bool DISK, bool BF16>
__device__ float move_delta_core(const Ctx& c, int s, int d, const float dls[4],
                                 const float dld[4], int dc, int dlc, float dp, float dlbin,
                                 float dlbin_src, int d_src, int d_dst, float ddisk_src,
                                 float ddisk) {
  const CandInputs& in = c.in;
  float ls[4], ld[4], ls2[4], ld2[4], cap_s[4], cap_d[4];
  row4(in.broker_load, s, ls);
  row4(in.broker_load, d, ld);
  row4(in.capacity, s, cap_s);
  row4(in.capacity, d, cap_d);
  for (int r = 0; r < 4; ++r) {
    ls2[r] = ls[r] + dls[r];
    ld2[r] = ld[r] + dld[r];
  }
  const bool a_s = in.alive[s], a_d = in.alive[d];
  const int h_s = in.broker_host[s], h_d = in.broker_host[d];
  const bool m_s = in.host_multi[h_s], m_d = in.host_multi[h_d];
  const float t0 = c.out.old_broker[s];
  const float t1 = c.out.old_broker[d];
  const float t2 = broker_terms<BF16>(c.p, in.g, cap_s, a_s, !m_s, ls2, in.rcount[s] - dc,
                                      in.lcount[s] - dlc, in.pot[s] - dp, in.lbin[s] - dlbin_src);
  const float t3 = broker_terms<BF16>(c.p, in.g, cap_d, a_d, !m_d, ld2, in.rcount[d] + dc,
                                      in.lcount[d] + dlc, in.pot[d] + dp, in.lbin[d] + dlbin);
  float delta = (t2 + t3) - (t0 + t1);

  // host-granularity capacity (same-host moves cancel)
  if (h_s != h_d) {
    float hl_s[4], hl_d[4], hc_s[4], hc_d[4];
    row4(in.host_load, h_s, hl_s);
    row4(in.host_load, h_d, hl_d);
    row4(in.host_cap, h_s, hc_s);
    row4(in.host_cap, h_d, hc_d);
    for (int r = 0; r < 4; ++r) {
      hl_s[r] = hl_s[r] + dls[r];
      hl_d[r] = hl_d[r] + dld[r];
    }
    const float th0 = host_terms(c.p, m_s, hl_s, hc_s);
    const float th2 = host_terms(c.p, m_d, hl_d, hc_d);
    delta = delta + (((th0 - c.out.old_host[h_s]) + th2) - c.out.old_host[h_d]);
  } else {
    delta = delta + 0.0f;
  }

  if (DISK) delta = delta + disk_move_delta(c, s, d, d_src, d_dst, ddisk_src, ddisk);

  // dispersion tiebreaker via sufficient statistics
  const float as = f01(a_s), ad = f01(a_d);
  float s_new[4], sq_new[4];
  for (int r = 0; r < 4; ++r) {
    const float cs = cap_s[r] + 1e-12f, cd = cap_d[r] + 1e-12f;
    const float p_s = ls[r] / cs, p_d = ld[r] / cd;
    const float p_s2 = ls2[r] / cs, p_d2 = ld2[r] / cd;
    const float dsum = as * (p_s2 - p_s) + ad * (p_d2 - p_d);
    const float dsumsq = as * (p_s2 * p_s2 - p_s * p_s) + ad * (p_d2 * p_d2 - p_d * p_d);
    s_new[r] = in.g[G_PCT_SUM + r] + dsum;
    sq_new[r] = in.g[G_PCT_SUMSQ + r] + dsumsq;
  }
  return delta + (tie_term(c.p, s_new, sq_new) - c.out.old_tie[0]);
}

__device__ __forceinline__ bool disk_ok(const Ctx& c, int b, int disk) {
  return c.in.disk_alive[(size_t)b * c.n.D + disk];
}

// The bundle entry of candidate k (index in the concatenated K) with its
// Metropolis acceptance: delta < -T log u - 1e-12, u drawn with minval 1e-12.
__device__ void put_candidate(const Ctx& c, int k, float delta, bool feas, int src, int dst,
                              int part1, int part2) {
  const float u = cc_uniform_in(unit(keys(c).u, k), c.s.u_min, c.s.u_span);
  const float thresh = __fmul_rn(-*c.in.temperature, logf(u));
  c.out.delta[k] = delta;
  c.out.feas[k] = feas;
  c.out.accept[k] = feas && (delta < __fsub_rn(thresh, 1e-12f));
  c.out.src[k] = src;
  c.out.dst[k] = dst;
  c.out.part1[k] = part1;
  c.out.part2[k] = part2;
}

// One relocation payload row.
__device__ void put_rel_row(const Ctx& c, int row, int r, int src, int dst, int d_src, int d_dst,
                            const float load[4], bool is_lead, float pot, float lbin, int topic,
                            int part) {
  const CandOutputs& o = c.out;
  o.r[row] = r;
  o.r_src[row] = src;
  o.r_dst[row] = dst;
  o.d_src[row] = d_src;
  o.d_dst[row] = d_dst;
  put4(o.load, row, load);
  o.is_lead[row] = is_lead;
  o.pot[row] = pot;
  o.lbin[row] = lbin;
  o.topic[row] = topic;
  o.part[row] = part;
}

// The load a replica moves with: its leader or follower row, 0 when invalid.
__device__ __forceinline__ void replica_load(const Ctx& c, int r, bool lead, bool valid,
                                             float out[4]) {
  row4(lead ? c.in.load_leader : c.in.load_follower, r, out);
  if (!valid) {
    for (int k = 0; k < 4; ++k) out[k] = 0.0f;
  }
}

// The prior branch of relocation i's destination draw (`_sample_dests`):
// where the mix draw falls below prior_mix, the upper bound of the CDF draw
// in topic t's prior CDF over the first n_dest positions, clamped to
// n_dest - 1; else the uniform position `uni`.  Writes the lane's
// took-the-prior flag.
__device__ int prior_dest(const Ctx& c, int i, int t, int uni) {
  const size_t row = (size_t)(*c.in.rnd) * c.n.steps_per_round + c.n.step;
  const bool use = unit(c.in.prior_keys[2 * row], i) < *c.in.prior_mix;
  c.out.from_prior[i] = use;
  if (!use) return uni;
  const float u = unit(c.in.prior_keys[2 * row + 1], i);
  const float* cdf = c.in.prior_cdf + (size_t)t * c.n.B;
  // the number of entries <= u: the first index whose value is > u
  int lo = 0, hi = c.n.n_dest;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (cdf[mid] <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min(lo, c.n.n_dest - 1);
}

template <bool DISK, bool PRIOR, bool BF16>
__device__ void cand_relocation(const Ctx& c, int i, const float* cdf) {
  const CandInputs& in = c.in;
  const int r = sample_source(c, keys(c).rel_src, i, c.n.K_r, c.n.n_imp_r, cdf);
  int pos = cc_uniform_idx(unit(keys(c).rel_dst, i), c.n.n_dest);
  if (PRIOR) pos = prior_dest(c, i, in.topic_of[r], pos);
  const int dst = in.dest_ids[pos];
  const int src = in.replica_broker[r];
  const int part = in.part_of[r];
  const int disk = in.replica_disk[r];
  const int topic = in.topic_of[r];
  const bool valid = in.valid[r];
  const bool is_lead = in.replica_is_leader[r];
  float ll[4];
  row4(in.load_leader, r, ll);

  const bool offline = !(in.broker_alive[src] && disk_ok(c, src, disk));
  const bool movable = in.topic_movable[topic] || offline;
  const bool feas = valid && movable && src != dst && !member_on(c, part, dst);

  float load[4];
  replica_load(c, r, is_lead, valid, load);

  // destination logdir: most-free alive disk on dst, first on ties (argmin)
  int d_dst = 0;
  float best = 0.0f;
  for (int d = 0; d < c.n.D; ++d) {
    const size_t a = (size_t)dst * c.n.D + d;
    const float v = in.disk_alive[a] ? in.disk_load[a] / (in.disk_capacity[a] + 1e-12f)
                                    : __int_as_float(0x7f800000);  // +inf
    if (d == 0 || (!(best != best) && (v < best || v != v))) {
      best = v;
      d_dst = d;
    }
  }

  const float pot = ll[2];
  const float lbin = is_lead ? ll[1] : 0.0f;
  float dls[4];
  for (int k = 0; k < 4; ++k) dls[k] = -load[k];
  float delta = move_delta_core<DISK, BF16>(c, src, dst, dls, load, 1, is_lead ? 1 : 0, pot, lbin,
                                            lbin, disk, d_dst, load[3], load[3]);

  const int rack_s = in.broker_rack[src], rack_d = in.broker_rack[dst];
  delta = delta + (c.s.w_rack * rack_delta(c, part, rack_s, rack_d)) / c.p.n_valid;
  if (c.n.has_topic) {
    delta = delta + (c.s.w_topic * topic_cell_delta(c, topic, src, dst)) / in.g[G_TOTAL_COUNT];
  }
  const bool dst_ok = in.broker_alive[dst] && disk_ok(c, dst, d_dst);
  delta = delta + (c.s.w_offline * (f01(!dst_ok) - f01(offline))) / c.p.n_valid;
  if (c.n.has_pref) {
    const bool pref = in.pos[r] == 0 && valid && !is_lead;
    const bool was = pref && !offline;
    const bool now = pref && dst_ok;
    delta = delta + (c.s.w_pref * (f01(now) - f01(was))) / c.s.num_parts;
  }
  if (c.n.price_r) {
    const int orig = in.orig_broker[r];
    delta = delta + in.replica_cost[0] * (f01(dst != orig) - f01(src != orig));
  }
  put_candidate(c, i, delta, feas, src, dst, part, part);
  put_rel_row(c, i, r, src, dst, disk, d_dst, load, is_lead, pot, lbin, topic, part);
}

// An intra-broker disk move (`_intra_disk_candidates`): replica r to the
// most-free other alive logdir of its own broker b.
template <bool DISK>
__device__ void cand_intra(const Ctx& c, int i, const float* cdf) {
  const CandInputs& in = c.in;
  const int r = sample_source(c, keys(c).rel_src, i, c.n.K_r, c.n.n_imp_r, cdf);
  const int b = in.replica_broker[r];
  const int part = in.part_of[r];
  const int d_src = in.replica_disk[r];
  const int topic = in.topic_of[r];
  const bool valid = in.valid[r];
  const bool is_lead = in.replica_is_leader[r];
  float ll[4];
  row4(in.load_leader, r, ll);

  // destination logdir: most-free alive disk on b, the current slot
  // excluded, first on ties (argmin); all excluded gives 0
  int d_dst = 0;
  float best = 0.0f;
  for (int d = 0; d < c.n.D; ++d) {
    const size_t a = (size_t)b * c.n.D + d;
    const float v = (d != d_src && in.disk_alive[a])
                        ? in.disk_load[a] / (in.disk_capacity[a] + 1e-12f)
                        : __int_as_float(0x7f800000);  // +inf
    if (d == 0 || (!(best != best) && (v < best || v != v))) {
      best = v;
      d_dst = d;
    }
  }

  const bool off_src = !(in.broker_alive[b] && disk_ok(c, b, d_src));
  const bool movable = in.topic_movable[topic] || off_src;
  const bool dst_ok = in.broker_alive[b] && disk_ok(c, b, d_dst);
  const bool feas = valid && movable && dst_ok && d_dst != d_src;

  float load[4];
  replica_load(c, r, is_lead, valid, load);
  // one broker, one row reshuffled
  float delta = 0.0f;
  if (DISK) {
    const float bsum = disk_sum(c, b);
    delta = broker_disk_terms(c, b, DiskEdit{3, d_dst, d_src, load[3]}, bsum) -
            broker_disk_terms(c, b, DiskEdit{0, 0, 0, 0.0f}, bsum);
  }
  delta = delta + (c.s.w_offline * (f01(!dst_ok) - f01(off_src))) / c.p.n_valid;
  if (c.n.price_r) {
    const int orig = in.orig_disk[r];
    delta = delta + in.replica_cost[0] * (f01(d_dst != orig) - f01(d_src != orig));
  }
  put_candidate(c, i, delta, feas, b, b, part, part);
  put_rel_row(c, i, r, b, b, d_src, d_dst, load, is_lead, ll[2], is_lead ? ll[1] : 0.0f, topic,
              part);
}

template <bool DISK, bool BF16>
__device__ void cand_swap(const Ctx& c, int i, const float* cdf) {
  const CandInputs& in = c.in;
  const int r = sample_source(c, keys(c).swap_src, i, c.n.K_s, c.n.n_imp_s, cdf);
  const int q = cc_uniform_idx(unit(keys(c).swap_q, i), c.n.n_source);
  const int src = in.replica_broker[r], dst = in.replica_broker[q];
  const int part_r = in.part_of[r], part_q = in.part_of[q];
  const int d_r = in.replica_disk[r], d_q = in.replica_disk[q];
  const int topic_r = in.topic_of[r], topic_q = in.topic_of[q];
  const bool valid_r = in.valid[r], valid_q = in.valid[q];
  const bool lead_r = in.replica_is_leader[r], lead_q = in.replica_is_leader[q];
  float ll_r[4], ll_q[4];
  row4(in.load_leader, r, ll_r);
  row4(in.load_leader, q, ll_q);

  const bool off_r = !(in.broker_alive[src] && disk_ok(c, src, d_r));
  const bool off_q = !(in.broker_alive[dst] && disk_ok(c, dst, d_q));
  const bool movable_r = in.topic_movable[topic_r] || off_r;
  const bool movable_q = in.topic_movable[topic_q] || off_q;
  const bool feas = valid_r && valid_q && movable_r && movable_q && src != dst &&
                    part_r != part_q && in.dest_ok[src] && in.dest_ok[dst] &&
                    disk_ok(c, dst, d_q) && disk_ok(c, src, d_r) && !member_on(c, part_r, dst) &&
                    !member_on(c, part_q, src);

  float load_r[4], load_q[4], dls[4], dld[4];
  replica_load(c, r, lead_r, valid_r, load_r);
  replica_load(c, q, lead_q, valid_q, load_q);
  for (int k = 0; k < 4; ++k) {
    dls[k] = load_q[k] - load_r[k];
    dld[k] = load_r[k] - load_q[k];
  }
  const float pot_r = ll_r[2], pot_q = ll_q[2];
  const float lbin_r = lead_r ? ll_r[1] : 0.0f;
  const float lbin_q = lead_q ? ll_q[1] : 0.0f;
  const float dlbin = lbin_r - lbin_q;
  const float ddisk = load_r[3] - load_q[3];
  float delta = move_delta_core<DISK, BF16>(c, src, dst, dls, dld, 0, (int)lead_r - (int)lead_q,
                                            pot_r - pot_q, dlbin, dlbin, d_r, d_q, ddisk, ddisk);

  const int rack_s = in.broker_rack[src], rack_d = in.broker_rack[dst];
  delta = delta + (c.s.w_rack * (rack_delta(c, part_r, rack_s, rack_d) +
                                 rack_delta(c, part_q, rack_d, rack_s))) / c.p.n_valid;
  if (c.n.has_topic) {
    delta = delta + (c.s.w_topic * (topic_cell_delta(c, topic_r, src, dst) +
                                    topic_cell_delta(c, topic_q, dst, src))) / in.g[G_TOTAL_COUNT];
  }
  const bool r_ok = in.broker_alive[dst] && disk_ok(c, dst, d_q);
  const bool q_ok = in.broker_alive[src] && disk_ok(c, src, d_r);
  const float doff = ((f01(!r_ok) - f01(off_r)) + f01(!q_ok)) - f01(off_q);
  delta = delta + (c.s.w_offline * doff) / c.p.n_valid;
  if (c.n.has_pref) {
    const bool pref_r = in.pos[r] == 0 && valid_r && !lead_r;
    const bool pref_q = in.pos[q] == 0 && valid_q && !lead_q;
    const float pd_r = f01(pref_r && r_ok) - f01(pref_r && !off_r);
    const float pd_q = f01(pref_q && q_ok) - f01(pref_q && !off_q);
    delta = delta + (c.s.w_pref * (pd_r + pd_q)) / c.s.num_parts;
  }
  if (c.n.price_r) {
    const int orig_r = in.orig_broker[r], orig_q = in.orig_broker[q];
    const float stray = ((f01(dst != orig_r) - f01(src != orig_r)) + f01(src != orig_q)) -
                        f01(dst != orig_q);
    delta = delta + in.replica_cost[0] * stray;
  }
  put_candidate(c, c.n.K_r + i, delta, feas, src, dst, part_r, part_q);
  // r -> (dst, q's disk slot), q -> (src, r's disk slot)
  put_rel_row(c, c.n.K_r + i, r, src, dst, d_r, d_q, load_r, lead_r, pot_r, lbin_r, topic_r,
              part_r);
  put_rel_row(c, c.n.K_r + c.n.K_s + i, q, dst, src, d_q, d_r, load_q, lead_q, pot_q, lbin_q,
              topic_q, part_q);
}

template <bool DISK, bool BF16>
__device__ void cand_leadership(const Ctx& c, int i) {
  const CandInputs& in = c.in;
  const int R = c.n.R;
  const int rt = cc_uniform_idx(unit(keys(c).lead, i), c.n.n_source);
  const int part = in.part_of[rt];
  // the partition's first leader (argmax of the member leader flags)
  const int* m = in.part_replicas + (size_t)part * c.n.max_rf;
  int first = -1;
  for (int k = 0; k < c.n.max_rf; ++k) {
    const int id = m[k];
    if (first < 0 && id < R && in.replica_is_leader[min(id, R - 1)]) first = k;
  }
  const int rf = min(m[first < 0 ? 0 : first], R - 1);

  const int src = in.replica_broker[rf], dst = in.replica_broker[rt];
  const int disk_f = in.replica_disk[rf], disk_t = in.replica_disk[rt];
  const bool dst_ok = in.broker_alive[dst] && disk_ok(c, dst, disk_t);
  const bool feas = in.valid[rt] && !in.replica_is_leader[rt] && first >= 0 && dst_ok &&
                    in.lead_ok[dst];

  // load shift: rf leader->follower on src, rt follower->leader on dst
  float ll_f[4], ll_t[4], lf_f[4], lf_t[4], dl_f[4], dl_t[4];
  row4(in.load_leader, rf, ll_f);
  row4(in.load_leader, rt, ll_t);
  row4(in.load_follower, rf, lf_f);
  row4(in.load_follower, rt, lf_t);
  for (int k = 0; k < 4; ++k) {
    dl_f[k] = lf_f[k] - ll_f[k];
    dl_t[k] = ll_t[k] - lf_t[k];
  }
  const float dlbin = ll_t[1], dlbin_src = ll_f[1];
  float delta = move_delta_core<DISK, BF16>(c, src, dst, dl_f, dl_t, 0, 1, 0.0f, dlbin, dlbin_src,
                                            disk_f, disk_t, dl_f[3], dl_t[3]);

  if (c.n.has_pref) {
    const bool src_ok = in.broker_alive[src] && disk_ok(c, src, disk_f);
    const bool pref_f = in.pos[rf] == 0 && src_ok;
    const bool pref_t = in.pos[rt] == 0 && dst_ok;
    delta = delta + (c.s.w_pref * (f01(pref_f) - f01(pref_t))) / c.s.num_parts;
  }
  if (c.n.price_l) {
    delta = delta + in.lead_cost[0] * (f01(!in.orig_lead[rt]) - f01(!in.orig_lead[rf]));
  }
  put_candidate(c, c.n.K_r + c.n.K_s + i, delta, feas, src, dst, part, part);
  const CandOutputs& o = c.out;
  o.rf[i] = rf;
  o.rt[i] = rt;
  o.src_b[i] = src;
  o.dst_b[i] = dst;
  put4(o.dl_f, i, dl_f);
  put4(o.dl_t, i, dl_t);
  o.dlbin_src[i] = dlbin_src;
  o.dlbin_dst[i] = dlbin;
  o.d_f[i] = disk_f;
  o.d_t[i] = disk_t;
}

// ---------------------------------------------------------------------------
// the candidate launch: blocks [0, nb_r) relocations, then swaps, then
// leadership transfers
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;

// DISK: the chain weighs the intra-broker disk goals; INTRA: the K_r lanes
// are intra-broker disk moves; PRIOR: relocation destinations mixed from
// the learned prior; BF16: the broker terms summed in bf16.  Each is a
// compile-time branch, so a chain without the disk goals, the prior or
// bf16 runs the lanes it ran before them.
template <bool DISK, bool INTRA, bool PRIOR, bool BF16>
__global__ void __launch_bounds__(kThreads) candidates_kernel(Ctx c) {
  extern __shared__ float s_cdf[];
  const int nb_r = (c.n.K_r + kThreads - 1) / kThreads;
  const int nb_s = (c.n.K_s + kThreads - 1) / kThreads;
  int b = blockIdx.x;
  int kind, n, n_imp;
  if (b < nb_r) {
    kind = 0, n = c.n.K_r, n_imp = c.n.n_imp_r;
  } else if (b < nb_r + nb_s) {
    kind = 1, n = c.n.K_s, n_imp = c.n.n_imp_s, b -= nb_r;
  } else {
    kind = 2, n = c.n.K_l, n_imp = 0, b -= nb_r + nb_s;
  }
  const int i = b * kThreads + threadIdx.x;
  // blocks holding importance-sampled sources stage the CDF (block-uniform)
  const float* cdf = c.in.cdf;
  const bool imp = kind < 2 && n_imp > 0 && (b + 1) * kThreads > n - n_imp;
  if (imp && c.n.cdf_in_smem) {
    for (int j = threadIdx.x; j < c.n.B; j += kThreads) s_cdf[j] = c.in.cdf[j];
    __syncthreads();
    cdf = s_cdf;
  }
  if (i >= n) return;
  if (INTRA) {
    cand_intra<DISK>(c, i, cdf);  // K_s = K_l = 0: every lane is an intra move
  } else if (kind == 0) {
    cand_relocation<DISK, PRIOR, BF16>(c, i, cdf);
  } else if (kind == 1) {
    cand_swap<DISK, BF16>(c, i, cdf);
  } else {
    cand_leadership<DISK, BF16>(c, i);
  }
}

template <bool DISK, bool INTRA, bool PRIOR, bool BF16>
static cudaError_t launch_candidates(const Ctx& c, cudaStream_t st) {
  const size_t smem = c.n.cdf_in_smem ? sizeof(float) * (size_t)c.n.B : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(candidates_kernel<DISK, INTRA, PRIOR, BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned int blocks = cc_blocks(c.n.K_r, kThreads) + cc_blocks(c.n.K_s, kThreads) +
                              cc_blocks(c.n.K_l, kThreads);
  candidates_kernel<DISK, INTRA, PRIOR, BF16><<<blocks, kThreads, smem, st>>>(c);
  return cudaGetLastError();
}

// The inter-broker instantiations, by the run-time flags.
template <bool DISK, bool PRIOR>
static cudaError_t launch_bf16(const Ctx& c, cudaStream_t st) {
  return c.n.bf16 ? launch_candidates<DISK, false, PRIOR, true>(c, st)
                  : launch_candidates<DISK, false, PRIOR, false>(c, st);
}

template <bool DISK>
static cudaError_t launch_inter(const Ctx& c, cudaStream_t st) {
  return c.n.prior ? launch_bf16<DISK, true>(c, st) : launch_bf16<DISK, false>(c, st);
}

CC_EXPORT int cc_candidates(CandDims n, MDParams p, CandScalars s, CandInputs in, CandOutputs out,
                            void* stream) {
  const long long K = (long long)n.K_r + n.K_s + n.K_l;
  if (K <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n.intra && (n.K_s > 0 || n.K_l > 0 || n.prior)) return (int)cudaErrorInvalidValue;
  if (n.prior && (in.prior_keys == nullptr || in.prior_cdf == nullptr || in.prior_mix == nullptr ||
                  out.from_prior == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Ctx c{n, p, s, in, out};
  if (!n.intra) {
    // no intra lane reads the old broker, host or tie terms
    const int pro = n.B + n.H + 1;
    if (n.bf16) {
      candidates_prologue_kernel<true><<<cc_blocks(pro, 256), 256, 0, st>>>(c);
    } else {
      candidates_prologue_kernel<false><<<cc_blocks(pro, 256), 256, 0, st>>>(c);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (n.intra) {
    // no intra lane reads a broker term: the bf16 flag changes nothing there
    return (int)(p.has_disk ? launch_candidates<true, true, false, false>(c, st)
                            : launch_candidates<false, true, false, false>(c, st));
  }
  return (int)(p.has_disk ? launch_inter<true>(c, st) : launch_inter<false>(c, st));
}
