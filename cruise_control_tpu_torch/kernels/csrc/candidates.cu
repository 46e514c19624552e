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
// What bounds it on this card: the latency of each candidate's chain, not
// bytes or operations.  The bytes a north-star step needs (K = 16,384:
// replica rows, member rows, src/dst broker, host and disk rows, CDF
// probes, ~22 B of bundle and a 53/64 B payload row each) are ~3.2 MB,
// 0.00095 ms of HBM time; the ALU work is ~600 operations a candidate,
// ~0.15 us at the f32 rate.  The chain is 5 dependent global loads deep
// for a uniformly drawn relocation (round index -> key row -> replica
// row -> its broker rows, member ids and cells' operands -> host rows,
// the members' brokers, the rack cells), 7 for an importance-sampled one
// (the plan's count/start and order after ~12 shared-memory CDF probes),
// 12 L2 probes of the topic's prior CDF more under the prior; after them
// come ~50 IEEE divisions and 8 square roots.  On an H100 the 512 swaps
// alone, one warp an SM, take ~70% of the whole launch's time
// (scripts/time_candidates.py): the chain's latency sets the time, ~11x
// the byte bound, and the other warps mostly fill its stalls.  One thread
// a candidate (the design before this one) gave K = 16,384 threads, ~4
// warps an SM, and one lane's stalls had no other warp to hide behind.
// So a candidate is a team of lanes of one warp, with fixed roles that
// run ONE instruction stream on different data (a role that ran code of
// its own would only serialise the warp), and each candidate issues a
// round's loads together before it uses any of them:
//  - Draws: the team's lanes hash different (key, counter) pairs in the
//    same code, one pair a lane and round (threefry, common.cuh): source,
//    slot, fallback and destination, then the Metropolis u and the prior's
//    two; the values reach every lane by shuffles.  The counter of uniform
//    draw i under a key is i, as in the `uniform(key, n)` call it replaces;
//    the importance branch uses i - (n - n_imp), the Metropolis u the
//    candidate's index in K.  Keys come from the run's key table at the
//    device-side round index, so a captured step replays with the keys of
//    the round it runs in.
//  - Member scans: one member slot a lane, OR-ed by a ballot.
//  - move_delta_core: lane 0 scores src after the move, lane 1 dst after,
//    lane 2 src before, lane 3 dst before, with the same broker_terms and
//    host_terms (and, under DISK, the four logdir rows of
//    disk_move_delta); lane r scores resource r of the dispersion
//    tiebreak before and after.  The old-state terms are computed here on
//    lanes that the new ones leave free, from the same inputs as the old
//    prologue launch computed them per broker, so the step needs no
//    second launch.  Every lane combines the partials, fetched by
//    shuffles, in the order of the single-lane expression tree
//    ((t2 + t3) - (t0 + t1), then the host terms, disk, tie, rack, topic,
//    offline, preferred and price terms); -fmad=false rounds each
//    operation on its own, so a partial has the same bits on any lane and
//    so does the sum.
//  - The terms after move_delta_core (rack, topic, offline, preferred
//    leader): one division a lane, added in the expression's order.
//  - Stores: the team's lanes store different fields of the bundle and
//    payload row in one instruction (pointer and value picked by lane).
// A relocation, leadership transfer or intra move has a team of 4 lanes,
// a swap (two replicas' rows, member scans, rack and topic cells) of 8:
// lanes 0-3 take r's side, 4-7 q's.  K = 16,384 is 16 warps an SM.
//  - The broker CDF (B floats, 10.4 KB at B = 2,600): where CandDims says
//    so, the blocks that hold importance-sampled sources stage it in shared
//    memory with asynchronous copies (cp.async) issued before the draws,
//    so the copy overlaps the hashes; else the probes read it from global
//    memory (cached in L1).
//  - The JBOD path: a lane whose move touches logdirs loads the D-wide
//    disk rows (load, capacity, health) of its broker and evaluates the
//    intra-broker disk terms of its row in registers, summing over the
//    logdirs in disk order as the plain version does.  An intra-broker
//    candidate (rebalance_disk) draws no destination broker: it picks the
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
//    same index.  The two draws' keys are a table of their own
//    (`prior_keys`), so the default key table is unchanged.  The team
//    also writes whether it took the prior (`from_prior`, read by the
//    diagnostics' counts in select_survivors).
//  - bf16 scoring (BF16): the broker terms' running sum in bf16
//    (terms.cuh); every other term stays f32.
//  - The model generation's values (GenParams: the source and destination
//    counts, the valid broker count, n_valid, n_alive, the capacity
//    totals and weights) come from the engine's generation block, not the
//    launch's arguments, so one captured step serves every generation of
//    its shape.  Each block stages the 80-byte block in shared memory with
//    asynchronous copies issued first, in a commit group of its own before
//    the CDF's; the draws hash while it lands, and each kind waits for it
//    (`gen_wait`) just before its first use, after the draws.
//  DISK, INTRA, PRIOR and BF16 are template parameters, so each mode
//  compiles apart and the default lanes are the ones without them; the
//  intra kind has no prior and no broker terms, so it has no PRIOR or BF16
//  variant: 10 instantiations of candidates_kernel.
// Tensor cores do not apply (there is no matrix product), and TMA is not
// worth it for scattered row gathers.
#include <cuda_pipeline.h>

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
  // the launch's lanes: per kind, the first global candidate and the lane
  // count (the outputs' sizes); the full-K launch has bases 0 and counts K
  int base_r, base_s, base_l, n_r, n_s, n_l;
  int R, B, P, T, D, H, racks, max_rf;
  int has_plan, has_topic, has_pref, price_r, price_l, cdf_in_smem;
  int intra;  // the K_r lanes are intra-broker disk moves
  int step, steps_per_round;  // this step's row: (*rnd) * steps_per_round + step
  int prior;  // relocation destinations mixed from the learned prior
  int bf16;   // the broker terms summed in bf16
  // the sharded-model mode's body (SHARD): every replica and partition row
  // comes from the assembled bundles (CandInputs sh_*), R and P are the
  // global counts
  int shard;
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
  // the engine's generation block (GenParams, kGenWords words)
  const int* gen;
  // the sharded-model mode's assembled bundles (parallel/model_shard.py),
  // by slot (relocations, swap sources, swap partners, leadership
  // targets): the global replica ids, their rows (kRowWords words), their
  // partitions' rows (max_rf member ids, then racks cells), the members'
  // brokers (relocation and swap slots) and the leadership members' rows
  const int* sh_ids;
  const int* sh_rows;
  const int* sh_parts;
  const int* sh_mb;
  const int* sh_ml;
};

struct CandOutputs {
  float* delta;
  bool* feas;
  bool* accept;
  int* src;
  int* dst;
  int* part1;
  int* part2;
  // relocation rows: n_r relocations, then each swap at n_r + t and n_r + n_s + t (CandDims)
  int* r;
  int* r_src;
  int* r_dst;
  int* d_src;
  int* d_dst;
  float* load;  // [n_r + 2 n_s, 4]
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
  float* dl_f;  // [n_l, 4]
  float* dl_t;  // [n_l, 4]
  float* dlbin_src;
  float* dlbin_dst;
  int* d_f;
  int* d_t;
  // the relocations' took-the-prior mask [n_r] (PRIOR)
  bool* from_prior;
};

struct Ctx {
  CandDims n;
  MDParams p;
  CandScalars s;
  CandInputs in;
  CandOutputs out;
};

constexpr int kThreads = 128;

// The block's copy of the generation block (staged by candidates_kernel).
__shared__ GenParams s_gen;
constexpr int kTeam = 4;      // lanes of a relocation, leadership transfer or intra move
constexpr int kSwapTeam = 8;  // lanes of a swap
constexpr unsigned kFull = 0xffffffffu;

// A candidate's lanes: N consecutive lanes of one warp.  Every lane of the
// warp reaches each shuffle and ballot (no lane returns early), so the
// collectives take the full mask.
template <int N>
struct Team {
  int lane;  // 0 .. N-1
  int base;  // the team's first lane in its warp
  __device__ explicit Team(int tid) : lane(tid & (N - 1)), base((tid & 31) & ~(N - 1)) {}
  // lane j's v, on every lane of the team
  __device__ __forceinline__ float from(float v, int j) const {
    return __shfl_sync(kFull, v, base + j);
  }
  __device__ __forceinline__ int from(int v, int j) const {
    return __shfl_sync(kFull, v, base + j);
  }
  // the lanes [lo, lo + n) of the team where p holds, as bits from lo
  __device__ __forceinline__ unsigned ballot(bool p, int lo, int n) const {
    return (__ballot_sync(kFull, p) >> (base + lo)) & ((1u << n) - 1u);
  }
};

__device__ __forceinline__ const StepKeys& keys(const Ctx& c) {
  return c.in.key_table[(size_t)(*c.in.rnd) * c.n.steps_per_round + c.n.step];
}

__device__ __forceinline__ float f01(bool b) { return b ? 1.0f : 0.0f; }

__device__ __forceinline__ float unit(const Key2* k, unsigned long long i) {
  return cc_unit_float(k->k0, k->k1, i);
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

// v[j] for a lane-dependent j, by selects (no local memory)
__device__ __forceinline__ float pick4(const float v[4], int j) {
  return j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
}

// One store instruction for four fields: lane j of a group of four writes
// v_j to p_j[row] (p_j null: nothing).
template <class T>
__device__ __forceinline__ void put_lanes(int lane, bool on, int row, T* p0, T v0, T* p1, T v1,
                                          T* p2, T v2, T* p3, T v3) {
  T* p = lane == 0 ? p0 : lane == 1 ? p1 : lane == 2 ? p2 : p3;
  const T v = lane == 0 ? v0 : lane == 1 ? v1 : lane == 2 ? v2 : v3;
  if (on && p != nullptr) p[row] = v;
}

// ---------------------------------------------------------------------------
// per-candidate pieces
// ---------------------------------------------------------------------------

// `_sample_sources`' pick of a source from its draws: the uniform draw
// u_src over the valid prefix, or for an importance-sampled source the
// plan's two-stage draw (broker by upper-bound search of the CDF with
// u_src, then a slot of its replica group with u_slot; u_fb's uniform pick
// where the broker holds none).
__device__ int pick_source(const Ctx& c, bool imp, float u_src, float u_slot, float u_fb,
                           const float* cdf) {
  if (!imp) return cc_uniform_idx(u_src, s_gen.n_source);
  // torch.searchsorted(right=True): the first index whose value is > u
  int lo = 0, hi = c.n.B;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(cdf[mid] > u_src)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int bsel = max(0, min(lo, s_gen.n_brokers - 1));
  const int cnt = c.in.count[bsel];
  const int j = __float2int_rz(__fmul_rn(u_slot, (float)cnt));
  const int slot = max(0, min(c.in.start[bsel] + j, c.n.R - 1));
  const int fallback = cc_uniform_idx(u_fb, s_gen.n_source);
  return cnt > 0 ? c.in.order[slot] : fallback;
}

// A lane's draw: its key and counter are picked first and hashed by one
// call, so the team's lanes hash in one instruction stream.
struct Draw {
  const Key2* k;
  unsigned long long i;
};

// The source draws' (key, counter) of team lane 0, 1 or 2: the source (the
// uniform key at i, or the CDF key at ii), the slot, the fallback.
__device__ __forceinline__ Draw source_draw(const Key2* ks, int lane, bool imp, int i, int ii) {
  using u64 = unsigned long long;
  if (lane == 0) return imp ? Draw{&ks[1], (u64)ii} : Draw{&ks[0], (u64)i};
  return Draw{&ks[lane == 1 ? 2 : 3], (u64)ii};
}

__device__ __forceinline__ float draw_u(const Draw& d) { return unit(d.k, d.i); }

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
  return disk_terms(c.p, s_gen, c.in.g[G_TOTAL_DISK_LOAD], c.n.D, c.in.disk_load + o,
                    c.in.disk_capacity + o, c.in.disk_alive + o, c.in.alive[b], m, bsum);
}

__device__ __forceinline__ bool disk_ok(const Ctx& c, int b, int disk) {
  return c.in.disk_alive[(size_t)b * c.n.D + disk];
}

// The rows of the broker a lane of move_delta_core scores: capacity, load,
// liveness (the statics'), host, replica and leader counts, potential
// NW-out, leader bytes-in.
struct BrokerRows {
  float cap[4], load[4];
  int host, rc, lc;
  float pot, lbin;
  bool alive;
};

__device__ __forceinline__ void load_broker(const Ctx& c, int b, BrokerRows& r) {
  const CandInputs& in = c.in;
  row4(in.capacity, b, r.cap);
  row4(in.broker_load, b, r.load);
  r.alive = in.alive[b];
  r.host = in.broker_host[b];
  r.rc = in.rcount[b];
  r.lc = in.lcount[b];
  r.pot = in.pot[b];
  r.lbin = in.lbin[b];
}

// A lane's host rows: whether it holds several brokers, its load and capacity.
struct HostRows {
  float hl[4], hc[4];
  bool multi;
};

__device__ __forceinline__ void load_host(const Ctx& c, int h, HostRows& r) {
  r.multi = c.in.host_multi[h];
  row4(c.in.host_load, h, r.hl);
  row4(c.in.host_cap, h, r.hc);
}

// Resource L of a broker's load and capacity, and its liveness: the
// tiebreak's inputs on lane L.
struct TieCol {
  float load, cap;
  bool alive;
};

__device__ __forceinline__ void load_tie(const Ctx& c, int b, int L, TieCol& t) {
  t.load = c.in.broker_load[4 * (size_t)b + L];
  t.cap = c.in.capacity[4 * (size_t)b + L];
  t.alive = c.in.alive[b];
}

// move_delta_plain of src s -> dst d on the team (roles by lane & 3; a
// swap's lanes 4-7 repeat 0-3), from rows loaded before: `br` and `hr` the
// lane's broker (s on lanes 0 and 2, d on 1 and 3) and its host, `ts` and
// `td` resource L of s and d.  The four broker and host lanes, the
// intra-broker disk terms (DISK: the chain weighs them), the tiebreak one
// resource a lane.  Every lane returns the delta.
template <bool DISK, bool BF16, int N>
__device__ float move_delta_core(const Ctx& c, const Team<N>& tm, const BrokerRows& br,
                                 const HostRows& hr, const TieCol& ts, const TieCol& td, int s,
                                 int d, const float dls[4], const float dld[4], int dc, int dlc,
                                 float dp, float dlbin, float dlbin_src, int d_src, int d_dst,
                                 float ddisk_src, float ddisk) {
  const int L = tm.lane & 3;
  const bool on_s = (L & 1) == 0;  // lanes 0, 2: src; 1, 3: dst
  const bool after = L < 2;        // lanes 0, 1: after the move; 2, 3: as it is
  float load[4], hl[4];
  int rc = br.rc, lc = br.lc;
  float pot = br.pot, lbin = br.lbin;
  for (int r = 0; r < 4; ++r) {
    load[r] = br.load[r];
    hl[r] = hr.hl[r];
  }
  if (after) {
    for (int r = 0; r < 4; ++r) {
      const float x = on_s ? dls[r] : dld[r];
      load[r] = load[r] + x;
      hl[r] = hl[r] + x;
    }
    if (on_s) {
      rc = rc - dc;
      lc = lc - dlc;
      pot = pot - dp;
      lbin = lbin - dlbin_src;
    } else {
      rc = rc + dc;
      lc = lc + dlc;
      pot = pot + dp;
      lbin = lbin + dlbin;
    }
  }
  // t2 = src after, t3 = dst after, t0 = src before, t1 = dst before
  const float t = broker_terms<BF16>(c.p, s_gen, c.in.g, br.cap, br.alive, !hr.multi, load, rc,
                                     lc, pot, lbin);
  float delta = (tm.from(t, 0) + tm.from(t, 1)) - (tm.from(t, 2) + tm.from(t, 3));

  // host-granularity capacity (same-host moves cancel)
  const float th = host_terms(c.p, s_gen, hr.multi, hl, hr.hc);
  const float th0 = tm.from(th, 0), th2 = tm.from(th, 1);
  const float old_s = tm.from(th, 2), old_d = tm.from(th, 3);
  if (tm.from(br.host, 0) != tm.from(br.host, 1)) {
    delta = delta + (((th0 - old_s) + th2) - old_d);
  } else {
    delta = delta + 0.0f;
  }

  if (DISK) {
    // td0 = src after (lane 0), td1 = src before (2), td2 = dst after (1),
    // td3 = dst before (3)
    const int b = on_s ? s : d;
    const float bsum = disk_sum(c, b);
    DiskEdit m{0, 0, 0, 0.0f};
    float arg = bsum;
    if (L == 0) {
      m = DiskEdit{1, d_src, 0, ddisk_src};
      arg = bsum - ddisk_src;
    } else if (L == 1) {
      m = DiskEdit{2, d_dst, 0, ddisk};
      arg = bsum + ddisk;
    }
    const float tdk = broker_disk_terms(c, b, m, arg);
    delta = delta + (((tm.from(tdk, 0) - tm.from(tdk, 2)) + tm.from(tdk, 1)) - tm.from(tdk, 3));
  }

  // dispersion tiebreaker via sufficient statistics, resource L on lane L
  const float cs = ts.cap + 1e-12f, cd = td.cap + 1e-12f;
  const float as = f01(ts.alive), ad = f01(td.alive);
  const float p_s = ts.load / cs, p_d = td.load / cd;
  const float p_s2 = (ts.load + pick4(dls, L)) / cs, p_d2 = (td.load + pick4(dld, L)) / cd;
  const float dsum = as * (p_s2 - p_s) + ad * (p_d2 - p_d);
  const float dsumsq = as * (p_s2 * p_s2 - p_s * p_s) + ad * (p_d2 * p_d2 - p_d * p_d);
  const float s_old = c.in.g[G_PCT_SUM + L], sq_old = c.in.g[G_PCT_SUMSQ + L];
  const float tn = tie_part(s_gen, s_old + dsum, sq_old + dsumsq);
  const float to = tie_part(s_gen, s_old, sq_old);
  const float tie_new =
      c.p.w_tie * (((tm.from(tn, 0) + tm.from(tn, 1)) + tm.from(tn, 2)) + tm.from(tn, 3));
  const float tie_old =
      c.p.w_tie * (((tm.from(to, 0) + tm.from(to, 1)) + tm.from(to, 2)) + tm.from(to, 3));
  return delta + (tie_new - tie_old);
}

// The Metropolis acceptance of candidate k: delta < -T log u - 1e-12, u
// drawn (as u01) with minval 1e-12.
__device__ __forceinline__ bool accepted(const Ctx& c, float u01, float delta, bool feas) {
  const float u = cc_uniform_in(u01, c.s.u_min, c.s.u_span);
  const float thresh = __fmul_rn(-*c.in.temperature, logf(u));
  return feas && (delta < __fsub_rn(thresh, 1e-12f));
}

// The bundle entry of candidate k, by a group of four lanes.
__device__ void put_candidate(const Ctx& c, int L, bool on, int k, float delta, bool feas,
                              bool accept, int src, int dst, int part1, int part2,
                              bool* from_prior, int i_prior, bool took_prior) {
  const CandOutputs& o = c.out;
  put_lanes<int>(L, on, k, o.src, src, o.dst, dst, o.part1, part1, o.part2, part2);
  put_lanes<bool>(L, on, k, (bool*)nullptr, false, o.feas, feas, o.accept, accept, (bool*)nullptr,
                  false);
  if (on && L == 0) c.out.delta[k] = delta;
  if (on && L == 3 && from_prior != nullptr) from_prior[i_prior] = took_prior;
}

// One relocation payload row, by a group of four lanes.
__device__ void put_rel_row(const Ctx& c, int L, bool on, int row, int r, int src, int dst,
                            int d_src, int d_dst, const float load[4], bool is_lead, float pot,
                            float lbin, int topic, int part) {
  const CandOutputs& o = c.out;
  put_lanes<int>(L, on, row, o.r, r, o.r_src, src, o.r_dst, dst, o.d_src, d_src);
  put_lanes<int>(L, on, row, o.d_dst, d_dst, o.topic, topic, o.part, part, (int*)nullptr, 0);
  put_lanes<float>(L, on, row, o.pot, pot, o.lbin, lbin, (float*)nullptr, 0.0f, (float*)nullptr,
                   0.0f);
  if (on && L == 2) put4(o.load, row, load);
  if (on && L == 3) o.is_lead[row] = is_lead;
}

// A replica's row: what the candidate kinds read of it, loaded at once.
struct ReplicaRow {
  float ll[4], lf[4];  // leader and follower load rows
  int broker, part, disk, topic, pos, orig;
  bool valid, lead;
};

__device__ __forceinline__ void load_replica(const Ctx& c, int r, ReplicaRow& x) {
  const CandInputs& in = c.in;
  x.broker = in.replica_broker[r];
  x.part = in.part_of[r];
  x.disk = in.replica_disk[r];
  x.topic = in.topic_of[r];
  x.valid = in.valid[r];
  x.lead = in.replica_is_leader[r];
  x.pos = in.pos[r];
  x.orig = in.orig_broker[r];
  row4(in.load_leader, r, x.ll);
  row4(in.load_follower, r, x.lf);
}

// The load a replica moves with: its leader or follower row, 0 when invalid.
__device__ __forceinline__ void replica_load(const ReplicaRow& x, float out[4]) {
  for (int k = 0; k < 4; ++k) out[k] = x.valid ? (x.lead ? x.ll[k] : x.lf[k]) : 0.0f;
}

// The prior's destination position (`_sample_dests`): the upper bound of
// u in topic t's prior CDF over the first n_dest positions, clamped to
// n_dest - 1.
__device__ int prior_dest(const Ctx& c, int t, float u) {
  const float* cdf = c.in.prior_cdf + (size_t)t * c.n.B;
  // the number of entries <= u: the first index whose value is > u
  int lo = 0, hi = s_gen.n_dest;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (cdf[mid] <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min(lo, s_gen.n_dest - 1);
}

// The most-free alive logdir of broker b (first on ties, argmin), the
// logdir `skip` excluded (-1: none); all excluded gives 0.
__device__ int most_free_disk(const Ctx& c, int b, int skip) {
  const CandInputs& in = c.in;
  if (c.n.D == 1) return 0;  // the loop below picks d = 0 whatever its value
  int d_dst = 0;
  float best = 0.0f;
  for (int d = 0; d < c.n.D; ++d) {
    const size_t a = (size_t)b * c.n.D + d;
    const float v = (d != skip && in.disk_alive[a])
                        ? in.disk_load[a] / (in.disk_capacity[a] + 1e-12f)
                        : __int_as_float(0x7f800000);  // +inf
    if (d == 0 || (!(best != best) && (v < best || v != v))) {
      best = v;
      d_dst = d;
    }
  }
  return d_dst;
}

// Wait for the block's generation block: every commit group but the last
// (the CDF's, empty where the block stages none) has landed.
__device__ __forceinline__ void gen_wait() {
  __pipeline_wait_prior(1);
  __syncthreads();
}

// Wait for the block's staged CDF (block-uniform).
__device__ __forceinline__ void staged_wait(bool staged) {
  if (staged) {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
}

// A topic cell's violation: its count's distance outside [lower, upper].
__device__ __forceinline__ float cell_topic(float cnt, float upper, float lower) {
  return cc_relu(cnt - upper) + cc_relu(lower - cnt);
}

// Topic-distribution cell change of one replica of a topic with average
// `avg` moving from a broker holding cnt_f of its replicas to one holding
// cnt_t.
__device__ float topic_cell_delta(const Ctx& c, float avg, int cnt_f, int cnt_t) {
  const float upper = ceilf(avg * c.s.topic_tt);
  const float lower = floorf(avg * c.s.topic_tt_low);
  const float ct_f = (float)cnt_f;
  const float ct_t = (float)cnt_t;
  return (cell_topic(ct_f - 1.0f, upper, lower) - cell_topic(ct_f, upper, lower)) +
         (cell_topic(ct_t + 1.0f, upper, lower) - cell_topic(ct_t, upper, lower));
}

// Rack-cell change of one replica of a partition moving rack_from ->
// rack_to, whose racks hold cnt_f and cnt_t of its replicas.
__device__ float rack_delta(int rack_from, int rack_to, int cnt_f, int cnt_t) {
  const float c_f = (float)cnt_f;
  const float c_t = (float)cnt_t;
  const float d =
      (cc_relu(c_f - 2.0f) - cc_relu(c_f - 1.0f)) + (cc_relu(c_t) - cc_relu(c_t - 1.0f));
  return rack_from != rack_to ? d : 0.0f;
}

__device__ __forceinline__ int rack_count(const Ctx& c, int part, int rack) {
  return c.in.part_rack_count[(size_t)part * c.n.racks + rack];
}

__device__ __forceinline__ int topic_count(const Ctx& c, int t, int b) {
  return c.in.topic_count[(size_t)t * c.n.B + b];
}

// A replica row of the sharded-model mode's bundles: broker, partition,
// disk, topic, valid, leader, pos, original broker, original leader,
// original disk, then the leader and follower loads' bits
// (kernels/model_shard.py ROW_FIELDS).
constexpr int kRowWords = 18;

__device__ __forceinline__ const int* sh_row(const Ctx& c, int slot) {
  return c.in.sh_rows + (size_t)slot * kRowWords;
}

__device__ __forceinline__ void load_replica_shard(const Ctx& c, int slot, ReplicaRow& x) {
  const int* w = sh_row(c, slot);
  x.broker = w[0];
  x.part = w[1];
  x.disk = w[2];
  x.topic = w[3];
  x.valid = w[4] != 0;
  x.lead = w[5] != 0;
  x.pos = w[6];
  x.orig = w[7];
  for (int k = 0; k < 4; ++k) {
    x.ll[k] = __int_as_float(w[10 + k]);
    x.lf[k] = __int_as_float(w[14 + k]);
  }
}

// A slot's partition row: member `sl` (R past the row), a rack's cell, and
// the member's broker (-1 for padding); a leadership slot's member row.
__device__ __forceinline__ int sh_member(const Ctx& c, int slot, int sl) {
  return sl < c.n.max_rf ? c.in.sh_parts[(size_t)slot * (c.n.max_rf + c.n.racks) + sl] : c.n.R;
}

__device__ __forceinline__ int sh_cell(const Ctx& c, int slot, int rack) {
  return c.in.sh_parts[(size_t)slot * (c.n.max_rf + c.n.racks) + c.n.max_rf + rack];
}

__device__ __forceinline__ int sh_mbroker(const Ctx& c, int slot, int sl) {
  return sh_member(c, slot, sl) < c.n.R ? c.in.sh_mb[(size_t)slot * c.n.max_rf + sl] : -1;
}

__device__ __forceinline__ const int* sh_mrow(const Ctx& c, int i, int sl) {
  return c.in.sh_ml + ((size_t)i * c.n.max_rf + sl) * kRowWords;
}

// Member slot `sl` of partition `part` (R past the row), and the broker of
// a member id (-1 for padding).
__device__ __forceinline__ int member_id(const Ctx& c, int part, int sl) {
  return sl < c.n.max_rf ? c.in.part_replicas[(size_t)part * c.n.max_rf + sl] : c.n.R;
}

__device__ __forceinline__ int member_broker(const Ctx& c, int id) {
  return id < c.n.R ? c.in.replica_broker[min(id, c.n.R - 1)] : -1;
}

// Does a replica of partition `part` (other than padding) sit on broker b?
// Lanes [lo, lo + n) of the team scan one member slot each: slot
// tm.lane - lo's broker v0 was loaded before; further passes take the
// slots past n.
template <int N, bool SHARD = false>
__device__ bool member_on(const Ctx& c, const Team<N>& tm, int part, int b, int lo, int n,
                          int v0, int slot = 0) {
  const int sl = tm.lane - lo;
  bool hit = v0 == b;
  for (int k0 = n; k0 < c.n.max_rf; k0 += n) {
    const int k = k0 + sl;
    if (k < c.n.max_rf) {
      const int mb = SHARD ? sh_mbroker(c, slot, k) : member_broker(c, member_id(c, part, k));
      hit = hit || mb == b;
    }
  }
  return tm.ballot(hit, lo, n) != 0u;
}

// The source replica of draw i from the team's draws (lanes 0-2: source,
// slot, fallback).
template <int N>
__device__ __forceinline__ int team_source(const Ctx& c, const Team<N>& tm, bool imp, float u1,
                                           const float* cdf) {
  return pick_source(c, imp, tm.from(u1, 0), tm.from(u1, 1), tm.from(u1, 2), cdf);
}

// The four terms a move adds after move_delta_core (rack, topic, offline,
// preferred leader): lane j of each group of four divides numerator j by
// denominator j, and every lane gets the four quotients.
template <int N>
__device__ __forceinline__ void lane_quotients(const Team<N>& tm, const float num[4],
                                               const float den[4], float q[4]) {
  const int L = tm.lane & 3;
  const float v = pick4(num, L) / pick4(den, L);
  for (int j = 0; j < 4; ++j) q[j] = tm.from(v, j);
}

// Each candidate loads its rows in rounds, each round's loads issued
// together before any is used: the rows a round's addresses need come
// from the round before (replica row -> broker rows, member ids, rack and
// topic cells' operands -> host rows, member brokers, cells), so the
// chain is as deep as its data dependences and no deeper.
template <bool DISK, bool PRIOR, bool BF16, bool SHARD = false>
__device__ void cand_relocation(const Ctx& c, const Team<kTeam>& tm, int i, int o, bool on,
                                const float* cdf, bool staged) {
  const CandInputs& in = c.in;
  const StepKeys& ks = keys(c);
  const int L = tm.lane;
  const bool on_s = (L & 1) == 0;
  const int n_uni = c.n.K_r - c.n.n_imp_r;
  const bool imp = i >= n_uni;
  const int ii = i - n_uni;
  // draws: (source, slot, fallback, destination), then (Metropolis, the
  // prior's mix and CDF u); a uniform source needs no slot or fallback,
  // so without the prior its Metropolis u takes the slot's lane
  Draw d1 = L == 3 ? Draw{&ks.rel_dst, (unsigned long long)i}
                   : source_draw(ks.rel_src, L, imp, i, ii);
  if (L == 1 && !imp) d1 = Draw{&ks.u, (unsigned long long)i};
  const float u1 = draw_u(d1);
  float u2 = 0.0f;
  if (PRIOR || imp) {
    const size_t krow = (size_t)(*in.rnd) * c.n.steps_per_round + c.n.step;
    const Key2* k2 = &ks.u;
    if (PRIOR && L == 1) k2 = &in.prior_keys[2 * krow];
    if (PRIOR && L == 2) k2 = &in.prior_keys[2 * krow + 1];
    u2 = draw_u(Draw{k2, (unsigned long long)i});
  }
  gen_wait();
  int pos = cc_uniform_idx(tm.from(u1, 3), s_gen.n_dest);
  // without the prior the destination is drawn: its id is in flight
  // while the source is picked
  int dst = PRIOR ? 0 : in.dest_ids[pos];
  staged_wait(staged);
  const float u_acc2 = tm.from(u2, 0), u_acc1 = tm.from(u1, 1);
  const float u_acc = imp ? u_acc2 : u_acc1;
  const int r = SHARD ? in.sh_ids[i] : team_source(c, tm, imp, u1, cdf);
  ReplicaRow x;
  if (SHARD) {
    load_replica_shard(c, i, x);
  } else {
    load_replica(c, r, x);
  }
  const int src = x.broker;
  // the source's round: its broker rows (and the drawn destination's),
  // the member ids, the cells' operands
  BrokerRows br;
  TieCol ts, td;
  if (PRIOR) {
    if (on_s) load_broker(c, src, br);
  } else {
    load_broker(c, on_s ? src : dst, br);
  }
  load_tie(c, src, L, ts);
  const int id0 = SHARD ? sh_member(c, i, L) : member_id(c, x.part, L);
  const bool alive_s = in.broker_alive[src];
  const bool dok_s = disk_ok(c, src, x.disk);
  const bool movable_t = in.topic_movable[x.topic];
  const int rack_s = in.broker_rack[src];
  const float avg = in.topic_avg[x.topic];
  const int cnt_ts = topic_count(c, x.topic, src);
  bool took = false;
  if (PRIOR) {
    const float u_mix = tm.from(u2, 1), u_pr = tm.from(u2, 2);
    took = u_mix < *in.prior_mix;
    if (took) pos = prior_dest(c, x.topic, u_pr);
    dst = in.dest_ids[pos];
  }
  // the destination's round
  if (PRIOR && !on_s) load_broker(c, dst, br);
  load_tie(c, dst, L, td);
  const bool alive_d = in.broker_alive[dst];
  const int rack_d = in.broker_rack[dst];
  const int cnt_td = topic_count(c, x.topic, dst);
  const int d_dst = most_free_disk(c, dst, -1);
  // the last round: host rows, the members' brokers, the rack cells
  HostRows hr;
  load_host(c, br.host, hr);
  const int v0 = SHARD ? sh_mbroker(c, i, L) : member_broker(c, id0);
  const int cnt_rs = SHARD ? sh_cell(c, i, rack_s) : rack_count(c, x.part, rack_s);
  const int cnt_rd = SHARD ? sh_cell(c, i, rack_d) : rack_count(c, x.part, rack_d);
  const bool dok_d = disk_ok(c, dst, d_dst);

  const bool offline = !(alive_s && dok_s);
  const bool movable = movable_t || offline;
  const bool member = member_on<kTeam, SHARD>(c, tm, x.part, dst, 0, kTeam, v0, i);
  const bool feas = x.valid && movable && src != dst && !member;

  float load[4];
  replica_load(x, load);
  const float pot = x.ll[2];
  const float lbin = x.lead ? x.ll[1] : 0.0f;
  float dls[4];
  for (int k = 0; k < 4; ++k) dls[k] = -load[k];
  float delta = move_delta_core<DISK, BF16>(c, tm, br, hr, ts, td, src, dst, dls, load, 1,
                                            x.lead ? 1 : 0, pot, lbin, lbin, x.disk, d_dst,
                                            load[3], load[3]);

  const bool dst_ok = alive_d && dok_d;
  const bool pref = x.pos == 0 && x.valid && !x.lead;
  const bool was = pref && !offline;
  const bool now = pref && dst_ok;
  const float num[4] = {c.s.w_rack * rack_delta(rack_s, rack_d, cnt_rs, cnt_rd),
                        c.s.w_topic * topic_cell_delta(c, avg, cnt_ts, cnt_td),
                        c.s.w_offline * (f01(!dst_ok) - f01(offline)),
                        c.s.w_pref * (f01(now) - f01(was))};
  const float den[4] = {s_gen.n_valid, in.g[G_TOTAL_COUNT], s_gen.n_valid, c.s.num_parts};
  float quo[4];
  lane_quotients(tm, num, den, quo);
  delta = delta + quo[0];
  if (c.n.has_topic) delta = delta + quo[1];
  delta = delta + quo[2];
  if (c.n.has_pref) delta = delta + quo[3];
  if (c.n.price_r) {
    delta = delta + in.replica_cost[0] * (f01(dst != x.orig) - f01(src != x.orig));
  }
  put_candidate(c, L, on, o, delta, feas, accepted(c, u_acc, delta, feas), src, dst, x.part,
                x.part, PRIOR ? c.out.from_prior : nullptr, o, took);
  put_rel_row(c, L, on, o, r, src, dst, x.disk, d_dst, load, x.lead, pot, lbin, x.topic, x.part);
}

// An intra-broker disk move (`_intra_disk_candidates`): replica r to the
// most-free other alive logdir of its own broker b.
template <bool DISK>
__device__ void cand_intra(const Ctx& c, const Team<kTeam>& tm, int i, int o, bool on,
                           const float* cdf, bool staged) {
  const CandInputs& in = c.in;
  const StepKeys& ks = keys(c);
  const int L = tm.lane;
  const int n_uni = c.n.K_r - c.n.n_imp_r;
  const bool imp = i >= n_uni;
  // draws: (source, slot, fallback, Metropolis)
  const float u1 = draw_u(L < 3 ? source_draw(ks.rel_src, L, imp, i, i - n_uni)
                                : Draw{&ks.u, (unsigned long long)i});
  gen_wait();
  staged_wait(staged);
  const int r = team_source(c, tm, imp, u1, cdf);
  const float u_acc = tm.from(u1, 3);
  const int b = in.replica_broker[r];
  const int part = in.part_of[r];
  const int d_src = in.replica_disk[r];
  const int topic = in.topic_of[r];
  const bool valid = in.valid[r];
  const bool is_lead = in.replica_is_leader[r];
  const int orig = in.orig_disk[r];
  float ll[4], lf[4];
  row4(in.load_leader, r, ll);
  row4(in.load_follower, r, lf);
  const bool movable_t = in.topic_movable[topic];
  const bool alive_b = in.broker_alive[b];
  const bool dok_src = disk_ok(c, b, d_src);
  const int d_dst = most_free_disk(c, b, d_src);

  const bool off_src = !(alive_b && dok_src);
  const bool movable = movable_t || off_src;
  const bool dst_ok = alive_b && disk_ok(c, b, d_dst);
  const bool feas = valid && movable && dst_ok && d_dst != d_src;

  float load[4];
  for (int k = 0; k < 4; ++k) load[k] = valid ? (is_lead ? ll[k] : lf[k]) : 0.0f;
  // one broker, one row reshuffled: lane 0 the row after, the others as it is
  float delta = 0.0f;
  if (DISK) {
    const float bsum = disk_sum(c, b);
    const DiskEdit m = L == 0 ? DiskEdit{3, d_dst, d_src, load[3]} : DiskEdit{0, 0, 0, 0.0f};
    const float td = broker_disk_terms(c, b, m, bsum);
    delta = tm.from(td, 0) - tm.from(td, 1);
  }
  delta = delta + (c.s.w_offline * (f01(!dst_ok) - f01(off_src))) / s_gen.n_valid;
  if (c.n.price_r) {
    delta = delta + in.replica_cost[0] * (f01(d_dst != orig) - f01(d_src != orig));
  }
  put_candidate(c, L, on, o, delta, feas, accepted(c, u_acc, delta, feas), b, b, part, part,
                nullptr, 0, false);
  put_rel_row(c, L, on, o, r, b, b, d_src, d_dst, load, is_lead, ll[2], is_lead ? ll[1] : 0.0f,
              topic, part);
}

template <bool DISK, bool BF16, bool SHARD = false>
__device__ void cand_swap(const Ctx& c, const Team<kSwapTeam>& tm, int i, int o, bool on,
                          const float* cdf, bool staged) {
  const CandInputs& in = c.in;
  const StepKeys& ks = keys(c);
  const int L = tm.lane;
  const int L4 = L & 3;
  const bool on_s = (L4 & 1) == 0;
  const int side = L >> 2;  // 0: r's lanes, 1: q's
  const int n_uni = c.n.K_s - c.n.n_imp_s;
  const bool imp = i >= n_uni;
  // draws: (r's source, slot, fallback, q, Metropolis) on lanes 0-4
  const float u1 = draw_u(L < 3    ? source_draw(ks.swap_src, L, imp, i, i - n_uni)
                          : L == 3 ? Draw{&ks.swap_q, (unsigned long long)i}
                                   : Draw{&ks.u, (unsigned long long)(c.n.K_r + i)});
  gen_wait();
  // q is drawn: its row is in flight while r is picked
  const int slot_r = c.n.K_r + i, slot_q = c.n.K_r + c.n.K_s + i;
  const int q = SHARD ? in.sh_ids[slot_q] : cc_uniform_idx(tm.from(u1, 3), s_gen.n_source);
  const float u_acc = tm.from(u1, 4);
  ReplicaRow xq;
  if (SHARD) {
    load_replica_shard(c, slot_q, xq);
  } else {
    load_replica(c, q, xq);
  }
  staged_wait(staged);
  const int r = SHARD ? in.sh_ids[slot_r] : team_source(c, tm, imp, u1, cdf);
  ReplicaRow xr;
  if (SHARD) {
    load_replica_shard(c, slot_r, xr);
  } else {
    load_replica(c, r, xr);
  }
  const int src = xr.broker, dst = xq.broker;
  // the brokers' round (r's cells on lanes 0-3, q's on 4-7)
  BrokerRows br;
  TieCol ts, td;
  load_broker(c, on_s ? src : dst, br);
  load_tie(c, src, L4, ts);
  load_tie(c, dst, L4, td);
  const int part_x = side ? xq.part : xr.part;
  const int slot_x = side ? slot_q : slot_r;
  const int id0 = SHARD ? sh_member(c, slot_x, L4) : member_id(c, part_x, L4);
  const bool alive_s = in.broker_alive[src], alive_d = in.broker_alive[dst];
  const bool dok_r = disk_ok(c, src, xr.disk), dok_q = disk_ok(c, dst, xq.disk);
  const bool dest_s = in.dest_ok[src], dest_d = in.dest_ok[dst];
  const bool movable_tr = in.topic_movable[xr.topic], movable_tq = in.topic_movable[xq.topic];
  const bool dq_on_dst = disk_ok(c, dst, xq.disk), dr_on_src = disk_ok(c, src, xr.disk);
  const int rack_s = in.broker_rack[src], rack_d = in.broker_rack[dst];
  const int topic_x = side ? xq.topic : xr.topic;
  const int from_x = side ? dst : src, to_x = side ? src : dst;
  const float avg = in.topic_avg[topic_x];
  const int cnt_tf = topic_count(c, topic_x, from_x), cnt_tt = topic_count(c, topic_x, to_x);
  // the last round: host rows, the members' brokers, the rack cells
  HostRows hr;
  load_host(c, br.host, hr);
  const int v0 = SHARD ? sh_mbroker(c, slot_x, L4) : member_broker(c, id0);
  const int rack_f = side ? rack_d : rack_s, rack_t = side ? rack_s : rack_d;
  const int cnt_rf = SHARD ? sh_cell(c, slot_x, rack_f) : rack_count(c, part_x, rack_f);
  const int cnt_rt = SHARD ? sh_cell(c, slot_x, rack_t) : rack_count(c, part_x, rack_t);

  const bool off_r = !(alive_s && dok_r);
  const bool off_q = !(alive_d && dok_q);
  const bool movable_r = movable_tr || off_r;
  const bool movable_q = movable_tq || off_q;
  // r's partition on dst (lanes 0-3), q's on src (lanes 4-7)
  const bool member =
      member_on<kSwapTeam, SHARD>(c, tm, part_x, side ? src : dst, 4 * side, 4, v0, slot_x);
  const bool member_r = tm.from((int)member, 0) != 0, member_q = tm.from((int)member, 4) != 0;
  const bool feas = xr.valid && xq.valid && movable_r && movable_q && src != dst &&
                    xr.part != xq.part && dest_s && dest_d && dq_on_dst && dr_on_src &&
                    !member_r && !member_q;

  float load_r[4], load_q[4], dls[4], dld[4];
  replica_load(xr, load_r);
  replica_load(xq, load_q);
  for (int k = 0; k < 4; ++k) {
    dls[k] = load_q[k] - load_r[k];
    dld[k] = load_r[k] - load_q[k];
  }
  const float pot_r = xr.ll[2], pot_q = xq.ll[2];
  const float lbin_r = xr.lead ? xr.ll[1] : 0.0f;
  const float lbin_q = xq.lead ? xq.ll[1] : 0.0f;
  const float dlbin = lbin_r - lbin_q;
  const float ddisk = load_r[3] - load_q[3];
  float delta = move_delta_core<DISK, BF16>(c, tm, br, hr, ts, td, src, dst, dls, dld, 0,
                                            (int)xr.lead - (int)xq.lead, pot_r - pot_q, dlbin,
                                            dlbin, xr.disk, xq.disk, ddisk, ddisk);

  // r's cells on lanes 0-3, q's on 4-7
  const float rk = rack_delta(rack_f, rack_t, cnt_rf, cnt_rt);
  const float tc = topic_cell_delta(c, avg, cnt_tf, cnt_tt);
  const bool r_ok = alive_d && dq_on_dst;
  const bool q_ok = alive_s && dr_on_src;
  const float doff = ((f01(!r_ok) - f01(off_r)) + f01(!q_ok)) - f01(off_q);
  const bool pref_r = xr.pos == 0 && xr.valid && !xr.lead;
  const bool pref_q = xq.pos == 0 && xq.valid && !xq.lead;
  const float pd_r = f01(pref_r && r_ok) - f01(pref_r && !off_r);
  const float pd_q = f01(pref_q && q_ok) - f01(pref_q && !off_q);
  const float num[4] = {c.s.w_rack * (tm.from(rk, 0) + tm.from(rk, 4)),
                        c.s.w_topic * (tm.from(tc, 0) + tm.from(tc, 4)), c.s.w_offline * doff,
                        c.s.w_pref * (pd_r + pd_q)};
  const float den[4] = {s_gen.n_valid, in.g[G_TOTAL_COUNT], s_gen.n_valid, c.s.num_parts};
  float quo[4];
  lane_quotients(tm, num, den, quo);
  delta = delta + quo[0];
  if (c.n.has_topic) delta = delta + quo[1];
  delta = delta + quo[2];
  if (c.n.has_pref) delta = delta + quo[3];
  if (c.n.price_r) {
    const int orig_r = xr.orig, orig_q = xq.orig;
    const float stray = ((f01(dst != orig_r) - f01(src != orig_r)) + f01(src != orig_q)) -
                        f01(dst != orig_q);
    delta = delta + in.replica_cost[0] * stray;
  }
  put_candidate(c, L4, on && side == 0, c.n.n_r + o, delta, feas, accepted(c, u_acc, delta, feas),
                src, dst, xr.part, xq.part, nullptr, 0, false);
  // r -> (dst, q's disk slot) on lanes 0-3, q -> (src, r's disk slot) on 4-7
  if (side == 0) {
    put_rel_row(c, L4, on, c.n.n_r + o, r, src, dst, xr.disk, xq.disk, load_r, xr.lead, pot_r,
                lbin_r, xr.topic, xr.part);
  } else {
    put_rel_row(c, L4, on, c.n.n_r + c.n.n_s + o, q, dst, src, xq.disk, xr.disk, load_q, xq.lead,
                pot_q, lbin_q, xq.topic, xq.part);
  }
}

template <bool DISK, bool BF16, bool SHARD = false>
__device__ void cand_leadership(const Ctx& c, const Team<kTeam>& tm, int i, int o, bool on) {
  const CandInputs& in = c.in;
  const StepKeys& ks = keys(c);
  const int R = c.n.R;
  const int L = tm.lane;
  const bool on_s = (L & 1) == 0;
  const int k = c.n.K_r + c.n.K_s + i;
  // draws: (target, Metropolis)
  const float u1 = draw_u(L == 0 ? Draw{&ks.lead, (unsigned long long)i}
                                 : Draw{&ks.u, (unsigned long long)k});
  gen_wait();
  const int slot = c.n.K_r + 2 * c.n.K_s + i;
  const int rt = SHARD ? in.sh_ids[slot] : cc_uniform_idx(tm.from(u1, 0), s_gen.n_source);
  const float u_acc = tm.from(u1, 1);
  int part, dst, disk_t, pos_t;
  bool valid_t, lead_t, orig_lead_t;
  float ll_t[4], lf_t[4];
  if (SHARD) {
    const int* w = sh_row(c, slot);
    part = w[1], dst = w[0], disk_t = w[2], pos_t = w[6];
    valid_t = w[4] != 0, lead_t = w[5] != 0, orig_lead_t = w[8] != 0;
    for (int j = 0; j < 4; ++j) {
      ll_t[j] = __int_as_float(w[10 + j]);
      lf_t[j] = __int_as_float(w[14 + j]);
    }
  } else {
    part = in.part_of[rt];
    dst = in.replica_broker[rt];
    disk_t = in.replica_disk[rt];
    valid_t = in.valid[rt], lead_t = in.replica_is_leader[rt];
    pos_t = in.pos[rt];
    orig_lead_t = in.orig_lead[rt];
    row4(in.load_leader, rt, ll_t);
    row4(in.load_follower, rt, lf_t);
  }
  // the target's round: the member ids, the destination's rows
  const int id0 = SHARD ? sh_member(c, slot, L) : member_id(c, part, L);
  BrokerRows br;
  TieCol ts, td;
  if (!on_s) load_broker(c, dst, br);
  load_tie(c, dst, L, td);
  const bool alive_d = in.broker_alive[dst];
  const bool dok_t = disk_ok(c, dst, disk_t);
  const bool lead_ok = in.lead_ok[dst];
  // the partition's first leader (argmax of the member leader flags), one
  // member slot a lane
  int first = -1;
  for (int k0 = 0; k0 < c.n.max_rf; k0 += kTeam) {
    const int kk = k0 + L;
    const int id = k0 == 0 ? id0 : SHARD ? sh_member(c, slot, kk) : member_id(c, part, kk);
    const bool lead = kk < c.n.max_rf && id < R &&
                      (SHARD ? sh_mrow(c, i, kk)[5] != 0 : in.replica_is_leader[min(id, R - 1)]);
    const unsigned bits = tm.ballot(lead, 0, kTeam);
    if (first < 0 && bits != 0u) first = k0 + __ffs(bits) - 1;
  }
  const int f0 = first < 0 ? 0 : first;
  const int rf = min(SHARD ? sh_member(c, slot, f0) : member_id(c, part, f0), R - 1);

  int src, disk_f, pos_f;
  bool orig_lead_f;
  float ll_f[4], lf_f[4];
  if (SHARD) {
    const int* w = sh_mrow(c, i, f0);
    src = w[0], disk_f = w[2], pos_f = w[6], orig_lead_f = w[8] != 0;
    for (int j = 0; j < 4; ++j) {
      ll_f[j] = __int_as_float(w[10 + j]);
      lf_f[j] = __int_as_float(w[14 + j]);
    }
  } else {
    src = in.replica_broker[rf];
    disk_f = in.replica_disk[rf];
    pos_f = in.pos[rf];
    orig_lead_f = in.orig_lead[rf];
    row4(in.load_leader, rf, ll_f);
    row4(in.load_follower, rf, lf_f);
  }
  // the source's round
  if (on_s) load_broker(c, src, br);
  load_tie(c, src, L, ts);
  const bool alive_s = in.broker_alive[src];
  const bool dok_f = disk_ok(c, src, disk_f);
  HostRows hr;
  load_host(c, br.host, hr);

  const bool dst_ok = alive_d && dok_t;
  const bool feas = valid_t && !lead_t && first >= 0 && dst_ok && lead_ok;

  // load shift: rf leader->follower on src, rt follower->leader on dst
  float dl_f[4], dl_t[4];
  for (int j = 0; j < 4; ++j) {
    dl_f[j] = lf_f[j] - ll_f[j];
    dl_t[j] = ll_t[j] - lf_t[j];
  }
  const float dlbin = ll_t[1], dlbin_src = ll_f[1];
  float delta = move_delta_core<DISK, BF16>(c, tm, br, hr, ts, td, src, dst, dl_f, dl_t, 0, 1,
                                            0.0f, dlbin, dlbin_src, disk_f, disk_t, dl_f[3],
                                            dl_t[3]);

  if (c.n.has_pref) {
    const bool src_ok = alive_s && dok_f;
    const bool pref_f = pos_f == 0 && src_ok;
    const bool pref_t = pos_t == 0 && dst_ok;
    delta = delta + (c.s.w_pref * (f01(pref_f) - f01(pref_t))) / c.s.num_parts;
  }
  if (c.n.price_l) {
    delta = delta + in.lead_cost[0] * (f01(!orig_lead_t) - f01(!orig_lead_f));
  }
  put_candidate(c, L, on, c.n.n_r + c.n.n_s + o, delta, feas, accepted(c, u_acc, delta, feas), src,
                dst, part, part, nullptr, 0, false);
  const CandOutputs& out = c.out;
  put_lanes<int>(L, on, o, out.rf, rf, out.rt, rt, out.src_b, src, out.dst_b, dst);
  put_lanes<int>(L, on, o, out.d_f, disk_f, out.d_t, disk_t, (int*)nullptr, 0, (int*)nullptr, 0);
  put_lanes<float>(L, on, o, out.dlbin_src, dlbin_src, out.dlbin_dst, dlbin, (float*)nullptr, 0.0f,
                   (float*)nullptr, 0.0f);
  if (on && L == 2) put4(out.dl_f, o, dl_f);
  if (on && L == 3) put4(out.dl_t, o, dl_t);
}

// ---------------------------------------------------------------------------
// the candidate launch: blocks [0, nb_r) relocations (or intra moves), then
// swaps, then leadership transfers
//
// A launch may run a slice of each kind's candidates (the mesh engine's
// candidate axis, parallel/mesh.py): lane t of kind x is global candidate
// base_x + t, drawn, scored and accepted under the same keys, counters and
// Metropolis u as in the full-K launch, and stored at t of the launch's
// own layout (n_r relocation lanes, then n_s swaps, then n_l leadership
// transfers; payload rows likewise).  A lane past its kind's K stores
// nothing.  The full-K launch is the slice with bases 0 and counts K.
// ---------------------------------------------------------------------------

// DISK: the chain weighs the intra-broker disk goals; INTRA: the K_r
// candidates are intra-broker disk moves; PRIOR: relocation destinations
// mixed from the learned prior; BF16: the broker terms summed in bf16.
// Each is a compile-time branch, so a chain without the disk goals, the
// prior or bf16 runs the lanes it ran before them.  No lane returns early:
// a team past its kind's end repeats the kind's last candidate and stores
// nothing, so every warp collective sees all 32 lanes.
template <bool DISK, bool INTRA, bool PRIOR, bool BF16, bool SHARD>
__global__ void __launch_bounds__(kThreads, 4) candidates_kernel(Ctx c) {
  extern __shared__ float s_cdf[];
  constexpr int per_r = kThreads / kTeam, per_s = kThreads / kSwapTeam;
  const int nb_r = (c.n.n_r + per_r - 1) / per_r;
  const int nb_s = (c.n.n_s + per_s - 1) / per_s;
  int b = blockIdx.x;
  int kind, n, n_imp, per, base, lanes;
  if (b < nb_r) {
    kind = 0, n = c.n.K_r, n_imp = c.n.n_imp_r, per = per_r, base = c.n.base_r, lanes = c.n.n_r;
  } else if (b < nb_r + nb_s) {
    kind = 1, n = c.n.K_s, n_imp = c.n.n_imp_s, per = per_s, b -= nb_r;
    base = c.n.base_s, lanes = c.n.n_s;
  } else {
    kind = 2, n = c.n.K_l, n_imp = 0, per = per_r, b -= nb_r + nb_s;
    base = c.n.base_l, lanes = c.n.n_l;
  }
  // the generation block, then (in blocks holding importance-sampled
  // sources, block-uniform) the CDF: two commit groups, the copies in
  // flight while the draws hash
  if (threadIdx.x < kGenWords) {
    __pipeline_memcpy_async(reinterpret_cast<int*>(&s_gen) + threadIdx.x, c.in.gen + threadIdx.x,
                            sizeof(int));
  }
  __pipeline_commit();
  const bool staged =
      c.n.cdf_in_smem && kind < 2 && n_imp > 0 && base + (b + 1) * per > n - n_imp;
  if (staged) {
    for (int j = threadIdx.x; j < c.n.B; j += kThreads) {
      __pipeline_memcpy_async(s_cdf + j, c.in.cdf + j, sizeof(float));
    }
  }
  __pipeline_commit();
  const float* cdf = staged ? s_cdf : c.in.cdf;
  const int t = b * per + threadIdx.x / (kind == 1 ? kSwapTeam : kTeam);
  const int i_raw = base + t;
  const bool on = t < lanes && i_raw < n;
  const int i = min(i_raw, n - 1);
  if (INTRA) {
    cand_intra<DISK>(c, Team<kTeam>(threadIdx.x), i, t, on, cdf, staged);  // K_s = K_l = 0
  } else if (kind == 0) {
    cand_relocation<DISK, PRIOR, BF16, SHARD>(c, Team<kTeam>(threadIdx.x), i, t, on, cdf, staged);
  } else if (kind == 1) {
    cand_swap<DISK, BF16, SHARD>(c, Team<kSwapTeam>(threadIdx.x), i, t, on, cdf, staged);
  } else {
    cand_leadership<DISK, BF16, SHARD>(c, Team<kTeam>(threadIdx.x), i, t, on);
  }
}

template <bool DISK, bool INTRA, bool PRIOR, bool BF16, bool SHARD = false>
static cudaError_t launch_candidates(const Ctx& c, cudaStream_t st) {
  const size_t smem = c.n.cdf_in_smem ? sizeof(float) * (size_t)c.n.B : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(candidates_kernel<DISK, INTRA, PRIOR, BF16, SHARD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned int blocks = cc_blocks(c.n.n_r, kThreads / kTeam) +
                              cc_blocks(c.n.n_s, kThreads / kSwapTeam) +
                              cc_blocks(c.n.n_l, kThreads / kTeam);
  candidates_kernel<DISK, INTRA, PRIOR, BF16, SHARD><<<blocks, kThreads, smem, st>>>(c);
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

// The sharded-model mode's body: the default kinds (no intra moves, no
// prior) over the assembled bundles.
template <bool DISK>
static cudaError_t launch_shard(const Ctx& c, cudaStream_t st) {
  return c.n.bf16 ? launch_candidates<DISK, false, false, true, true>(c, st)
                  : launch_candidates<DISK, false, false, false, true>(c, st);
}

CC_EXPORT int cc_candidates(CandDims n, MDParams p, CandScalars s, CandInputs in, CandOutputs out,
                            void* stream) {
  const long long lanes = (long long)n.n_r + n.n_s + n.n_l;
  if (lanes <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n.intra && (n.K_s > 0 || n.K_l > 0 || n.prior)) return (int)cudaErrorInvalidValue;
  if (n.base_r < 0 || n.base_s < 0 || n.base_l < 0 || (n.n_r > 0 && n.K_r <= 0) ||
      (n.n_s > 0 && n.K_s <= 0) || (n.n_l > 0 && n.K_l <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (in.gen == nullptr) return (int)cudaErrorInvalidValue;
  if (n.prior && (in.prior_keys == nullptr || in.prior_cdf == nullptr || in.prior_mix == nullptr ||
                  out.from_prior == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Ctx c{n, p, s, in, out};
  if (n.shard) {
    if (n.intra || n.prior || n.base_r != 0 || n.base_s != 0 || n.base_l != 0 ||
        in.sh_ids == nullptr || in.sh_rows == nullptr || in.sh_parts == nullptr ||
        (n.K_r + n.K_s > 0 && in.sh_mb == nullptr) || (n.K_l > 0 && in.sh_ml == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    return (int)(p.has_disk ? launch_shard<true>(c, st) : launch_shard<false>(c, st));
  }
  if (n.intra) {
    // no intra candidate reads a broker term: the bf16 flag changes nothing there
    return (int)(p.has_disk ? launch_candidates<true, true, false, false>(c, st)
                            : launch_candidates<false, true, false, false>(c, st));
  }
  return (int)(p.has_disk ? launch_inter<true>(c, st) : launch_inter<false>(c, st));
}
