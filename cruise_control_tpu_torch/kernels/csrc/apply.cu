// apply_moves: scatter the surviving candidates into the placement and the
// incremental aggregates, in place, with every float added in the
// reference's order (cruise_control_tpu/analyzer/engine.py:2715 `_apply`):
// the relocation rows' src subtractions in row order, then their dst
// additions, then the leadership rows' src additions, then their dst
// additions.  The result is bit for bit the plain version's, run after run.
//
// Precondition (select_survivors guarantees it): every broker is the src
// of at most one surviving row and the dst of at most one.  Survivors own
// their brokers (src and dst segments share the ids 0..B-1), and a swap's
// two linked rows are src->dst and dst->src of the same two brokers.
//
// What bounds it on this card: latency, and where the requests queue.  A
// step has a few hundred survivors among ~17 K rows (north star: 16,896
// rows, ~300-500 survivors); the bytes it must move take ~0.03 us of HBM
// time, while every survivor's work is a chain of dependent requests (its
// flag, its row, its broker's floats, the other event on its broker) and
// ~30 scattered requests.  The first design paid for two launches a step,
// a pass of one thread a row over all rows, and an owner pass of one
// thread a host over every host (H + 1 threads on 11 of the 132 SMs), each
// thread reading both slots of all its brokers, selecting its host's events
// by repeated minimum and clearing its slots, whether or not a survivor
// touched them.  Spread matters as much as depth: one block alone (tried
// first; three times the first design's time) queues the step's ~10 K
// scattered requests on one SM's memory pipeline, and a thread-block
// cluster (8 or 16 SMs, tried next) did worse than every SM in a whole
// run, where hot rounds keep ~500 survivors a step.
//
// Design: one cooperative launch of at most one block an SM (as in
// select_survivors); block i takes the i-th slice of the rows, and no pass
// covers all brokers or hosts: after the flag sweep the work is
// proportional to the survivors, and each thread's chain of dependent
// requests is short.
//  1. Compaction, deterministic and without atomics: each warp ballots 32
//     rows' survivor flags a word (a lane's loads issued together, each
//     row's src and dst brokers loaded with its flag, coalesced), the
//     warps' counts give their offsets, and the block's survivors are
//     listed in row order in shared memory with their brokers.
//  2. One thread a side of a survivor (its src side, its dst side).  It
//     loads its row's fields and event with its broker's floats and rack,
//     then its host's load (two rounds of requests: nothing writes the
//     floats before the float pass).  It writes the placement (src side;
//     survivors touch distinct partitions, so it never races) and its
//     side's integer counts with atomics (an integer sum does not depend
//     on its order), and puts the row and its event in its broker's slot
//     (slots[0][src], slots[1][dst]; one writer each).
//  3. After a grid barrier (every block's slots visible), each side reads the
//     other slot of its broker, row and event in one request: a broker has
//     at most two events, and the side whose event comes first in the
//     reference's order adds both, in that order, in registers, and
//     stores each value once; on a host of one broker (every host at the
//     north star) it adds the same two events to the host's load.  A slot
//     is read by the other side of its broker alone, so the reader clears
//     it (a side alone on its broker clears its own): the slots are -1
//     again at the end, with no second barrier and no clear of all 2 x B.
//     Where a host holds several brokers (`shared_hosts`), its first
//     event's thread walks the host's brokers' slots (the statics group
//     brokers by host) and adds the host's events in (pass, row) order by
//     repeated minimum; then every side resets its own slot after a second
//     grid barrier.  Whether a host does is a value of the model
//     generation: each thread reads it from the engine's generation block
//     (GenParams) with its first loads, so a captured step replays with
//     the generation it runs on; it is the same word in every block, so
//     the branch, barriers included, is grid-uniform.
// Tensor cores and TMA have no part here: there is no matrix product, and
// the gathers and scatters land at a few hundred random addresses.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// R and P are the carry's rows; r_off and p_off the global ids of its
// first replica and partition row (0 but in the sharded-model mode, where
// a shard holds one block of rows and the payload keeps global ids: a row
// outside the block drops its placement and cell writes, and the broker,
// host and topic aggregates take every survivor)
struct ApplyDims {
  int n_rel, n_lead, R, B, T, P, racks, D, H, r_off, p_off;
};

struct RelRows {
  const bool* sv;
  const int* r;
  const int* src;
  const int* dst;
  const int* d_src;
  const int* d_dst;
  const float* load;  // [n_rel, 4]
  const bool* is_lead;
  const float* pot;
  const float* lbin;
  const int* topic;
  const int* part;
};

struct LeadRows {
  const bool* sv;
  const int* rf;
  const int* rt;
  const int* src;
  const int* dst;
  const float* dl_f;  // [n_lead, 4]
  const float* dl_t;  // [n_lead, 4]
  const float* dlbin_src;
  const float* dlbin_dst;
  const int* d_f;
  const int* d_t;
};

struct Carry {
  int* replica_broker;
  int* replica_disk;
  bool* replica_is_leader;
  float* broker_load;  // [B, 4]
  int* rcount;
  int* lcount;
  float* pot;
  float* lbin;
  int* topic_count;      // [T, B]
  int* part_rack_count;  // [P, racks]
  float* disk_load;      // [B, D]
  float* host_load;      // [H, 4]
  const int* broker_rack;
  const int* broker_host;
};

struct Owners {
  const int* host_brokers;  // [B] broker ids grouped by host
  const int* host_start;    // [H + 2] group offsets
  int* slots;               // [2, B] surviving src / dst row per broker, -1 if none
  float4* events;           // [2, B, 2] the slot's event (load; pot, lbin, disk bits, -)
  const GenParams* gen;     // the generation block: shared_hosts, whether a host in
                            // range holds more than one broker
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // words a warp ballots in a pass, its lanes' loads issued together

__device__ __forceinline__ bool in(int v, int n) { return v >= 0 && v < n; }

// The float amounts one event adds: its load row to the broker's and the
// host's load, pot to potential NW-out (relocations only), lbin to leader
// bytes-in, and load[3] to one disk cell (disk < 0: none).
struct Event {
  float load[4];
  float pot, lbin;
  int disk;
};

// Event of row `row` (relocation rows first, then leadership rows) on its
// src side (dst == false) or its dst side.
__device__ Event event_of(const ApplyDims& n, const RelRows& rel, const LeadRows& lead, int row,
                          bool dst) {
  Event e;
  if (row < n.n_rel) {
    const float* ld = rel.load + (size_t)row * 4;
    for (int k = 0; k < 4; ++k) e.load[k] = dst ? ld[k] : -ld[k];
    e.pot = dst ? rel.pot[row] : -rel.pot[row];
    e.lbin = dst ? rel.lbin[row] : -rel.lbin[row];
    e.disk = dst ? rel.d_dst[row] : rel.d_src[row];
  } else {
    const int j = row - n.n_rel;
    const float* dl = (dst ? lead.dl_t : lead.dl_f) + (size_t)j * 4;
    for (int k = 0; k < 4; ++k) e.load[k] = dl[k];
    e.pot = 0.0f;
    e.lbin = dst ? lead.dlbin_dst[j] : -lead.dlbin_src[j];
    e.disk = dst ? lead.d_t[j] : lead.d_f[j];
  }
  if (!in(e.disk, n.D)) e.disk = -1;
  return e;
}

// Sort key of an event in the reference's order: relocation src (pass 0),
// relocation dst (1), leadership src (2), leadership dst (3); rows in order.
__device__ __forceinline__ long long event_key(const ApplyDims& n, int row, bool dst) {
  const long long rows = (long long)n.n_rel + n.n_lead;
  const int pass = (row < n.n_rel ? 0 : 2) + (dst ? 1 : 0);
  return pass * rows + row;
}

// One side of a survivor: its event, the floats it will add to, and the
// row's fields its writes need.
struct Side {
  int row, b, h, lo, hi;
  bool dst, ok;  // ok: both brokers in range (else the row adds nothing)
  Event e;
  float bl[4], pot, lbin, va, hl[4];  // broker b's floats, the event's disk cell, the host's load
  int d, r, d_dst, t, p, rf, rt, rack;
  bool is_lead;
};

// A side's loads (its row's src and dst brokers given): the row's fields
// and event with its broker's floats and rack, then its host's (nothing
// writes those before the float pass).
// OFFSETS: the carry is a model shard's block (ApplyDims r_off, p_off); a
// compile-time branch, so every other launch runs the code it ran before.
template <bool OFFSETS>
__device__ Side load_side(const ApplyDims& n, const RelRows& rel, const LeadRows& lead,
                          const Carry& c, const Owners& o, int row, int s, int d, bool dst,
                          bool shared) {
  Side sd;
  sd.row = row;
  sd.dst = dst;
  sd.d = d;
  const bool is_rel = row < n.n_rel;
  const int j = row - n.n_rel;
  sd.r = sd.t = sd.p = sd.rf = sd.rt = -1;
  sd.d_dst = sd.rack = 0;
  sd.is_lead = false;
  if (is_rel) {
    sd.r = OFFSETS ? rel.r[row] - n.r_off : rel.r[row];
    sd.d_dst = rel.d_dst[row];
    sd.is_lead = rel.is_lead[row];
    sd.t = rel.topic[row];
    sd.p = OFFSETS ? rel.part[row] - n.p_off : rel.part[row];
  } else {
    sd.rf = OFFSETS ? lead.rf[j] - n.r_off : lead.rf[j];
    sd.rt = OFFSETS ? lead.rt[j] - n.r_off : lead.rt[j];
  }
  sd.e = event_of(n, rel, lead, row, dst);
  sd.ok = in(s, n.B) && in(sd.d, n.B);
  const int b = sd.b = dst ? sd.d : s;
  sd.h = -1;
  sd.lo = sd.hi = 0;
  if (!sd.ok) return sd;
  sd.h = c.broker_host[b];
  for (int k = 0; k < 4; ++k) sd.bl[k] = c.broker_load[b * 4 + k];
  sd.pot = c.pot[b];
  sd.lbin = c.lbin[b];
  sd.va = sd.e.disk >= 0 ? c.disk_load[b * n.D + sd.e.disk] : 0.0f;
  if (is_rel && in(sd.p, n.P)) sd.rack = c.broker_rack[b];
  if (in(sd.h, n.H)) {
    for (int k = 0; k < 4; ++k) sd.hl[k] = c.host_load[sd.h * 4 + k];
    if (shared) {
      sd.lo = o.host_start[sd.h];
      sd.hi = o.host_start[sd.h + 1];
    } else {
      sd.hi = 1;
    }
  }
  return sd;
}

// Phase 2's writes of one side: the placement (on the src side), this
// side's integer counts, the row and its event in the broker's slot.
__device__ void write_side(const ApplyDims& n, Carry& c, Owners& o, const Side& sd) {
  const bool is_rel = sd.row < n.n_rel;
  if (!sd.dst) {
    if (is_rel && in(sd.r, n.R)) {
      c.replica_broker[sd.r] = sd.d;
      c.replica_disk[sd.r] = sd.d_dst;
    }
    if (!is_rel && in(sd.rf, n.R)) c.replica_is_leader[sd.rf] = false;
    if (!is_rel && in(sd.rt, n.R)) c.replica_is_leader[sd.rt] = true;
  }
  if (!sd.ok) return;  // dropped, as out-of-range scatters are
  const int b = sd.b, one = sd.dst ? 1 : -1;
  if (is_rel) {
    atomicAdd(&c.rcount[b], one);
    if (sd.is_lead) atomicAdd(&c.lcount[b], one);
    if (in(sd.t, n.T)) atomicAdd(&c.topic_count[(size_t)sd.t * n.B + b], one);
    if (in(sd.p, n.P)) atomicAdd(&c.part_rack_count[(size_t)sd.p * n.racks + sd.rack], one);
  } else {
    atomicAdd(&c.lcount[b], one);
  }
  const int slot = (sd.dst ? n.B : 0) + b;
  o.slots[slot] = sd.row;
  o.events[2 * slot] = make_float4(sd.e.load[0], sd.e.load[1], sd.e.load[2], sd.e.load[3]);
  o.events[2 * slot + 1] = make_float4(sd.e.pot, sd.e.lbin, __int_as_float(sd.e.disk), 0.0f);
}

// The other slot of a side's broker: its row (-1: none) and event, read
// from L2 (another block may have written it).
struct Other {
  int row;
  Event e;
};

__device__ Other other_of(const ApplyDims& n, const Owners& o, const Side& sd) {
  const int slot = (sd.dst ? 0 : n.B) + sd.b;
  Other ot;
  ot.row = __ldcg(&o.slots[slot]);
  const float4 o0 = __ldcg(&o.events[2 * slot]), o1 = __ldcg(&o.events[2 * slot + 1]);
  ot.e.load[0] = o0.x;
  ot.e.load[1] = o0.y;
  ot.e.load[2] = o0.z;
  ot.e.load[3] = o0.w;
  ot.e.pot = o1.x;
  ot.e.lbin = o1.y;
  ot.e.disk = ot.row >= 0 ? __float_as_int(o1.z) : -1;
  return ot;
}

// Adds event e to a broker's floats and its host's load, in registers:
// its disk share to cell da (in va) or else to cell db (in vb).
__device__ __forceinline__ void add_event(const Event& e, bool is_rel, int da, float bl[4],
                                          float& pot, float& lbin, float& va, float& vb,
                                          float hl[4]) {
  for (int k = 0; k < 4; ++k) bl[k] = bl[k] + e.load[k];
  if (is_rel) pot = pot + e.pot;
  lbin = lbin + e.lbin;
  if (e.disk >= 0 && e.disk == da) va = va + e.load[3];
  else if (e.disk >= 0) vb = vb + e.load[3];
  for (int k = 0; k < 4; ++k) hl[k] = hl[k] + e.load[k];
}

// Phase 3, one side: if its event is the first of its broker's (at most
// two) in the reference's order, it adds both, in that order, in
// registers, and stores each value once (on a host of one broker, the
// host's load too).
__device__ void add_side(const ApplyDims& n, Carry& c, Side sd, const Other& ot) {
  if (ot.row >= 0 && event_key(n, ot.row, !sd.dst) < event_key(n, sd.row, sd.dst)) return;
  const int b = sd.b;
  const int da = sd.e.disk, db = ot.e.disk != da ? ot.e.disk : -1;
  float vb = db >= 0 ? c.disk_load[b * n.D + db] : 0.0f;
  add_event(sd.e, sd.row < n.n_rel, da, sd.bl, sd.pot, sd.lbin, sd.va, vb, sd.hl);
  if (ot.row >= 0) add_event(ot.e, ot.row < n.n_rel, da, sd.bl, sd.pot, sd.lbin, sd.va, vb, sd.hl);
  for (int k = 0; k < 4; ++k) c.broker_load[b * 4 + k] = sd.bl[k];
  c.pot[b] = sd.pot;
  c.lbin[b] = sd.lbin;
  if (da >= 0) c.disk_load[b * n.D + da] = sd.va;
  if (db >= 0) c.disk_load[b * n.D + db] = vb;
  if (in(sd.h, n.H) && sd.hi - sd.lo == 1)
    for (int k = 0; k < 4; ++k) c.host_load[sd.h * 4 + k] = sd.hl[k];
}

__device__ __forceinline__ void add_host_event(Carry& c, int h, const Event& e) {
  for (int k = 0; k < 4; ++k) c.host_load[h * 4 + k] = c.host_load[h * 4 + k] + e.load[k];
}

// A host of several brokers: the thread of its first event adds all of its
// events, by (pass, row), walking its brokers' slots.
__device__ void walk_host(const ApplyDims& n, const RelRows& rel, const LeadRows& lead, Carry& c,
                          const Owners& o, const Side& sd) {
  if (!in(sd.h, n.H) || sd.hi - sd.lo < 2) return;
  const long long key = event_key(n, sd.row, sd.dst);
  long long first = key;
  for (int i = sd.lo; i < sd.hi; ++i) {
    const int b2 = o.host_brokers[i];
    for (int t = 0; t < 2; ++t) {
      const int r2 = __ldcg(&o.slots[t * n.B + b2]);
      if (r2 >= 0) {
        const long long k2 = event_key(n, r2, t == 1);
        if (k2 < first) first = k2;
      }
    }
  }
  if (first != key) return;
  long long last = -1;
  for (;;) {
    long long best = -1;
    int best_row = -1;
    bool best_dst = false;
    for (int i = sd.lo; i < sd.hi; ++i) {
      const int b2 = o.host_brokers[i];
      for (int t = 0; t < 2; ++t) {
        const int r2 = __ldcg(&o.slots[t * n.B + b2]);
        if (r2 < 0) continue;
        const long long k2 = event_key(n, r2, t == 1);
        if (k2 > last && (best < 0 || k2 < best)) {
          best = k2;
          best_row = r2;
          best_dst = t == 1;
        }
      }
    }
    if (best < 0) break;
    add_host_event(c, sd.h, event_of(n, rel, lead, best_row, best_dst));
    last = best;
  }
}

// Phase 3 of one side whose hosts hold one broker each: the other slot
// read, then cleared by its one reader (a side alone clears its own).
__device__ void float_pass(const ApplyDims& n, Carry& c, Owners& o, const Side& sd) {
  const Other ot = other_of(n, o, sd);
  o.slots[ot.row >= 0 ? (sd.dst ? 0 : n.B) + sd.b : (sd.dst ? n.B : 0) + sd.b] = -1;
  add_side(n, c, sd, ot);
}

// A cooperative grid of at most one block an SM; block i sweeps words
// [i * per_block, (i + 1) * per_block) of the survivor flags (32 rows a
// word).  Side q of
// the block's survivors is survivor q's src side, and (q >= S) survivor
// q - S's dst side; a thread keeps its first side in registers (a side
// past it is loaded again after the barrier: only its broker's first
// event writes the broker's floats, so they are still the ones before).
template <bool OFFSETS>
__global__ void __launch_bounds__(kThreads)
    apply_moves_kernel(ApplyDims n, RelRows rel, LeadRows lead, Carry c, Owners o, int per_block) {
  // the block's survivors in row order: rows, src and dst brokers
  extern __shared__ int list[];  // [3][32 * per_block]
  int* list_s = list + 32 * per_block;
  int* list_d = list_s + 32 * per_block;
  __shared__ int warp_cnt[kWarps];
  const int rows = n.n_rel + n.n_lead;
  const int n_words = (rows + 31) >> 5;
  const int w_begin = blockIdx.x * per_block;
  const int nw = max(0, min(per_block, n_words - w_begin));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  // the generation's shared_hosts word, loaded now and first used in phase 2
  const bool shared = o.gen->shared_hosts != 0;

  // 1. the survivors listed: a pass of kWarps x kUnroll words, each warp
  // kUnroll consecutive words; a row's brokers are loaded with its flag
  // (coalesced, whether or not it survives), and the warps' counts give
  // their offsets
  int S = 0;
  for (int p0 = 0; p0 < nw; p0 += kWarps * kUnroll) {
    const int w0 = p0 + warp * kUnroll;
    bool f[kUnroll];
    int fs[kUnroll], fd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = ((w_begin + w0 + u) << 5) + lane;
      f[u] = false;
      fs[u] = fd[u] = -1;
      if (w0 + u < nw && row < rows) {
        if (row < n.n_rel) {
          f[u] = rel.sv[row];
          fs[u] = rel.src[row];
          fd[u] = rel.dst[row];
        } else {
          f[u] = lead.sv[row - n.n_rel];
          fs[u] = lead.src[row - n.n_rel];
          fd[u] = lead.dst[row - n.n_rel];
        }
      }
    }
    unsigned m[kUnroll];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      m[u] = __ballot_sync(0xFFFFFFFFu, f[u]);
      cnt += __popc(m[u]);
    }
    if (lane == 0) warp_cnt[warp] = cnt;
    __syncthreads();
    int off = S, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = warp_cnt[w];
      off += w < warp ? v : 0;
      total += v;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (f[u]) {
        const int k = off + __popc(m[u] & below);
        list[k] = ((w_begin + w0 + u) << 5) + lane;
        list_s[k] = fs[u];
        list_d[k] = fd[u];
      }
      off += __popc(m[u]);
    }
    S += total;
    __syncthreads();
  }

  // 2. one thread a side: loads, placement, integer counts, its slot
  Side mine;
  mine.ok = false;
  for (int q = tid; q < 2 * S; q += kThreads) {
    const int i = q % S;
    const Side sd = load_side<OFFSETS>(n, rel, lead, c, o, list[i], list_s[i], list_d[i], q >= S, shared);
    write_side(n, c, o, sd);
    if (q == tid) mine = sd;
  }
  cg::this_grid().sync();  // every block's slots set and visible to every block

  // 3. the float pass (a side past the thread's first: its loads again)
  if (!shared) {
    for (int q = tid; q < 2 * S; q += kThreads) {
      const int i = q % S;
      const Side sd =
          q == tid ? mine
                   : load_side<OFFSETS>(n, rel, lead, c, o, list[i], list_s[i], list_d[i], q >= S, shared);
      if (sd.ok) float_pass(n, c, o, sd);
    }
    return;
  }
  // hosts of several brokers: every slot read (and the hosts walked)
  // before any is reset
  for (int q = tid; q < 2 * S; q += kThreads) {
    const int i = q % S;
    const Side sd =
        q == tid ? mine
                 : load_side<OFFSETS>(n, rel, lead, c, o, list[i], list_s[i], list_d[i], q >= S, shared);
    if (!sd.ok) continue;
    walk_host(n, rel, lead, c, o, sd);
    add_side(n, c, sd, other_of(n, o, sd));
  }
  cg::this_grid().sync();
  for (int q = tid; q < 2 * S; q += kThreads) {
    const int i = q % S, s = list_s[i], d = list_d[i];
    if (in(s, n.B) && in(d, n.B)) o.slots[q >= S ? n.B + d : s] = -1;
  }
}

// Words of 32 rows each of at most n_sm blocks sweeps, and the dynamic
// shared memory a block needs for them (32 list entries of three ints a
// word).
CC_EXPORT int cc_apply_words_per_block(long long rows, int n_sm) {
  return (int)(((rows + 31) / 32 + n_sm - 1) / n_sm);
}

CC_EXPORT long long cc_apply_smem_bytes(long long rows, int n_sm) {
  return 384LL * cc_apply_words_per_block(rows, n_sm);
}

template <bool OFFSETS>
static cudaError_t launch_apply(ApplyDims n, RelRows rel, LeadRows lead, Carry c, Owners o,
                                int n_sm, void* stream) {
  const long long rows = (long long)n.n_rel + n.n_lead;
  const int per_block = cc_apply_words_per_block(rows, n_sm);
  const long long smem = cc_apply_smem_bytes(rows, n_sm);
  if (smem > 46 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        apply_moves_kernel<OFFSETS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(((rows + 31) / 32 + per_block - 1) / per_block));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, apply_moves_kernel<OFFSETS>, n, rel, lead, c, o, per_block);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// One cooperative launch of at most one block an SM (`n_sm` blocks: all
// resident at once, as grid.sync() needs).
CC_EXPORT int cc_apply_moves(ApplyDims n, RelRows rel, LeadRows lead, Carry c, Owners o, int n_sm,
                             void* stream) {
  const long long rows = (long long)n.n_rel + n.n_lead;
  if (rows <= 0) return 0;
  return (int)(n.r_off != 0 || n.p_off != 0 ? launch_apply<true>(n, rel, lead, c, o, n_sm, stream)
                                            : launch_apply<false>(n, rel, lead, c, o, n_sm, stream));
}
