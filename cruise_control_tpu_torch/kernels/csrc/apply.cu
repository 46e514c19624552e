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
// Two launches:
//  1. apply_rows_kernel, one thread per row, survivors only: the placement
//     writes (survivors touch distinct partitions, so they never race),
//     the integer counts with atomics (an integer sum does not depend on
//     its order), and the row's id into its brokers' slots
//     (slots[0][src] = row, slots[1][dst] = row; one writer each).
//  2. apply_owner_kernel, one thread per host (brokers grouped by host in
//     the statics, brokers with no host in range in a last group): the
//     thread owns the float aggregates of its brokers and its host.  For a
//     broker it adds the slot rows' amounts in pass order (src before dst;
//     relocation before leadership); for the host it adds the events of all
//     its brokers sorted by (pass, row), which is the reference's order.
//     A host holds few brokers and a broker at most two events, so a
//     selection by repeated minimum costs O(events^2) of a handful.  It
//     then resets its brokers' slots to -1 for the next call.
// One thread per host is the way to an ordered host_load sum without a
// sort or a scan: the events of a host are only those of its own brokers,
// which the thread finds through the slots in O(1) each.
//
// Bound on the card: bytes.  Every row's survivor flag is read, and only a
// survivor reads its payload row (53 or 64 bytes) and read-modify-writes
// its placement and aggregate words; the owner pass reads 2 slots a broker.
// With a few hundred survivors a step, the two launches dominate.
#include "common.cuh"

struct ApplyDims {
  int n_rel, n_lead, R, B, T, P, racks, D, H;
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
};

__device__ __forceinline__ bool in(int v, int n) { return v >= 0 && v < n; }

__global__ void apply_rows_kernel(ApplyDims n, RelRows rel, LeadRows lead, Carry c, Owners o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n.n_rel) {
    if (!rel.sv[i]) return;
    const int r = rel.r[i], s = rel.src[i], d = rel.dst[i];
    if (in(r, n.R)) {
      c.replica_broker[r] = d;
      c.replica_disk[r] = rel.d_dst[i];
    }
    if (!in(s, n.B) || !in(d, n.B)) return;  // dropped, as out-of-range scatters are
    atomicSub(&c.rcount[s], 1);
    atomicAdd(&c.rcount[d], 1);
    if (rel.is_lead[i]) {
      atomicSub(&c.lcount[s], 1);
      atomicAdd(&c.lcount[d], 1);
    }
    const int t = rel.topic[i];
    if (in(t, n.T)) {
      atomicSub(&c.topic_count[(size_t)t * n.B + s], 1);
      atomicAdd(&c.topic_count[(size_t)t * n.B + d], 1);
    }
    const int p = rel.part[i];
    if (in(p, n.P)) {
      atomicSub(&c.part_rack_count[(size_t)p * n.racks + c.broker_rack[s]], 1);
      atomicAdd(&c.part_rack_count[(size_t)p * n.racks + c.broker_rack[d]], 1);
    }
    o.slots[s] = i;
    o.slots[n.B + d] = i;
    return;
  }
  const int j = i - n.n_rel;
  if (j >= n.n_lead || !lead.sv[j]) return;
  const int rf = lead.rf[j], rt = lead.rt[j];
  if (in(rf, n.R)) c.replica_is_leader[rf] = false;
  if (in(rt, n.R)) c.replica_is_leader[rt] = true;
  const int s = lead.src[j], d = lead.dst[j];
  if (!in(s, n.B) || !in(d, n.B)) return;
  atomicSub(&c.lcount[s], 1);
  atomicAdd(&c.lcount[d], 1);
  o.slots[s] = i;
  o.slots[n.B + d] = i;
}

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

__device__ void add_broker_event(const ApplyDims& n, Carry& c, int b, const Event& e, bool is_rel) {
  for (int k = 0; k < 4; ++k) c.broker_load[b * 4 + k] = c.broker_load[b * 4 + k] + e.load[k];
  if (is_rel) c.pot[b] = c.pot[b] + e.pot;
  c.lbin[b] = c.lbin[b] + e.lbin;
  if (e.disk >= 0) c.disk_load[b * n.D + e.disk] = c.disk_load[b * n.D + e.disk] + e.load[3];
}

__global__ void apply_owner_kernel(ApplyDims n, RelRows rel, LeadRows lead, Carry c, Owners o) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h > n.H) return;  // group H holds the brokers with no host in range
  const int lo = o.host_start[h], hi = o.host_start[h + 1];
  // broker-level floats: each broker's (at most two) events in pass order
  for (int i = lo; i < hi; ++i) {
    const int b = o.host_brokers[i];
    const int rs = o.slots[b], rd = o.slots[n.B + b];
    if (rs < 0 && rd < 0) continue;
    const bool src_first = rd < 0 || (rs >= 0 && event_key(n, rs, false) < event_key(n, rd, true));
    for (int t = 0; t < 2; ++t) {
      const bool dst = (t == 0) != src_first;
      const int row = dst ? rd : rs;
      if (row < 0) continue;
      add_broker_event(n, c, b, event_of(n, rel, lead, row, dst), row < n.n_rel);
    }
  }
  // host_load: all events of the host's brokers, by (pass, row)
  if (h < n.H) {
    long long last = -1;
    for (;;) {
      long long best = -1;
      int best_row = -1;
      bool best_dst = false;
      for (int i = lo; i < hi; ++i) {
        const int b = o.host_brokers[i];
        for (int t = 0; t < 2; ++t) {
          const int row = o.slots[t * n.B + b];
          if (row < 0) continue;
          const long long key = event_key(n, row, t == 1);
          if (key > last && (best < 0 || key < best)) {
            best = key;
            best_row = row;
            best_dst = t == 1;
          }
        }
      }
      if (best < 0) break;
      const Event e = event_of(n, rel, lead, best_row, best_dst);
      for (int k = 0; k < 4; ++k) c.host_load[h * 4 + k] = c.host_load[h * 4 + k] + e.load[k];
      last = best;
    }
  }
  for (int i = lo; i < hi; ++i) {
    const int b = o.host_brokers[i];
    o.slots[b] = -1;
    o.slots[n.B + b] = -1;
  }
}

CC_EXPORT int cc_apply_moves(ApplyDims n, RelRows rel, LeadRows lead, Carry c, Owners o,
                             void* stream) {
  const long long rows = (long long)n.n_rel + n.n_lead;
  if (rows <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  apply_rows_kernel<<<cc_blocks(rows, threads), threads, 0, st>>>(n, rel, lead, c, o);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  apply_owner_kernel<<<cc_blocks((long long)n.H + 1, threads), threads, 0, st>>>(n, rel, lead, c, o);
  return (int)cudaGetLastError();
}
