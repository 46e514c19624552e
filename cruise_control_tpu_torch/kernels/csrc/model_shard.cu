// The sharded-model mode's ownership gathers (kernels/model_shard.py).
//
// A model shard j of n holds the global replica rows [r_off, r_off + Rl)
// and partition rows [p_off, p_off + Pl); values keep global ids.  A step
// needs rows at global ids that any shard may own, in a chain of hops
// (the source ids, their replica rows, their partitions' rows, the
// members' rows).  For each hop one of these kernels writes, for every
// requested id, the row this shard owns or zeros, into a packed i32
// bundle (floats as their bits, bools as 0/1); one all_reduce(SUM) over
// the model row then assembles the bundle.  Exactly one shard owns each
// id, so every word is one owner's bits plus zeros: the sum is exact
// whatever the type.  The candidates kernel's SHARD body then reads the
// bundles (csrc/candidates.cu).
//
//  shard_sources: the step's source ids by slot (relocations, swap sources,
//    swap partners, leadership targets) from the replicated draws; an
//    importance-sampled source is resolved by ownership of its global group
//    position (the grouped order is the shards' local groups in shard
//    order: `below` counts a broker's replicas on lower shards), the
//    replicated uniform draws are written by shard 0.
//  own_rows: replica rows (kRowWords words, or the broker alone) of ids.
//  own_parts: partition rows (member ids, then the rack cells) of ids.
//  shard_prc: this shard's contribution to every partition x rack cell
//    (atomic integer adds, so their order does not matter), reduce-
//    scattered by the caller to each shard's own rows.
//
// Bound: latency of scattered 4- to 72-byte rows; a thread a (slot, word)
// or a slot.  Nothing here is worth tensor cores or TMA.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kRowWords = 18;  // kernels/model_shard.py ROW_FIELDS

struct Key2 {
  uint32_t k0, k1;
};

// kernels/candidates.py StepKeys' row
struct StepKeys {
  Key2 rel_src[4];
  Key2 rel_dst;
  Key2 swap_src[4];
  Key2 swap_q;
  Key2 lead;
  Key2 u;
};

struct SourceArgs {
  int K_r, K_s, K_l, n_imp_r, n_imp_s, B, r_off, r_local, shard, step, steps_per_round;
  const StepKeys* key_table;
  const int* rnd;
  const float* cdf;         // [B] the broker CDF (replicated)
  const int* count;         // [B] global replicas a broker
  const int* count_local;   // [B] this shard's
  const int* below;         // [B] on lower shards
  const int* start_local;   // [B] offsets into order_local
  const int* order_local;   // [Rl] local rows grouped by broker
  const int* gen;           // GenParams
  int* out;                 // [K_r + 2 K_s + K_l]
};

__device__ __forceinline__ float unit(const Key2& k, unsigned long long i) {
  return cc_unit_float(k.k0, k.k1, i);
}

// `_sample_sources` of draw i of a kind whose last n_imp draws are
// importance-sampled; returns the id and whether this shard writes it.
__device__ int source_of(const SourceArgs& a, const GenParams& g, const Key2* ks, int n, int n_imp,
                         int i, bool& own) {
  const int n_uni = n - n_imp;
  if (i < n_uni) {
    own = a.shard == 0;
    return cc_uniform_idx(unit(ks[0], (unsigned long long)i), g.n_source);
  }
  const unsigned long long ii = (unsigned long long)(i - n_uni);
  const float u_src = unit(ks[1], ii), u_slot = unit(ks[2], ii), u_fb = unit(ks[3], ii);
  int lo = 0, hi = a.B;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(a.cdf[mid] > u_src)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int bsel = max(0, min(lo, g.n_brokers - 1));
  const int cnt = a.count[bsel];
  if (cnt <= 0) {
    own = a.shard == 0;
    return cc_uniform_idx(u_fb, g.n_source);
  }
  const int j = __float2int_rz(__fmul_rn(u_slot, (float)cnt));
  const int lj = j - a.below[bsel];
  own = lj >= 0 && lj < a.count_local[bsel];
  if (!own) return 0;
  const int slot = max(0, min(a.start_local[bsel] + lj, a.r_local - 1));
  return a.order_local[slot] + a.r_off;
}

__global__ void shard_sources_kernel(SourceArgs a) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.K_r + 2 * a.K_s + a.K_l;
  if (k >= n) return;
  const GenParams& g = *reinterpret_cast<const GenParams*>(a.gen);
  const StepKeys& ks = a.key_table[(size_t)(*a.rnd) * a.steps_per_round + a.step];
  bool own = false;
  int id;
  if (k < a.K_r) {
    id = source_of(a, g, ks.rel_src, a.K_r, a.n_imp_r, k, own);
  } else if (k < a.K_r + a.K_s) {
    id = source_of(a, g, ks.swap_src, a.K_s, a.n_imp_s, k - a.K_r, own);
  } else if (k < a.K_r + 2 * a.K_s) {
    own = a.shard == 0;
    id = cc_uniform_idx(unit(ks.swap_q, (unsigned long long)(k - a.K_r - a.K_s)), g.n_source);
  } else {
    own = a.shard == 0;
    id = cc_uniform_idx(unit(ks.lead, (unsigned long long)(k - a.K_r - 2 * a.K_s)), g.n_source);
  }
  a.out[k] = own ? id : 0;
}

CC_EXPORT int cc_shard_sources(SourceArgs a, void* stream) {
  const long long n = (long long)a.K_r + 2LL * a.K_s + a.K_l;
  if (n <= 0) return 0;
  if (a.gen == nullptr || a.key_table == nullptr || a.rnd == nullptr ||
      ((a.n_imp_r > 0 || a.n_imp_s > 0) && (a.cdf == nullptr || a.count == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  shard_sources_kernel<<<cc_blocks(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The replica columns a row is read from (this shard's blocks).
struct RowSrc {
  const int* broker;
  const int* part;
  const int* disk;
  const int* topic;
  const bool* valid;
  const bool* lead;
  const int* pos;
  const int* orig_broker;
  const bool* orig_lead;
  const int* orig_disk;
  const float* load_leader;    // [Rl, 4]
  const float* load_follower;  // [Rl, 4]
};

struct RowArgs {
  int n;          // rows requested
  int m;          // ids a request row (ids[(k / m) * stride + k % m])
  int stride;
  int words;      // kRowWords, or 1 (the broker alone)
  int r_off, r_local;
  const int* ids;
  RowSrc src;
  int* out;       // [n * m, words]
};

__device__ __forceinline__ int row_word(const RowSrc& s, int li, int w) {
  switch (w) {
    case 0: return s.broker[li];
    case 1: return s.part[li];
    case 2: return s.disk[li];
    case 3: return s.topic[li];
    case 4: return s.valid[li] ? 1 : 0;
    case 5: return s.lead[li] ? 1 : 0;
    case 6: return s.pos[li];
    case 7: return s.orig_broker[li];
    case 8: return s.orig_lead[li] ? 1 : 0;
    case 9: return s.orig_disk[li];
    default:
      return w < 14 ? __float_as_int(s.load_leader[(size_t)li * 4 + (w - 10)])
                    : __float_as_int(s.load_follower[(size_t)li * 4 + (w - 14)]);
  }
}

// a thread a (row, word)
__global__ void own_rows_kernel(RowArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)a.n * a.m * a.words;
  if (t >= total) return;
  const long long k = t / a.words;
  const int w = (int)(t - k * a.words);
  const int id = a.ids[(k / a.m) * a.stride + k % a.m];
  const int li = id - a.r_off;
  a.out[t] = li >= 0 && li < a.r_local ? row_word(a.src, li, w) : 0;
}

CC_EXPORT int cc_own_rows(RowArgs a, void* stream) {
  const long long total = (long long)a.n * a.m * a.words;
  if (total <= 0) return 0;
  if (a.words != kRowWords && a.words != 1) return (int)cudaErrorInvalidValue;
  own_rows_kernel<<<cc_blocks(total, kThreads), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

struct PartArgs {
  int n, stride, p_off, p_local, max_rf, racks;
  const int* parts;    // parts[k * stride]: the partition id of request k
  const int* members;  // [Pl, max_rf] this shard's member table (global ids)
  const int* prc;      // [Pl, racks] this shard's rack cells
  int* out;            // [n, max_rf + racks]
};

__global__ void own_parts_kernel(PartArgs a) {
  const int width = a.max_rf + a.racks;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)a.n * width) return;
  const long long k = t / width;
  const int w = (int)(t - k * width);
  const int lp = a.parts[k * a.stride] - a.p_off;
  int v = 0;
  if (lp >= 0 && lp < a.p_local) {
    v = w < a.max_rf ? a.members[(size_t)lp * a.max_rf + w]
                     : a.prc[(size_t)lp * a.racks + (w - a.max_rf)];
  }
  a.out[t] = v;
}

CC_EXPORT int cc_own_parts(PartArgs a, void* stream) {
  const long long total = (long long)a.n * (a.max_rf + a.racks);
  if (total <= 0) return 0;
  own_parts_kernel<<<cc_blocks(total, kThreads), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

struct PrcArgs {
  int R, B, P, racks;  // this shard's rows; P the global partitions
  const int* broker;
  const int* part;
  const bool* valid;
  const int* broker_rack;
  int* prc;            // [P, racks], zeroed by the caller
};

__global__ void shard_prc_kernel(PrcArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.R || !a.valid[r]) return;
  const int b = a.broker[r], p = a.part[r];
  if (b < 0 || b >= a.B || p < 0 || p >= a.P) return;
  const int k = a.broker_rack[b];
  if (k < 0 || k >= a.racks) return;
  atomicAdd(&a.prc[(size_t)p * a.racks + k], 1);
}

CC_EXPORT int cc_shard_prc(PrcArgs a, void* stream) {
  if (a.R <= 0) return 0;
  shard_prc_kernel<<<cc_blocks(a.R, kThreads), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
