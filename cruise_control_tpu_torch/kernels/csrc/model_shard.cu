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
//  own_rows: replica rows (kRowWords words) and brokers (one word) of ids,
//    as two parts of one launch (hop 2 the rows alone, hop 4 both).
//  own_parts: partition rows (member ids, then the rack cells) of ids.
//  shard_prc: this shard's contribution to every partition x rack cell
//    (atomic integer adds, so their order does not matter), reduce-
//    scattered by the caller to each shard's own rows.
//
// Bound: the latency of a few dependent loads, not bytes or operations
// (a step's bundles are a few MB).  So each kernel issues its loads as
// early and as wide as the data lets it, and keeps a warp on one path:
//  shard_sources: block ranges by kind, the importance-sampled slots
//    first.  Every block reads the step's key row and the generation block
//    once, into shared memory (cp.async).  An importance-sampled slot is
//    a team of four lanes: lanes 0-2 hash its source, slot and fallback
//    draws at once, the values reach the team by shuffles; the broker CDF
//    is staged in shared memory while they hash (the blocks of these
//    slots only, where 4 B <= SOURCES_CDF_SMEM_MAX, kernels/model_shard.py:
//    each such block copies the whole CDF, which costs more than the
//    probes it saves past ~6,000 brokers), so the ~12 probes of the search
//    run there; then the four lanes load count,
//    below, count_local and start_local at the broker in one instruction,
//    and one lane the order row.  A uniform slot is a thread: one hash, one
//    store; on a shard other than 0 it stores a zero and reads nothing.
//  own_rows: the broker words (hop 4's relocation and swap members) are a
//    thread an id; a whole row is a thread an id that tests ownership, then
//    issues its ten column loads and the two 16-byte load rows before any
//    is used, and a warp's 32 rows leave through shared memory as 18
//    coalesced stores.  Hop 4 is one launch: block ranges by part.
// Nothing here is worth tensor cores or TMA.
#include <cuda_pipeline.h>

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kRowWords = 18;  // kernels/model_shard.py ROW_FIELDS
constexpr unsigned kFull = 0xffffffffu;

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
constexpr int kKeyWords = sizeof(StepKeys) / sizeof(int);

struct SourceArgs {
  int K_r, K_s, K_l, n_imp_r, n_imp_s, B, r_off, r_local, shard, step, steps_per_round;
  int cdf_in_smem;          // the CDF fits the shared memory budget
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

constexpr int kSrcTeam = 4;                          // lanes of an importance-sampled slot
constexpr int kImpPerBlock = kThreads / kSrcTeam;

__device__ __forceinline__ float unit(const Key2& k, unsigned long long i) {
  return cc_unit_float(k.k0, k.k1, i);
}

// The t-th uniformly drawn slot (the relocations' uniform head, the swap
// sources', the swap partners, the leadership targets): its slot, its
// draw's kind (0-3) and counter; -1 past the end.
__device__ __forceinline__ int uniform_slot(const SourceArgs& a, int t, int& kind, int& i) {
  const int nu_r = a.K_r - a.n_imp_r, nu_s = a.K_s - a.n_imp_s;
  kind = 0, i = t;
  if (t < nu_r) return t;
  t -= nu_r, kind = 1, i = t;
  if (t < nu_s) return a.K_r + t;
  t -= nu_s, kind = 2, i = t;
  if (t < a.K_s) return a.K_r + a.K_s + t;
  t -= a.K_s, kind = 3, i = t;
  return t < a.K_l ? a.K_r + 2 * a.K_s + t : -1;
}

// Blocks [0, nb_imp): the importance-sampled slots (`_sample_sources`'
// two-stage draw, resolved by ownership of the group position), a team of
// kSrcTeam lanes each; then the uniformly drawn slots, a thread each.
__global__ void __launch_bounds__(kThreads) shard_sources_kernel(SourceArgs a) {
  extern __shared__ float4 s_cdf4[];
  __shared__ StepKeys s_keys;
  __shared__ GenParams s_gen;
  const int n_imp = a.n_imp_r + a.n_imp_s;
  const int nb_imp = (n_imp + kImpPerBlock - 1) / kImpPerBlock;
  const bool imp = (int)blockIdx.x < nb_imp;
  if (!imp && a.shard != 0) {
    // the uniform draws are written by shard 0 alone
    int kind, i;
    const int t = ((int)blockIdx.x - nb_imp) * kThreads + (int)threadIdx.x;
    const int slot = uniform_slot(a, t, kind, i);
    if (slot >= 0) a.out[slot] = 0;
    return;
  }
  // the key row (after the round index) and the generation block, then
  // the CDF in the importance blocks: two commit groups
  if (threadIdx.x < 32) {
    const int* row = reinterpret_cast<const int*>(
        a.key_table + ((size_t)(*a.rnd) * a.steps_per_round + a.step));
    if (threadIdx.x < kKeyWords) {
      __pipeline_memcpy_async(reinterpret_cast<int*>(&s_keys) + threadIdx.x, row + threadIdx.x,
                              sizeof(int));
    }
  } else if (threadIdx.x < 32 + kGenWords) {
    const int w = threadIdx.x - 32;
    __pipeline_memcpy_async(reinterpret_cast<int*>(&s_gen) + w, a.gen + w, sizeof(int));
  }
  __pipeline_commit();
  const bool staged = imp && a.cdf_in_smem;
  float* s_cdf = reinterpret_cast<float*>(s_cdf4);
  if (staged) {
    const int n4 = (reinterpret_cast<uintptr_t>(a.cdf) & 15) == 0 ? a.B >> 2 : 0;
    for (int j = threadIdx.x; j < n4; j += kThreads) {
      __pipeline_memcpy_async(s_cdf4 + j, reinterpret_cast<const float4*>(a.cdf) + j, 16);
    }
    for (int j = 4 * n4 + threadIdx.x; j < a.B; j += kThreads) {
      __pipeline_memcpy_async(s_cdf + j, a.cdf + j, sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncthreads();
  if (!imp) {
    int kind, i;
    const int t = ((int)blockIdx.x - nb_imp) * kThreads + (int)threadIdx.x;
    const int slot = uniform_slot(a, t, kind, i);
    if (slot < 0) return;
    const Key2& k = kind == 0 ? s_keys.rel_src[0]
                    : kind == 1 ? s_keys.swap_src[0]
                    : kind == 2 ? s_keys.swap_q
                                : s_keys.lead;
    a.out[slot] = cc_uniform_idx(unit(k, (unsigned long long)i), s_gen.n_source);
    return;
  }
  // a team of lanes an importance-sampled slot; past the last slot a team
  // repeats it and stores nothing, so every shuffle sees all 32 lanes
  const int L = threadIdx.x & (kSrcTeam - 1);
  const int base = (threadIdx.x & 31) & ~(kSrcTeam - 1);
  const int v_raw = blockIdx.x * kImpPerBlock + threadIdx.x / kSrcTeam;
  const bool on = v_raw < n_imp;
  const int v = min(v_raw, n_imp - 1);
  const bool rel = v < a.n_imp_r;
  const int ii = rel ? v : v - a.n_imp_r;
  const int slot = rel ? a.K_r - a.n_imp_r + ii : a.K_r + (a.K_s - a.n_imp_s) + ii;
  const Key2* ks = rel ? s_keys.rel_src : s_keys.swap_src;
  // lanes 0, 1, 2: the source's, the slot's and the fallback's draws
  const float u = unit(ks[1 + min(L, 2)], (unsigned long long)ii);
  const float u_src = __shfl_sync(kFull, u, base);
  const float u_slot = __shfl_sync(kFull, u, base + 1);
  const float u_fb = __shfl_sync(kFull, u, base + 2);
  if (staged) {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  const float* cdf = staged ? s_cdf : a.cdf;
  // torch.searchsorted(right=True): the first index whose value is > u
  int lo = 0, hi = a.B;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(cdf[mid] > u_src)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int bsel = max(0, min(lo, s_gen.n_brokers - 1));
  // the broker's four plan words, a lane each, in one load instruction
  const int* col = L == 0 ? a.count : L == 1 ? a.below : L == 2 ? a.count_local : a.start_local;
  const int x = col[bsel];
  const int cnt = __shfl_sync(kFull, x, base);
  const int below = __shfl_sync(kFull, x, base + 1);
  const int cnt_local = __shfl_sync(kFull, x, base + 2);
  const int start = __shfl_sync(kFull, x, base + 3);
  if (!on || L != 0) return;
  int id = 0;
  if (cnt <= 0) {
    if (a.shard == 0) id = cc_uniform_idx(u_fb, s_gen.n_source);
  } else {
    const int lj = __float2int_rz(__fmul_rn(u_slot, (float)cnt)) - below;
    if (lj >= 0 && lj < cnt_local) {
      id = a.order_local[max(0, min(start + lj, a.r_local - 1))] + a.r_off;
    }
  }
  a.out[slot] = id;
}

CC_EXPORT int cc_shard_sources(SourceArgs a, void* stream) {
  const long long n = (long long)a.K_r + 2LL * a.K_s + a.K_l;
  if (n <= 0) return 0;
  const int n_imp = a.n_imp_r + a.n_imp_s;
  if (a.gen == nullptr || a.key_table == nullptr || a.rnd == nullptr || a.n_imp_r < 0 ||
      a.n_imp_s < 0 || a.n_imp_r > a.K_r || a.n_imp_s > a.K_s ||
      (n_imp > 0 && (a.cdf == nullptr || a.count == nullptr || a.count_local == nullptr ||
                     a.below == nullptr || a.start_local == nullptr ||
                     a.order_local == nullptr || a.B <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = a.cdf_in_smem && n_imp > 0 ? sizeof(float) * (size_t)a.B : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        shard_sources_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned int blocks = cc_blocks(n_imp, kImpPerBlock) + cc_blocks(n - n_imp, kThreads);
  shard_sources_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
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
  const float* load_leader;    // [Rl, 4], 16-byte rows
  const float* load_follower;  // [Rl, 4]
};

// One part of a launch: the ids of n request rows, m ids a row
// (ids[(k / m) * stride + k % m]), and where their words go.
struct RowPart {
  int n, m, stride;
  const int* ids;
  int* out;  // [n * m, words]
};

struct RowArgs {
  int r_off, r_local;
  RowSrc src;
  RowPart brokers;  // one word an id: the broker
  RowPart rows;     // kRowWords an id
};

constexpr int kRowThreads = 128;
constexpr int kPitch = kRowWords + 1;  // a row's words in shared memory (no bank conflicts)

__device__ __forceinline__ int local_row(const RowArgs& a, const RowPart& p, int k) {
  return p.ids[(k / p.m) * p.stride + k % p.m] - a.r_off;
}

// Blocks [0, nb_b): the broker part, a thread an id; then the row part, a
// thread an id, a warp's 32 rows stored through shared memory.
__global__ void __launch_bounds__(kRowThreads) own_rows_kernel(RowArgs a) {
  __shared__ int s_rows[kRowThreads * kPitch];
  const int total_b = a.brokers.n * a.brokers.m;
  const int nb_b = (total_b + kRowThreads - 1) / kRowThreads;
  if ((int)blockIdx.x < nb_b) {
    const int k = blockIdx.x * kRowThreads + threadIdx.x;
    if (k >= total_b) return;
    const int li = local_row(a, a.brokers, k);
    a.brokers.out[k] = li >= 0 && li < a.r_local ? a.src.broker[li] : 0;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = a.rows.n * a.rows.m;
  const int k0 = ((int)blockIdx.x - nb_b) * kRowThreads + warp * 32;
  const int k = k0 + lane;
  int v[kRowWords];
#pragma unroll
  for (int w = 0; w < kRowWords; ++w) v[w] = 0;
  const int li = k < total ? local_row(a, a.rows, k) : -1;
  if (li >= 0 && li < a.r_local) {
    // every load issued before any value is used
    const RowSrc& s = a.src;
    const float4 ll = reinterpret_cast<const float4*>(s.load_leader)[li];
    const float4 lf = reinterpret_cast<const float4*>(s.load_follower)[li];
    v[0] = s.broker[li];
    v[1] = s.part[li];
    v[2] = s.disk[li];
    v[3] = s.topic[li];
    v[4] = s.valid[li] ? 1 : 0;
    v[5] = s.lead[li] ? 1 : 0;
    v[6] = s.pos[li];
    v[7] = s.orig_broker[li];
    v[8] = s.orig_lead[li] ? 1 : 0;
    v[9] = s.orig_disk[li];
    v[10] = __float_as_int(ll.x);
    v[11] = __float_as_int(ll.y);
    v[12] = __float_as_int(ll.z);
    v[13] = __float_as_int(ll.w);
    v[14] = __float_as_int(lf.x);
    v[15] = __float_as_int(lf.y);
    v[16] = __float_as_int(lf.z);
    v[17] = __float_as_int(lf.w);
  }
  int* sw = s_rows + warp * 32 * kPitch;
#pragma unroll
  for (int w = 0; w < kRowWords; ++w) sw[lane * kPitch + w] = v[w];
  __syncwarp();
  // the warp's rows are kRowWords * 32 consecutive words of the output
  const int words = min(32, total - k0) * kRowWords;
  int* out = a.rows.out + (size_t)k0 * kRowWords;
#pragma unroll
  for (int j = 0; j < kRowWords; ++j) {
    const int f = j * 32 + lane;
    if (f < words) out[f] = sw[(f / kRowWords) * kPitch + f % kRowWords];
  }
}

__host__ static bool part_ok(const RowPart& p, long long& total) {
  total = (long long)p.n * p.m;
  if (p.n < 0 || p.m < 0 || total > (1LL << 31) / kRowWords) return false;
  return total == 0 || (p.ids != nullptr && p.out != nullptr && p.m >= 1 && p.stride >= p.m);
}

CC_EXPORT int cc_own_rows(RowArgs a, void* stream) {
  long long nb, nr;
  if (!part_ok(a.brokers, nb) || !part_ok(a.rows, nr)) return (int)cudaErrorInvalidValue;
  if (nb + nr == 0) return 0;
  if (nr > 0 && ((reinterpret_cast<uintptr_t>(a.src.load_leader) |
                  reinterpret_cast<uintptr_t>(a.src.load_follower)) & 15) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  const unsigned int blocks = cc_blocks(nb, kRowThreads) + cc_blocks(nr, kRowThreads);
  own_rows_kernel<<<blocks, kRowThreads, 0, (cudaStream_t)stream>>>(a);
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
