// select_survivors: conflict resolution of the accepted candidates, and the
// step's bookkeeping around it.
//
// Replaces (cruise_control_tpu/analyzer/engine.py): `_select` (:2643) and,
// of `_accept_select_apply` (:2669-2699), the extended relocation mask
// sv_r_ext = [sv_r, sv_s, sv_s] the scatter reads and the survivor count
// accepted = survive.sum().
//
// A candidate survives when it is accepted and, in each of its four
// segments (src broker, dst broker, B + part1, B + part2), it is the
// lowest-ranked accepted candidate, rank being the stable order of
// (delta, index).
//
// What bounds it on this card: latency.  A step reads ~21 B a candidate and
// writes ~3 B (~0.1 us of HBM time at K = 16,384); what costs is the
// chain of dependent steps.  The first design paid three graph nodes a
// step: a memset of all B + P segment minima (1.6 MB at the north star,
// of which at most 4 K are touched), a min kernel, and a keep kernel that
// existed only to wait for the minima; the engine added a cat and a
// sum + add_ around them.
//
// Design: one cooperative launch of at most one block an SM (so that every
// block is resident at once) that sweeps the K candidates twice, with a
// grid-wide barrier (grid.sync()) between the passes.  A thread-block
// cluster's barrier is cheaper, but a cluster spans at most 16 SMs, and
// the step's ~4 K scattered atomics and ~4 K scattered loads then queue on
// those few SMs' memory pipelines; spread over every SM they do not.
// Pass 1 takes an atomicMin of each accepted candidate's 64-bit key into
// its in-range segments (out-of-range ones are dropped, as segment_min
// drops them); pass 2 keeps a candidate whose key is every one of its
// segments' minimum (a read clamps its index, as the reference's gather
// does), writes the survivor mask and the extended relocation mask, and
// adds each block's survivor count into the run's accumulator with one
// integer atomic.
//
// No clear a step: a key is
//   [(2^E - 1 - epoch) : E bits][order-preserving bits of delta : 32][index : 32 - E]
// with 32 - E the index bits K needs.  The epoch, 1 + round * steps + step
// (the round index read on the device), grows through a run, so within a
// step the keys order as the stable argsort of (delta, index) does, and a
// minimum an earlier step left is larger than every fresh key and never
// equal to one.  The minima are cleared once per run, to all ones (the
// tag of epoch 0, which no step uses).
//
// Convergence diagnostics (`select_survivors_kernel<true>`, the second
// instantiation, so the default one is unchanged): pass 2 also tallies the
// survivors by kind (relocations [0, n_r), swaps [n_r, n_r + n_s),
// leadership transfers after them) and, from the candidates kernel's
// took-the-prior mask over the relocations (null without the prior), the
// prior-drawn candidates and those that survived; each block adds its six
// counts into acc[0..5] (the `stats` of `_accept_select_apply`,
// engine.py:2699-2711).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

struct SelectArgs {
  const bool* accept;             // [K]
  const float* delta;             // [K]
  const int* src;                 // [K]
  const int* dst;                 // [K]
  const int* part1;               // [K]
  const int* part2;               // [K]
  unsigned long long* segmin;     // [B + P], epoch-tagged minima
  bool* survive;                  // [K]
  bool* sv_r;                     // [n_r + 2 n_s]
  unsigned long long* acc;        // i64[1], the survivor count is added
  const int* rnd;                 // i32[1], the run's round index; null: round 0
  const bool* from_prior;         // [n_r] relocations drawn from the prior; null: none
  int K, B, P, n_r, n_s, idx_bits, step, steps;
  int diag;                       // acc is i64[6]: the diagnostics counts
};

constexpr int kThreads = 256;

// -0.0 ranks equal to +0.0 (as in argsort); the unsigned order of the
// result is the float order
__device__ __forceinline__ unsigned int ordered_bits(float delta) {
  unsigned int b = __float_as_uint(delta);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One candidate as both passes see it: accepted, its key, its segments.
struct Cand {
  bool accepted;
  unsigned long long key;
  long long seg[4];
};

__device__ __forceinline__ Cand load_cand(const SelectArgs& a, int k, unsigned long long tag) {
  Cand c;
  c.accepted = a.accept[k];
  c.key = tag | ((unsigned long long)ordered_bits(a.delta[k]) << a.idx_bits) | (unsigned int)k;
  c.seg[0] = a.src[k];
  c.seg[1] = a.dst[k];
  c.seg[2] = (long long)a.B + a.part1[k];
  c.seg[3] = (long long)a.B + a.part2[k];
  return c;
}

// pass 1: the key into each in-range segment (a candidate of one partition
// has part2 == part1: one atomic there)
__device__ __forceinline__ void take_min(const SelectArgs& a, const Cand& c, long long n_seg) {
  if (!c.accepted) return;
  for (int i = 0; i < 4; ++i) {
    if (i == 3 && c.seg[3] == c.seg[2]) break;
    if (c.seg[i] >= 0 && c.seg[i] < n_seg) atomicMin(&a.segmin[c.seg[i]], c.key);
  }
}

// pass 2: whether the key is each segment's minimum (the four reads, which
// clamp, issued together), and the masks written
__device__ __forceinline__ int keep(const SelectArgs& a, const Cand& c, int k, long long n_seg) {
  bool kept = false;
  if (c.accepted) {
    unsigned long long m[4];
    for (int i = 0; i < 4; ++i) {
      const long long s = c.seg[i] < 0 ? 0 : (c.seg[i] >= n_seg ? n_seg - 1 : c.seg[i]);
      m[i] = (i == 3 && c.seg[3] == c.seg[2]) ? c.key : __ldcg(&a.segmin[s]);
    }
    kept = m[0] == c.key && m[1] == c.key && m[2] == c.key && m[3] == c.key;
  }
  a.survive[k] = kept;
  if (k < a.n_r) {
    a.sv_r[k] = kept;
  } else if (k < a.n_r + a.n_s) {
    a.sv_r[k] = kept;
    a.sv_r[k + a.n_s] = kept;
  }
  return kept ? 1 : 0;
}

// DIAG: a kept candidate's kind, and the prior counts, into t[0..4]
// (replica, swap, leadership, prior candidates, prior survivors)
template <bool DIAG>
__device__ __forceinline__ void tally(const SelectArgs& a, int k, int kept, int t[5]) {
  if (!DIAG) return;
  t[k < a.n_r ? 0 : (k < a.n_r + a.n_s ? 1 : 2)] += kept;
  if (k < a.n_r && a.from_prior != nullptr) {
    const int fp = a.from_prior[k] ? 1 : 0;
    t[3] += fp;
    t[4] += fp & kept;
  }
}

template <bool DIAG>
__global__ void __launch_bounds__(kThreads) select_survivors_kernel(SelectArgs a) {
  cg::grid_group grid = cg::this_grid();
  const unsigned int epoch = 1u + (unsigned int)((a.rnd ? *a.rnd : 0) * a.steps + a.step);
  const int E = 32 - a.idx_bits;
  const unsigned long long tag = (unsigned long long)((1u << E) - 1u - epoch) << (32 + a.idx_bits);
  const long long n_seg = (long long)a.B + a.P;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;

  // the thread's first candidate stays in registers across the barrier;
  // later ones (K above the grid's threads) are loaded again
  Cand c0 = {};
  if (first < a.K) {
    c0 = load_cand(a, first, tag);
    take_min(a, c0, n_seg);
  }
  for (int k = first + stride; k < a.K; k += stride) take_min(a, load_cand(a, k, tag), n_seg);
  grid.sync();  // its fence makes every block's atomics visible to every block

  int t[5] = {0, 0, 0, 0, 0};
  int kept = 0;
  if (first < a.K) {
    kept = keep(a, c0, first, n_seg);
    tally<DIAG>(a, first, kept, t);
  }
  for (int k = first + stride; k < a.K; k += stride) {
    const int kk = keep(a, load_cand(a, k, tag), k, n_seg);
    kept += kk;
    tally<DIAG>(a, k, kk, t);
  }

  // block sums of the counts, one integer atomic each
  constexpr int kCounts = DIAG ? 6 : 1;
  __shared__ int warp_sum[kCounts][kThreads / 32];
  for (int j = 0; j < kCounts; ++j) {
    const int v = __reduce_add_sync(0xFFFFFFFFu, j == 0 ? kept : t[j - 1]);
    if ((threadIdx.x & 31) == 0) warp_sum[j][threadIdx.x >> 5] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    for (int j = 0; j < kCounts; ++j) {
      int v = threadIdx.x < kThreads / 32 ? warp_sum[j][threadIdx.x] : 0;
      v = __reduce_add_sync(0xFFFFFFFFu, v);
      if (threadIdx.x == 0 && v != 0) atomicAdd(a.acc + j, (unsigned long long)v);
    }
  }
}

// One cooperative launch of at most one block an SM (`n_sm` blocks: all
// resident at once, as grid.sync() needs); K above n_sm x kThreads sweeps
// again.
CC_EXPORT int cc_select_survivors(SelectArgs a, int n_sm, void* stream) {
  if (a.K <= 0) return 0;
  const unsigned int need = cc_blocks(a.K, kThreads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(need < (unsigned int)n_sm ? need : (unsigned int)n_sm);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = a.diag ? cudaLaunchKernelEx(&cfg, select_survivors_kernel<true>, a)
                               : cudaLaunchKernelEx(&cfg, select_survivors_kernel<false>, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
