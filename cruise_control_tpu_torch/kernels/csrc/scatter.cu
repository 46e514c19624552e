// scatter_loads: the streaming cycle's window scatter of new per-replica
// loads into the live f32[R, 4] leader and follower load tables.
//
// Replaces (cruise_control_tpu): models/whatif.py
// `_make_scatter_partition_loads` (:393) and the first lines of
// analyzer/engine.py `_cycle_impl` (:3446-3448): `ll.at[rows].set(new_ll,
// mode="drop")` and the same for the follower table.  For i < n, row
// rows[i] of both tables takes row i of the new tables; a row in [-R, 0)
// counts from the end (as a JAX index does), any other row outside [0, R)
// is dropped.  Rows of one window are unique (each replica of a changed
// partition appears once); duplicate rows have no defined winner, as in
// JAX.
//
// What bounds it on this card: bytes.  A row reads its index (4 B) and two
// new rows of four floats (32 B) and writes two rows (32 B): 68 B a row,
// ~34 MB for a window that drifts every replica of the north star (500,245
// rows), ~10 us of HBM time; a window of a few thousand rows is launch
// latency.
//
// Design: the count n is read from device memory and the rows from a
// staging buffer of fixed capacity, so one launch shape serves every
// window width and the launch can sit in a captured CUDA graph that is
// replayed window after window.  A fixed grid (at most kMaxBlocks blocks)
// walks the n rows with a grid-stride loop, one row a thread, each load
// and store 16 bytes; an empty window exits at once.
#include "common.cuh"

constexpr int kThreads = 256;
// 8 blocks of 256 threads on each of the 132 SMs
constexpr int kMaxBlocks = 132 * 8;

__global__ void __launch_bounds__(kThreads) scatter_loads_kernel(
    float4* __restrict__ ll, float4* __restrict__ fl, const int* __restrict__ rows,
    const float4* __restrict__ new_ll, const float4* __restrict__ new_fl,
    const int* __restrict__ n_ptr, int R, int cap) {
  int n = *n_ptr;
  n = n < cap ? n : cap;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int r = rows[i];
    if (r < 0) r += R;
    if (r < 0 || r >= R) continue;
    ll[r] = new_ll[i];
    fl[r] = new_fl[i];
  }
}

// ll, fl: f32[R, 4]; rows: i32[cap]; new_ll, new_fl: f32[cap, 4]; n: i32[1]
// (device memory, clamped to [0, cap] by the kernel).  Returns the launch's
// cudaError_t.
CC_EXPORT int cc_scatter_loads(void* ll, void* fl, const void* rows, const void* new_ll,
                               const void* new_fl, const void* n, int R, int cap, void* stream) {
  unsigned int blocks = cc_blocks(cap, kThreads);
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  if (blocks == 0) return 0;
  scatter_loads_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float4*)ll, (float4*)fl, (const int*)rows, (const float4*)new_ll, (const float4*)new_fl,
      (const int*)n, R, cap);
  return (int)cudaGetLastError();
}
