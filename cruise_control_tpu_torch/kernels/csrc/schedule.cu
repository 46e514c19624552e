// round_schedule: the scalar logic of the fused anneal's round loop, and
// the CUDA graph that runs the whole anneal behind device-side conditionals.
//
// Replaces (cruise_control_tpu/analyzer/engine.py): `_schedule_init`'s t0
// (:2931) and the scalar part of `_fused_round_step` (:2941-3060): the
// early-stop gate, the bounded full-chain checks (`checks_left`), `done`,
// the polish test `full_v > prev_v * 0.9`, the round's temperature `t_r`
// and the per-round ys (accepted, ran, stopped, temperature, cheap).  The
// reference's `lax.scan` over all rounds becomes a conditional WHILE node,
// and its `lax.cond`s around the full-chain check and around the round body
// become conditional IF nodes inside it, whose flags this kernel sets
// (cudaGraphSetConditional).
//
// What bounds it on this card: latency (one thread, a few dozen scalars).
// The first design launched a graph of one round once per scheduled round
// (num_rounds + max_extra_rounds, 16 at the north star): each launch cost
// the host 0.16-0.45 ms, and the rounds after an early stop still ran as
// masked rounds (three one-thread launches behind two IF nodes each).
//
// The loop graph (cc_loop_graph_build), on the engine's captured graphs:
//   child(init) -> WHILE(loop) { K4(gate) -> IF(need_full){ eval }
//     -> K4(decide) -> IF(run){ body [, obj] } -> K4(close) } -> K4(exit)
// `init` seeds the carry and the schedule, `eval` writes full_v, `body`
// (the round's steps and the round prep) writes the round's accepted
// count and cheap signal, `obj` (verbose runs) the round's full
// objective.  CLOSE sets the loop's flag to !done && rnd + 1 <
// min(total, slice_end), so the loop leaves right after the round that
// stops the run; EXIT then writes the ys rows of the rounds it never
// reached, and the state, as the masked rounds of the reference's scan
// would have left them.  The host launches the graph once a run and
// reads nothing until its one sync.
//
// Segmented execution (the JAX package's `_run_segmented`,
// engine.py:3101-3227): the slice graph is the same loop without init,
//   WHILE(loop) { ... } -> K4(exit) [-> IF(over){ post }]
// over the same captured graphs.  INIT sets slice_end to total, so a
// whole run is unchanged; before each slice the host writes base + L into
// slice_end, and the launch runs rounds [base, min(base + L, total)),
// fewer when the run stops.  The WHILE handle's default is 1, so every
// launch enters the loop; the host launches a slice only while the run
// is not done.  EXIT writes the masked rows only when the run is over
// (done; a run that reached total has none left), and at the end of a
// slice that is not the last it does nothing.  It also sets the IF
// handle around `post` (the reported run's after-report and checks), so
// the last slice's launch ends with the report and no slice before it
// runs one.  No slice length has a graph of its own.
// Conditional nodes nested in a WHILE body need CUDA 12.4 or later, in
// the runtime and in the driver (checked before the graph is built).
//
// Convergence diagnostics (SchedDims.diag; `_fused_round_step`'s
// diagnostics ys, engine.py:2996-3046): acc holds six counts (the total,
// then by kind and the prior's, added by select_survivors), the round body
// writes the full chain's objective and G violations into `stage`, and a
// row has Y_BASE + 5 + G columns.  CLOSE copies the counts and the stage
// into the row of a round that ran, the objective into Y_OBJ; a round that
// did not run, EXIT's included, gets 0 counts and NaN violations.  Only
// these one-thread phases read the flag.
#include <stdlib.h>

#include "common.cuh"

// indices into the int state (kernels/schedule.py)
#define S_RND 0
#define S_DONE 1
#define S_CHECKS 2
#define S_HAS_PREV 3
#define S_NEED_FULL 4
#define S_RUN 5
#define S_MAIN_STOP 6
#define S_MAIN_GATE 7
#define S_EXTRA_GATE 8
#define S_LOOP 9
// the round that ends this launch: total for a whole run, base + L for a
// slice of a segmented run (written by the host before the slice)
#define S_SLICE_END 10
// indices into the float state
#define F_T0 0
#define F_TR 1
#define F_CHEAP_PREV 2
#define F_FULL_V 3
#define F_PREV_V 4
#define F_CHEAP 5
#define F_OBJ 6
// columns of a round's ys row (f64)
#define Y_ACC 0
#define Y_RAN 1
#define Y_STOPPED 2
#define Y_TEMP 3
#define Y_CHEAP 4
#define Y_FULL 5
#define Y_OBJ 6
#define Y_BASE 7
// diagnostics: the five counts after the total, then one violation a goal
#define Y_DIAG_COUNTS 5

#define PHASE_INIT 0
#define PHASE_GATE 1
#define PHASE_DECIDE 2
#define PHASE_CLOSE 3
#define PHASE_EXIT 4
// counters (kernels/schedule.py): loop iterations run, of which masked
#define C_ITERS 0
#define C_MASKED 1

struct SchedPtrs {
  int* si;                 // int state
  float* sf;               // float state
  long long* acc;          // the round's accepted count
  const float* decay_pow;  // f32[total]: decay ** round, as the plain version computes it
  double* ys;              // f64[total, ycols(d)]
  int* count;              // i32[2]: rounds the loop ran, of which masked (done or past total)
  const float* stage;      // f32[1 + n_goals]: the round's objective and violations (diag)
};

struct SchedDims {
  int n_main, total, tol_on, checks, verbose;
  float tol, scale;
  int diag, n_goals;
};

__device__ __forceinline__ int ycols(const SchedDims& d) {
  return Y_BASE + (d.diag ? Y_DIAG_COUNTS + d.n_goals : 0);
}

// acc's counts: the total, and the diagnostics' five
__device__ __forceinline__ int n_acc(const SchedDims& d) { return d.diag ? 1 + Y_DIAG_COUNTS : 1; }

// The diagnostics' columns of row y: the counts and the stage's violations
// of a round that ran, else 0 counts and NaN.
__device__ __forceinline__ void diag_cols(const SchedPtrs& p, const SchedDims& d, double* y, bool run) {
  if (!d.diag) return;
  for (int i = 0; i < Y_DIAG_COUNTS; ++i) y[Y_BASE + i] = run ? (double)p.acc[1 + i] : 0.0;
  for (int g = 0; g < d.n_goals; ++g) {
    y[Y_BASE + Y_DIAG_COUNTS + g] = run ? (double)p.stage[1 + g] : (double)__int_as_float(0x7fffffff);
  }
}

// The temperature DECIDE gives round rnd: 0 on the last main round and on
// polish rounds (every round past total is one), else t0 * decay ** rnd.
__device__ __forceinline__ float round_temperature(const SchedPtrs& p, const SchedDims& d, int rnd) {
  const bool cold = rnd >= d.n_main || rnd == d.n_main - 1;
  return cold ? 0.0f : __fmul_rn(p.sf[F_T0], p.decay_pow[rnd]);
}

// The ys row of a round that does not run and checks nothing.
__device__ __forceinline__ void masked_row(const SchedPtrs& p, const SchedDims& d, int rnd) {
  double* y = p.ys + (size_t)rnd * ycols(d);
  y[Y_ACC] = 0.0;
  y[Y_RAN] = 0.0;
  y[Y_STOPPED] = 0.0;
  y[Y_TEMP] = round_temperature(p, d, rnd);
  y[Y_CHEAP] = __int_as_float(0x7f800000);
  y[Y_FULL] = 0.0;
  y[Y_OBJ] = __int_as_float(0x7fffffff);
  diag_cols(p, d, y, false);
}

__global__ void round_schedule_kernel(int phase, SchedPtrs p, SchedDims d, int has_handle,
                                      cudaGraphConditionalHandle handle) {
  int* si = p.si;
  float* sf = p.sf;
  const float inf = __int_as_float(0x7f800000);
  if (phase == PHASE_INIT) {
    si[S_RND] = 0;
    si[S_DONE] = 0;
    si[S_CHECKS] = d.checks;
    si[S_HAS_PREV] = 0;
    si[S_LOOP] = 1;
    si[S_SLICE_END] = d.total;
    sf[F_CHEAP_PREV] = inf;
    sf[F_PREV_V] = inf;
    sf[F_T0] = __fmul_rn(sf[F_OBJ], d.scale);
    p.count[C_ITERS] = 0;
    p.count[C_MASKED] = 0;
    return;
  }
  const int rnd = si[S_RND];
  const bool in_range = rnd < d.total;
  if (phase == PHASE_EXIT) {
    // the run is over when it stopped or reached total; the IF node after
    // EXIT (a slice graph's `post`) runs only then
    if (has_handle) cudaGraphSetConditional(handle, (si[S_DONE] || !in_range) ? 1u : 0u);
    // the rounds the loop never reached, as masked rounds leave them: their
    // ys rows, and the state after the last of them.  Nothing at the end
    // of a slice that is not the last.
    if (!in_range || !si[S_DONE]) return;
    for (int r = rnd; r < d.total; ++r) masked_row(p, d, r);
    si[S_MAIN_GATE] = 0;
    si[S_EXTRA_GATE] = 0;
    si[S_NEED_FULL] = 0;
    si[S_RUN] = 0;
    si[S_MAIN_STOP] = 0;
    sf[F_FULL_V] = inf;
    sf[F_TR] = round_temperature(p, d, d.total - 1);
    for (int i = 0; i < n_acc(d); ++i) p.acc[i] = 0;
    sf[F_CHEAP] = inf;
    sf[F_OBJ] = __int_as_float(0x7fffffff);
    sf[F_CHEAP_PREV] = inf;
    si[S_RND] = d.total;
    return;
  }
  const bool active = !si[S_DONE] && in_range;
  const bool is_extra = rnd >= d.n_main;
  if (phase == PHASE_GATE) {
    p.count[C_ITERS] += 1;
    if (!active) p.count[C_MASKED] += 1;
    const bool main_gate = d.tol_on && active && !is_extra && rnd > 0 && si[S_CHECKS] > 0 &&
                           sf[F_CHEAP_PREV] <= d.tol;
    const bool extra_gate = d.tol_on && active && is_extra;
    si[S_MAIN_GATE] = main_gate;
    si[S_EXTRA_GATE] = extra_gate;
    si[S_NEED_FULL] = main_gate || extra_gate;
    sf[F_FULL_V] = inf;
    if (has_handle) cudaGraphSetConditional(handle, (main_gate || extra_gate) ? 1u : 0u);
    return;
  }
  if (phase == PHASE_DECIDE) {
    bool run = active, main_stop = false;
    if (d.tol_on) {
      const float full_v = sf[F_FULL_V];
      const bool main_gate = si[S_MAIN_GATE], extra_gate = si[S_EXTRA_GATE];
      main_stop = main_gate && full_v <= d.tol;
      if (main_gate && !main_stop) si[S_CHECKS] -= 1;
      const bool extra_stop =
          extra_gate && (full_v <= d.tol || (si[S_HAS_PREV] && full_v > __fmul_rn(sf[F_PREV_V], 0.9f)));
      const bool stop = main_stop || extra_stop;
      if (stop) si[S_DONE] = 1;
      run = active && !stop;
      if (run && is_extra) {
        sf[F_PREV_V] = full_v;
        si[S_HAS_PREV] = 1;
      }
    }
    si[S_RUN] = run;
    si[S_MAIN_STOP] = main_stop;
    sf[F_TR] = round_temperature(p, d, rnd);  // past total: a polish round's 0
    for (int i = 0; i < n_acc(d); ++i) p.acc[i] = 0;
    sf[F_CHEAP] = inf;
    sf[F_OBJ] = __int_as_float(0x7fffffff);  // NaN unless the round runs and reports
    if (has_handle) cudaGraphSetConditional(handle, run ? 1u : 0u);
    return;
  }
  // PHASE_CLOSE
  const bool run = si[S_RUN];
  if (in_range) {
    double* y = p.ys + (size_t)rnd * ycols(d);
    y[Y_ACC] = run ? (double)p.acc[0] : 0.0;
    y[Y_RAN] = run;
    y[Y_STOPPED] = si[S_MAIN_STOP];
    y[Y_TEMP] = sf[F_TR];
    y[Y_CHEAP] = run ? sf[F_CHEAP] : inf;
    y[Y_FULL] = si[S_NEED_FULL];
    const float obj = d.diag ? p.stage[0] : sf[F_OBJ];
    y[Y_OBJ] = run && (d.diag || d.verbose) ? obj : __int_as_float(0x7fffffff);
    diag_cols(p, d, y, run);
  }
  sf[F_CHEAP_PREV] = run ? sf[F_CHEAP] : inf;
  si[S_RND] = rnd + 1;
  const bool loop = !si[S_DONE] && rnd + 1 < min(d.total, si[S_SLICE_END]);
  si[S_LOOP] = loop;
  if (has_handle) cudaGraphSetConditional(handle, loop ? 1u : 0u);
}

// One phase outside any graph (the run's init, and checks against the
// plain version).
CC_EXPORT int cc_round_schedule(int phase, SchedPtrs p, SchedDims d, void* stream) {
  round_schedule_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(phase, p, d, 0, 0);
  return (int)cudaGetLastError();
}

static cudaError_t add_phase(cudaGraph_t g, cudaGraphNode_t* node, const cudaGraphNode_t* dep,
                             int phase, SchedPtrs* p, SchedDims* d, int has_handle,
                             cudaGraphConditionalHandle* h) {
  void* args[5] = {&phase, p, d, &has_handle, h};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)round_schedule_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &kp);
}

// A conditional node of `type` on `h` after `dep` (none if null); its body
// graph is returned in *body.
static cudaError_t add_cond(cudaGraph_t g, cudaGraphNode_t* node, const cudaGraphNode_t* dep,
                            cudaGraphConditionalHandle h, cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = h;
  cp.conditional.type = type;
  cp.conditional.size = 1;
  const cudaError_t e = cudaGraphAddNode(node, g, dep, dep ? 1 : 0, &cp);
  if (e == cudaSuccess) *body = cp.conditional.phGraph_out[0];
  return e;
}

// Child graph nodes running the given graphs in turn after `dep` (each
// added graph is copied); *last is the last node.
static cudaError_t add_children(cudaGraph_t g, const cudaGraphNode_t* dep, cudaGraph_t* graphs,
                                int n, cudaGraphNode_t* last) {
  cudaGraphNode_t prev = dep ? *dep : nullptr;
  for (int i = 0; i < n; ++i) {
    cudaGraphNode_t child;
    const cudaError_t e =
        cudaGraphAddChildGraphNode(&child, g, prev ? &prev : nullptr, prev ? 1 : 0, graphs[i]);
    if (e != cudaSuccess) return e;
    prev = child;
  }
  *last = prev;
  return cudaSuccess;
}

// An IF node on `h` after `dep` whose body runs the given graphs in turn.
static cudaError_t add_if(cudaGraph_t g, cudaGraphNode_t* node, const cudaGraphNode_t* dep,
                          cudaGraphConditionalHandle h, cudaGraph_t* bodies, int n_bodies) {
  cudaGraph_t body;
  const cudaError_t e = add_cond(g, node, dep, h, cudaGraphCondTypeIf, &body);
  if (e != cudaSuccess) return e;
  cudaGraphNode_t last;
  return add_children(body, nullptr, bodies, n_bodies, &last);
}

// The CUDA runtime's and the driver's versions (e.g. 12040 for 12.4).
CC_EXPORT int cc_cuda_versions(int* runtime, int* driver) {
  const cudaError_t e = cudaRuntimeGetVersion(runtime);
  const cudaError_t e2 = cudaDriverGetVersion(driver);
  return (int)(e != cudaSuccess ? e : e2);
}

// A copy node of the loop graph: `bytes` from device memory `src` to
// pinned host memory `dst`.
struct CopySpec {
  void* dst;
  const void* src;
  size_t bytes;
};

// Copy nodes `copies[0..n)` in `g`, each after `dep`.
static cudaError_t add_copies(cudaGraph_t g, cudaGraphNode_t dep, const CopySpec* copies, int n) {
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < n && e == cudaSuccess; ++i) {
    cudaGraphNode_t copy;
    e = cudaGraphAddMemcpyNode1D(&copy, g, &dep, 1, copies[i].dst, copies[i].src, copies[i].bytes,
                                 cudaMemcpyDeviceToHost);
  }
  return e;
}

// The loop graph over the captured graphs `init` (null: the loop alone,
// a segmented run's slice graph), `eval` and `body` (and `obj` when not
// null), then EXIT, and with `post` not null an IF node on the run being
// over around `post` and the `n_post` copies after it (the reported run's
// payload, fetched once, by the last slice), then the `n_copies` copies (a
// slice's device-to-host fetch of the schedule, after everything else);
// instantiated into *exec_out; *graph_out keeps the template for
// cc_loop_graph_destroy.  The copies' host memory is pinned (mapped into
// the device's address space, as a copy in a conditional body needs).
// The loop's handle is set to 1 at every launch.
CC_EXPORT int cc_loop_graph_build(void* init, void* eval, void* body, void* obj, void* post,
                                  const CopySpec* post_copies, int n_post, const CopySpec* copies,
                                  int n_copies, SchedPtrs p, SchedDims d, void** exec_out,
                                  void** graph_out) {
  cudaGraph_t g;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphConditionalHandle h_loop, h_full, h_run, h_over = 0;
  cudaGraphNode_t start = nullptr, loop, gate, if_full, decide, if_run, close, exit_node, if_over;
  cudaGraph_t loop_body, run_bodies[2] = {(cudaGraph_t)body, (cudaGraph_t)obj};
  cudaGraph_t init_g = (cudaGraph_t)init, eval_g = (cudaGraph_t)eval, post_g = (cudaGraph_t)post;
  do {
    if ((e = cudaGraphConditionalHandleCreate(&h_loop, g, 1, cudaGraphCondAssignDefault)) != cudaSuccess)
      break;
    if (init_g && (e = add_children(g, nullptr, &init_g, 1, &start)) != cudaSuccess) break;
    if ((e = add_cond(g, &loop, start ? &start : nullptr, h_loop, cudaGraphCondTypeWhile,
                      &loop_body)) != cudaSuccess)
      break;
    // the IF nodes' handles belong to the graph that holds the nodes
    if ((e = cudaGraphConditionalHandleCreate(&h_full, loop_body, 0, 0)) != cudaSuccess) break;
    if ((e = cudaGraphConditionalHandleCreate(&h_run, loop_body, 0, 0)) != cudaSuccess) break;
    if ((e = add_phase(loop_body, &gate, nullptr, PHASE_GATE, &p, &d, 1, &h_full)) != cudaSuccess) break;
    if ((e = add_if(loop_body, &if_full, &gate, h_full, &eval_g, 1)) != cudaSuccess) break;
    if ((e = add_phase(loop_body, &decide, &if_full, PHASE_DECIDE, &p, &d, 1, &h_run)) != cudaSuccess)
      break;
    if ((e = add_if(loop_body, &if_run, &decide, h_run, run_bodies, obj ? 2 : 1)) != cudaSuccess) break;
    if ((e = add_phase(loop_body, &close, &if_run, PHASE_CLOSE, &p, &d, 1, &h_loop)) != cudaSuccess)
      break;
    if (post_g && (e = cudaGraphConditionalHandleCreate(&h_over, g, 0, 0)) != cudaSuccess) break;
    if ((e = add_phase(g, &exit_node, &loop, PHASE_EXIT, &p, &d, post_g ? 1 : 0, &h_over)) !=
        cudaSuccess)
      break;
    if (post_g) {
      cudaGraph_t over_body;
      cudaGraphNode_t posted;
      if ((e = add_cond(g, &if_over, &exit_node, h_over, cudaGraphCondTypeIf, &over_body)) !=
          cudaSuccess)
        break;
      if ((e = add_children(over_body, nullptr, &post_g, 1, &posted)) != cudaSuccess) break;
      if ((e = add_copies(over_body, posted, post_copies, n_post)) != cudaSuccess) break;
    }
    if ((e = add_copies(g, post_g ? if_over : exit_node, copies, n_copies)) != cudaSuccess) break;
    cudaGraphExec_t ex;
    if ((e = cudaGraphInstantiate(&ex, g, 0)) != cudaSuccess) break;
    *exec_out = (void*)ex;
    *graph_out = (void*)g;
    return 0;
  } while (0);
  cudaGraphDestroy(g);
  // a refused build leaves its error as the runtime's last error, which the
  // next launch of this library would report as its own (the mesh layer's
  // host loop launches round_schedule after a refused build)
  (void)cudaGetLastError();
  return (int)e;
}

// A graph's top-level nodes counted by cudaGraphNodeType: counts[t] for
// t < n (what a captured graph holds, e.g. NCCL's nodes in a round body).
CC_EXPORT int cc_graph_node_types(void* graph, int* counts, int n) {
  size_t num = 0;
  cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &num);
  if (e != cudaSuccess || num == 0) return (int)e;
  cudaGraphNode_t* nodes = (cudaGraphNode_t*)malloc(num * sizeof(cudaGraphNode_t));
  if (nodes == nullptr) return (int)cudaErrorMemoryAllocation;
  e = cudaGraphGetNodes((cudaGraph_t)graph, nodes, &num);
  for (size_t i = 0; e == cudaSuccess && i < num; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e == cudaSuccess && (int)t >= 0 && (int)t < n) counts[(int)t] += 1;
  }
  free(nodes);
  return (int)e;
}

// Launch and destroy any instantiated graph of the package's libraries (the
// loop graph here, the scenario batch graph of scenario.cu): both act on
// opaque handles.
CC_EXPORT int cc_loop_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

CC_EXPORT int cc_loop_graph_destroy(void* exec, void* graph) {
  cudaError_t e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
  return (int)(e != cudaSuccess ? e : e2);
}

// Kernel nodes of a captured graph, child graphs counted through.
static int count_kernels(cudaGraph_t g) {
  size_t n = 0;
  if (cudaGraphGetNodes(g, nullptr, &n) != cudaSuccess || n == 0) return 0;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  int k = 0;
  if (cudaGraphGetNodes(g, nodes, &n) == cudaSuccess) {
    for (size_t i = 0; i < n; ++i) {
      cudaGraphNodeType t;
      if (cudaGraphNodeGetType(nodes[i], &t) != cudaSuccess) continue;
      if (t == cudaGraphNodeTypeKernel) {
        ++k;
      } else if (t == cudaGraphNodeTypeGraph) {
        cudaGraph_t c;
        if (cudaGraphChildGraphNodeGetGraph(nodes[i], &c) == cudaSuccess) k += count_kernels(c);
      }
    }
  }
  delete[] nodes;
  return k;
}

// (all nodes, kernel nodes) of a captured graph.
CC_EXPORT int cc_graph_nodes(void* graph, int* nodes, int* kernel_nodes) {
  size_t n = 0;
  const cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *nodes = (int)n;
  *kernel_nodes = count_kernels((cudaGraph_t)graph);
  return (int)e;
}

// The floor of a one-thread control kernel in a graph: what one kernel
// node of one thread costs inside a WHILE body, the position of
// round_schedule's GATE, DECIDE and CLOSE (and of scenario.cu's step).
// The graph is reset -> WHILE { tick -> empty x extra }: `tick` counts the
// iterations and ends the loop after `iters`, each `empty` does nothing.
// A launch with extra = M less one with extra = 0, over M * iters, is the
// time of one node in that position (chip_smoke.py's bound of the
// one-thread kernels).
__global__ void floor_reset_kernel(int* counter) { counter[0] = 0; }

__global__ void floor_tick_kernel(int* counter, int iters, cudaGraphConditionalHandle h) {
  const int c = ++counter[0];
  cudaGraphSetConditional(h, c < iters ? 1u : 0u);
}

__global__ void floor_empty_kernel() {}

static cudaError_t add_kernel(cudaGraph_t g, cudaGraphNode_t* node, const cudaGraphNode_t* dep,
                              void* func, void** args) {
  cudaKernelNodeParams kp = {};
  kp.func = func;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &kp);
}

CC_EXPORT int cc_node_floor_graph_build(int* counter, int iters, int extra, void** exec_out,
                                        void** graph_out) {
  cudaGraph_t g;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return (int)e;
  do {
    cudaGraphConditionalHandle h;
    cudaGraphNode_t reset, loop, prev;
    cudaGraph_t body;
    if ((e = cudaGraphConditionalHandleCreate(&h, g, 1, cudaGraphCondAssignDefault)) != cudaSuccess)
      break;
    void* reset_args[1] = {&counter};
    if ((e = add_kernel(g, &reset, nullptr, (void*)floor_reset_kernel, reset_args)) != cudaSuccess)
      break;
    if ((e = add_cond(g, &loop, &reset, h, cudaGraphCondTypeWhile, &body)) != cudaSuccess) break;
    void* tick_args[3] = {&counter, &iters, &h};
    if ((e = add_kernel(body, &prev, nullptr, (void*)floor_tick_kernel, tick_args)) != cudaSuccess)
      break;
    for (int i = 0; i < extra && e == cudaSuccess; ++i) {
      cudaGraphNode_t node;
      e = add_kernel(body, &node, &prev, (void*)floor_empty_kernel, nullptr);
      prev = node;
    }
    if (e != cudaSuccess) break;
    cudaGraphExec_t ex;
    if ((e = cudaGraphInstantiate(&ex, g, 0)) != cudaSuccess) break;
    *exec_out = (void*)ex;
    *graph_out = (void*)g;
    return 0;
  } while (0);
  cudaGraphDestroy(g);
  return (int)e;
}
