// scenario_step: the scenario batch's loop counter, and the CUDA graph that
// scores a whole what-if batch behind one device-side WHILE node.
//
// Replaces (cruise_control_tpu/analyzer/scenario_eval.py): the
// `jax.lax.map` over the stacked varying fields in `_evaluate_on_device`
// (:158-213): its loop index, the per-scenario outputs it stacks
// (objective and per-goal violations), and the loop's end test.  The
// single-state program that `lax.map` runs once per scenario is the goal
// chain, captured once by the evaluator (kernels/scenario.py).
//
// What bounds it on this card: latency (one thread reads the counter and
// the count, copies 1 + G floats and sets the WHILE handle).
//
// The batch graph (cc_scenario_graph_build), on the evaluator's captured
// body:
//   WHILE(h, default 1) { child(body) -> K1(step) }
// `body` copies scenario i's varying fields from the stacked buffers into
// the slot state (i read on the device from ctrl[0]), evaluates the goal
// chain on the slot and writes the objective and violations into the
// slot's outputs; the step kernel stores them as row i of the batch's
// outputs, advances i and sets the handle to i < n, with n read on the
// device from ctrl[1].  So one instantiated graph serves every batch size
// up to the stacked buffers' capacity and any contents: the host fills
// ctrl = {0, n} and the buffers, launches the graph once, and syncs once.
// A conditional WHILE node whose body holds a child graph needs CUDA 12.4
// or later in the runtime and the driver (checked before the build).
#include "common.cuh"

struct ScenarioPtrs {
  int* ctrl;               // i32[2]: the scenario index i, the batch size n
  const float* obj_slot;   // f32[1]: the slot's objective
  const float* viol_slot;  // f32[G]: the slot's per-goal violations
  float* obj_out;          // f32[cap]: the batch's objectives
  float* viol_out;         // f32[cap, G]: the batch's violations
};

struct ScenarioDims {
  int cap, n_goals;
};

__global__ void scenario_step_kernel(ScenarioPtrs p, ScenarioDims d, int has_handle,
                                     cudaGraphConditionalHandle handle) {
  const int i = p.ctrl[0];
  int n = p.ctrl[1];
  n = n < d.cap ? n : d.cap;
  if (i >= 0 && i < n) {
    p.obj_out[i] = p.obj_slot[0];
    float* row = p.viol_out + (size_t)i * d.n_goals;
    for (int g = 0; g < d.n_goals; ++g) row[g] = p.viol_slot[g];
  }
  p.ctrl[0] = i + 1;
  if (has_handle) cudaGraphSetConditional(handle, i + 1 < n ? 1u : 0u);
}

// One step outside any graph (checks against the plain version).
CC_EXPORT int cc_scenario_step(ScenarioPtrs p, ScenarioDims d, void* stream) {
  scenario_step_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(p, d, 0, 0);
  return (int)cudaGetLastError();
}

// The batch graph over the captured `body`, instantiated into *exec_out;
// *graph_out keeps the template.  Both are opaque to the caller, which
// launches and destroys them through schedule.cu's cc_loop_graph_launch and
// cc_loop_graph_destroy.  The loop's handle is 1 at every launch, so the
// body runs at least once.
CC_EXPORT int cc_scenario_graph_build(void* body, ScenarioPtrs p, ScenarioDims d, void** exec_out,
                                      void** graph_out) {
  cudaGraph_t g;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return (int)e;
  do {
    cudaGraphConditionalHandle h;
    if ((e = cudaGraphConditionalHandleCreate(&h, g, 1, cudaGraphCondAssignDefault)) != cudaSuccess)
      break;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = h;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    cudaGraphNode_t loop;
    if ((e = cudaGraphAddNode(&loop, g, nullptr, 0, &cp)) != cudaSuccess) break;
    cudaGraph_t loop_body = cp.conditional.phGraph_out[0];
    cudaGraphNode_t child, step;
    if ((e = cudaGraphAddChildGraphNode(&child, loop_body, nullptr, 0, (cudaGraph_t)body)) !=
        cudaSuccess)
      break;
    int has_handle = 1;
    void* args[4] = {&p, &d, &has_handle, &h};
    cudaKernelNodeParams kp = {};
    kp.func = (void*)scenario_step_kernel;
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    if ((e = cudaGraphAddKernelNode(&step, loop_body, &child, 1, &kp)) != cudaSuccess) break;
    cudaGraphExec_t ex;
    if ((e = cudaGraphInstantiate(&ex, g, 0)) != cudaSuccess) break;
    *exec_out = (void*)ex;
    *graph_out = (void*)g;
    return 0;
  } while (0);
  cudaGraphDestroy(g);
  return (int)e;
}
