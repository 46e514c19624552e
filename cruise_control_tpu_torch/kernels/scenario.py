"""scenario_step — the scenario batch's loop on the device.

Replaces: the `jax.lax.map` of `ScenarioEvaluator._evaluate_on_device`
(cruise_control_tpu/analyzer/scenario_eval.py:158-213): its loop index,
the per-scenario outputs it stacks and its end test.  The reference maps
the single-state goal chain over the stacked varying fields in one
program; here the evaluator captures the chain once on a slot state, and
`ScenarioGraph` runs that body behind a conditional WHILE node whose
counter this kernel advances (CUDA 12.4 or later), so the host launches one
graph a batch and syncs once.

Bound on the card: latency — one thread reads the counter and the count,
copies 1 + G floats into the batch's outputs and sets the WHILE handle.

A step stores the slot's objective and violations as row i (i = ctrl[0])
of the outputs when i < n (n = ctrl[1], clamped to the outputs'
capacity), then advances i; in the graph it also sets the loop's handle
to i < n.  `scenario_step_plain` is the same on CPU tensors, where the
evaluator runs the batch as the sequential loop it stands for.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build
from cruise_control_tpu_torch.kernels import schedule as sched_k

_FN = {}


@dataclasses.dataclass
class ScenarioLoop:
    """The batch loop's device state: ctrl i32[2] (index i, count n), the
    slot's outputs (f32[1] objective, f32[G] violations) and the batch's
    (f32[cap], f32[cap, G])."""

    ctrl: torch.Tensor
    obj_slot: torch.Tensor
    viol_slot: torch.Tensor
    obj_out: torch.Tensor
    viol_out: torch.Tensor

    @staticmethod
    def create(cap: int, n_goals: int, device) -> "ScenarioLoop":
        f32 = torch.float32
        return ScenarioLoop(
            ctrl=torch.zeros(2, dtype=torch.int32, device=device),
            obj_slot=torch.zeros(1, dtype=f32, device=device),
            viol_slot=torch.zeros(n_goals, dtype=f32, device=device),
            obj_out=torch.zeros(cap, dtype=f32, device=device),
            viol_out=torch.zeros((cap, n_goals), dtype=f32, device=device),
        )

    @property
    def cap(self) -> int:
        return int(self.obj_out.shape[0])

    @property
    def n_goals(self) -> int:
        return int(self.viol_slot.shape[0])


def scenario_step_plain(s: ScenarioLoop) -> bool:
    """One step on CPU tensors; returns whether the loop goes on (i < n)."""
    i, n = int(s.ctrl[0]), min(int(s.ctrl[1]), s.cap)
    if 0 <= i < n:
        s.obj_out[i] = s.obj_slot[0]
        s.viol_out[i] = s.viol_slot
    s.ctrl[0] = i + 1
    return i + 1 < n


class _Ptrs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in ("ctrl", "obj_slot", "viol_slot", "obj_out", "viol_out")]


class _Dims(ctypes.Structure):
    _fields_ = [("cap", ctypes.c_int), ("n_goals", ctypes.c_int)]


def _lib_fn(name, argtypes):
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(_build.library("scenario"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return fn


def _c(s: ScenarioLoop) -> tuple[_Ptrs, _Dims]:
    cap, G = s.cap, s.n_goals
    for name, t, dtype, shape in (
        ("ctrl", s.ctrl, torch.int32, (2,)), ("obj_slot", s.obj_slot, torch.float32, (1,)),
        ("viol_slot", s.viol_slot, torch.float32, (G,)), ("obj_out", s.obj_out, torch.float32, (cap,)),
        ("viol_out", s.viol_out, torch.float32, (cap, G)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"scenario_step: {name} must be contiguous {dtype}{list(shape)}")
    ptrs = _Ptrs(ctrl=s.ctrl.data_ptr(), obj_slot=s.obj_slot.data_ptr(),
                 viol_slot=s.viol_slot.data_ptr(), obj_out=s.obj_out.data_ptr(),
                 viol_out=s.viol_out.data_ptr())
    return ptrs, _Dims(cap, G)


def scenario_step_cuda(s: ScenarioLoop) -> None:
    ptrs, dims = _c(s)
    fn = _lib_fn("cc_scenario_step", [_Ptrs, _Dims, ctypes.c_void_p])
    _build.check(fn(ptrs, dims, torch.cuda.current_stream(s.ctrl.device).cuda_stream),
                 "scenario_step")
    kernels.count("scenario_step")


def scenario_step(s: ScenarioLoop) -> bool | None:
    """One step: the kernel for CUDA tensors (returns None: the loop's end
    test stays on the device), the plain version for CPU tensors (returns
    whether the loop goes on)."""
    if kernels.route(s.ctrl, s.obj_slot, s.obj_out) == "cpu":
        return scenario_step_plain(s)
    scenario_step_cuda(s)
    return None


class ScenarioGraph:
    """The batch as one instantiated CUDA graph: WHILE{child(body) ->
    step}, over the captured graph `body` (which must outlive it: its
    memory pool holds the buffers the nodes use).  Each launch runs the
    body and the step ctrl[1] times from ctrl[0] = 0 (at least once)."""

    def __init__(self, s: ScenarioLoop, body_graph):
        sched_k.require_conditional_graphs(
            "the scenario batch graph runs a child graph inside a conditional WHILE node")
        self._ptrs, self._dims = _c(s)
        fn = _lib_fn("cc_scenario_graph_build", [ctypes.c_void_p, _Ptrs, _Dims,
                                                 ctypes.POINTER(ctypes.c_void_p),
                                                 ctypes.POINTER(ctypes.c_void_p)])
        self._exec, self._graph = ctypes.c_void_p(), ctypes.c_void_p()
        with kernels.graph_lock():
            status = fn(body_graph.raw_cuda_graph(), self._ptrs, self._dims,
                        ctypes.byref(self._exec), ctypes.byref(self._graph))
        _build.check(status, "scenario graph build")
        self._keep = (s, body_graph)
        self.launches = 0

    def launch(self, stream: int) -> None:
        sched_k.launch_graph_exec(self._exec, stream, "scenario graph")
        self.launches += 1

    def close(self) -> None:
        if self._exec:
            sched_k.destroy_graph_exec(self._exec, self._graph, "scenario graph")
            self._exec = ctypes.c_void_p()
            self._keep = None
