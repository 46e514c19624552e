"""round_schedule — the fused anneal's round loop on the device.

Replaces: `_schedule_init`'s t0 and the scalar logic of `_fused_round_step`
(cruise_control_tpu/analyzer/engine.py:2931, :2941-3060): the early-stop
gate and the bounded full-chain checks, `done`, the polish-round test
`full_v > prev_v * 0.9`, the round's temperature and the per-round ys.
The reference's `lax.scan` over the rounds becomes a conditional WHILE
node and its `lax.cond`s conditional IF nodes inside it (CUDA 12.4 or
later), in one graph built here around the engine's captured graphs
(`LoopGraph`): the host launches it once a run.

Bound on the card: latency — one thread reads and writes a few dozen
scalars; a loop iteration is three one-thread launches around the round's
conditional bodies.

A round is four phases on one `Schedule`: GATE (is a full-chain check
due: sets `need_full`), then the check if due (the engine writes `full_v`),
DECIDE (stop or run; the round's temperature), then the round body if it
runs (the engine writes the accepted count and the cheap signal, and in a
verbose run the objective), CLOSE (the round's ys row; the next round;
`loop`: whether another round follows, false once the run is done).  INIT
seeds the schedule from the initial objective; EXIT, after the loop, writes
the rounds the loop never reached as the reference's masked rounds would
(their ys rows, and the state after them), so the ys and the final state
equal those of running every scheduled round.  `schedule_plain` is the same
logic on CPU tensors in f32 arithmetic.

Segmented execution (the JAX package's `_run_segmented`,
engine.py:3101-3227): a launch ends at the round in `SLICE_END` as well,
which INIT sets to `total` and the host sets to base + L before each
slice; the slice graph is the loop without init (`LoopGraph(init_graph=
None)`), so every slice length replays one instantiated graph.  EXIT writes
the masked rows only once the run is over (done, or every scheduled round
reached): at the end of a slice that is not the last it does nothing.  With
`post_graph` the graph ends with an IF node that runs it once the run is
over, so the last slice's launch also runs the reported run's
after-report and checks.

With convergence diagnostics (`ScheduleDims.diag`; `_fused_round_step`'s
diagnostics ys, engine.py:2996-3046) the accumulator holds the step
kernels' six counts (kernels/select.py DIAG_FIELDS), the round body
writes the full chain's objective and per-goal violations of the
post-round carry into the f32[1 + G] `stage`, and each ys row gains
DIAG_YS and G violation columns: CLOSE copies the counts and the stage
into the row of a round that ran (the objective into `objective`), and a
round that did not run, EXIT's included, gets 0 counts and NaN
violations.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.kernels import _build

INIT, GATE, DECIDE, CLOSE, EXIT = range(5)
#: int state (csrc/schedule.cu S_*)
RND, DONE, CHECKS, HAS_PREV, NEED_FULL, RUN, MAIN_STOP, MAIN_GATE, EXTRA_GATE, LOOP, SLICE_END = range(11)
N_INT = 11
#: counters (csrc/schedule.cu C_*): loop iterations run, of which masked
ITERS, MASKED = range(2)
#: the CUDA version (runtime and driver) that runs IF nodes inside a WHILE body
MIN_CUDA = 12040
#: float state (csrc/schedule.cu F_*)
T0, T_R, CHEAP_PREV, FULL_V, PREV_V, CHEAP, OBJ = range(7)
N_FLOAT = 7
#: ys columns (csrc/schedule.cu Y_*)
YS = ("accepted", "ran", "stopped", "temperature", "cheap", "full_check", "objective")
#: the ys columns diagnostics add after YS (the accumulator's counts after
#: the total), then one column a goal: its violation
DIAG_YS = ("acc_replica", "acc_swap", "acc_lead", "prior_cands", "prior_acc")
_F32 = np.float32
_NAN = float("nan")
_FN = {}


@dataclasses.dataclass(frozen=True)
class ScheduleDims:
    n_main: int
    total: int
    tol_on: bool
    checks: int  # full-chain check budget
    verbose: bool
    tol: float  # f32 value
    scale: float  # init_temperature_scale as an f32 value
    diag: bool = False  # convergence diagnostics
    n_goals: int = 0  # the chain's goals (the diagnostics' violation columns)

    @property
    def n_acc(self) -> int:
        """The accumulator's counts: the total, and DIAG_YS with diagnostics."""
        return 1 + len(DIAG_YS) if self.diag else 1

    @property
    def n_cols(self) -> int:
        return len(YS) + (len(DIAG_YS) + self.n_goals if self.diag else 0)


def ys_columns(d: ScheduleDims) -> dict[str, int]:
    """Column of each ys key; with diagnostics "goal_viol" is the first of
    the G violation columns."""
    names = YS + (DIAG_YS + ("goal_viol",) if d.diag else ())
    return {k: i for i, k in enumerate(names)}


@dataclasses.dataclass
class Schedule:
    """The schedule's device state: int and float scalars, the round's
    accepted count (and the diagnostics' counts), decay ** round per
    round, the ys rows, and the diagnostics' stage."""

    si: torch.Tensor  # i32[N_INT]
    sf: torch.Tensor  # f32[N_FLOAT]
    acc: torch.Tensor  # i64[n_acc]
    decay_pow: torch.Tensor  # f32[total]
    ys: torch.Tensor  # f64[total, n_cols]
    count: torch.Tensor  # i32[2]: loop iterations run, of which masked
    #: f32[1 + G]: the round's full objective and violations (diagnostics)
    stage: torch.Tensor | None = None

    @staticmethod
    def create(total: int, decay: float, device, diag: bool = False,
               n_goals: int = 0) -> "Schedule":
        d = ScheduleDims(0, total, False, 0, False, 0.0, 0.0, diag, n_goals)
        return Schedule(
            si=torch.zeros(N_INT, dtype=torch.int32, device=device),
            sf=torch.zeros(N_FLOAT, dtype=torch.float32, device=device),
            acc=torch.zeros(d.n_acc, dtype=torch.int64, device=device),
            decay_pow=decay_powers(decay, total).to(device),
            ys=torch.zeros((total, d.n_cols), dtype=torch.float64, device=device),
            count=torch.zeros(2, dtype=torch.int32, device=device),
            stage=torch.zeros(1 + n_goals, dtype=torch.float32, device=device) if diag else None,
        )

    def value(self, i: int) -> torch.Tensor:
        """f32[1] view of float scalar i (what kernels read by pointer)."""
        return self.sf[i: i + 1]


def decay_powers(decay: float, total: int) -> torch.Tensor:
    """f32[total]: decay ** round, the f32 power of the reference's
    `temperature_decay ** rnd.astype(f32)`."""
    return torch.pow(torch.tensor(decay, dtype=torch.float32),
                     torch.arange(max(total, 1), dtype=torch.float32))


def _temperature(s: Schedule, d: ScheduleDims, rnd: int) -> float:
    """DECIDE's temperature of round rnd: 0 on the last main round and on
    polish rounds (every round past total is one), else t0 * decay ** rnd."""
    if rnd >= d.n_main or rnd == d.n_main - 1:
        return 0.0
    return float(_F32(s.sf[T0].item()) * _F32(s.decay_pow[rnd].item()))


def _diag_cols(s: Schedule, d: ScheduleDims, run: bool) -> list[float]:
    """The diagnostics' columns of a round's row: the counts and the
    stage's violations of a round that ran, else 0 counts and NaN."""
    if not d.diag:
        return []
    if run:
        return [float(v) for v in s.acc[1:].tolist()] + [float(v) for v in s.stage[1:].tolist()]
    return [0.0] * len(DIAG_YS) + [_NAN] * d.n_goals


def _masked_row(s: Schedule, d: ScheduleDims, rnd: int) -> list[float]:
    """The ys row of a round that does not run and checks nothing."""
    return [0.0, 0.0, 0.0, _temperature(s, d, rnd), float(np.inf), 0.0, _NAN] + _diag_cols(s, d, False)


def schedule_plain(phase: int, s: Schedule, d: ScheduleDims) -> None:
    """One phase on CPU tensors (the kernel's logic in f32 scalars)."""
    si, sf = s.si, s.sf
    inf = _F32(np.inf)
    if phase == INIT:
        si[RND], si[DONE], si[CHECKS], si[HAS_PREV], si[LOOP] = 0, 0, d.checks, 0, 1
        si[SLICE_END] = d.total
        sf[CHEAP_PREV] = sf[PREV_V] = float(inf)
        sf[T0] = float(_F32(sf[OBJ].item()) * _F32(d.scale))
        s.count.zero_()
        return
    rnd = int(si[RND])
    in_range = rnd < d.total
    if phase == EXIT:
        if not in_range or not si[DONE]:
            return  # nothing left, or the end of a slice that is not the last
        s.ys[rnd:] = torch.tensor([_masked_row(s, d, r) for r in range(rnd, d.total)],
                                  dtype=torch.float64)
        for i in (MAIN_GATE, EXTRA_GATE, NEED_FULL, RUN, MAIN_STOP):
            si[i] = 0
        sf[FULL_V] = sf[CHEAP] = sf[CHEAP_PREV] = float(inf)
        sf[T_R] = _temperature(s, d, d.total - 1)
        s.acc.zero_()
        sf[OBJ] = _NAN
        si[RND] = d.total
        return
    active = not si[DONE] and in_range
    is_extra = rnd >= d.n_main
    if phase == GATE:
        s.count[ITERS] += 1
        if not active:
            s.count[MASKED] += 1
        main_gate = (d.tol_on and active and not is_extra and rnd > 0 and int(si[CHECKS]) > 0
                     and _F32(sf[CHEAP_PREV].item()) <= _F32(d.tol))
        extra_gate = d.tol_on and active and is_extra
        si[MAIN_GATE], si[EXTRA_GATE] = int(main_gate), int(extra_gate)
        si[NEED_FULL] = int(main_gate or extra_gate)
        sf[FULL_V] = float(inf)
        return
    if phase == DECIDE:
        run, main_stop = active, False
        if d.tol_on:
            full_v = _F32(sf[FULL_V].item())
            main_gate, extra_gate = bool(si[MAIN_GATE]), bool(si[EXTRA_GATE])
            main_stop = main_gate and full_v <= _F32(d.tol)
            if main_gate and not main_stop:
                si[CHECKS] -= 1
            extra_stop = extra_gate and (
                full_v <= _F32(d.tol)
                or (bool(si[HAS_PREV]) and full_v > _F32(sf[PREV_V].item()) * _F32(0.9))
            )
            stop = main_stop or extra_stop
            if stop:
                si[DONE] = 1
            run = active and not stop
            if run and is_extra:
                sf[PREV_V] = float(full_v)
                si[HAS_PREV] = 1
        si[RUN], si[MAIN_STOP] = int(run), int(main_stop)
        sf[T_R] = _temperature(s, d, rnd)
        s.acc.zero_()
        sf[CHEAP] = float(inf)
        sf[OBJ] = _NAN
        return
    run = bool(si[RUN])
    if in_range:
        if d.diag:
            obj = float(s.stage[0]) if run else _NAN
        else:
            obj = float(sf[OBJ]) if run and d.verbose else _NAN
        s.ys[rnd] = torch.tensor([
            float(s.acc[0]) if run else 0.0, float(run), float(si[MAIN_STOP]),
            float(sf[T_R]), float(sf[CHEAP]) if run else float(inf), float(si[NEED_FULL]), obj,
            *_diag_cols(s, d, run),
        ], dtype=torch.float64)
    sf[CHEAP_PREV] = float(sf[CHEAP]) if run else float(inf)
    si[RND] = rnd + 1
    si[LOOP] = int(not si[DONE] and rnd + 1 < min(d.total, int(si[SLICE_END])))


def run_over(s: Schedule, d: ScheduleDims) -> bool:
    """Whether the run is over (done, or every scheduled round reached):
    what EXIT's IF node tests, read on the host."""
    return bool(s.si[DONE]) or int(s.si[RND]) >= d.total


class _Ptrs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in ("si", "sf", "acc", "decay_pow", "ys", "count", "stage")]


class _Dims(ctypes.Structure):
    _fields_ = [("n_main", ctypes.c_int), ("total", ctypes.c_int), ("tol_on", ctypes.c_int),
                ("checks", ctypes.c_int), ("verbose", ctypes.c_int), ("tol", ctypes.c_float),
                ("scale", ctypes.c_float), ("diag", ctypes.c_int), ("n_goals", ctypes.c_int)]


def _lib_fn(name, argtypes):
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(_build.library("schedule"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return fn


def _c(s: Schedule, d: ScheduleDims) -> tuple[_Ptrs, _Dims]:
    total = d.total
    for name, t, dtype, shape in (
        ("si", s.si, torch.int32, (N_INT,)), ("sf", s.sf, torch.float32, (N_FLOAT,)),
        ("acc", s.acc, torch.int64, (d.n_acc,)), ("decay_pow", s.decay_pow, torch.float32, (total,)),
        ("ys", s.ys, torch.float64, (total, d.n_cols)), ("count", s.count, torch.int32, (2,)),
        *((("stage", s.stage, torch.float32, (1 + d.n_goals,)),) if d.diag else ()),
    ):
        if t is None or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"round_schedule: {name} must be contiguous {dtype}{list(shape)}")
    ptrs = _Ptrs(si=s.si.data_ptr(), sf=s.sf.data_ptr(), acc=s.acc.data_ptr(),
                 decay_pow=s.decay_pow.data_ptr(), ys=s.ys.data_ptr(), count=s.count.data_ptr(),
                 stage=s.stage.data_ptr() if d.diag else None)
    dims = _Dims(d.n_main, d.total, int(d.tol_on), d.checks, int(d.verbose), d.tol, d.scale,
                 int(d.diag), d.n_goals)
    return ptrs, dims


def schedule_cuda(phase: int, s: Schedule, d: ScheduleDims) -> None:
    ptrs, dims = _c(s, d)
    fn = _lib_fn("cc_round_schedule", [ctypes.c_int, _Ptrs, _Dims, ctypes.c_void_p])
    status = fn(phase, ptrs, dims, torch.cuda.current_stream(s.si.device).cuda_stream)
    _build.check(status, "round_schedule")
    kernels.count("round_schedule")


def round_schedule(phase: int, s: Schedule, d: ScheduleDims) -> None:
    """Run one schedule phase: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if kernels.route(s.si, s.sf, s.ys) == "cpu":
        schedule_plain(phase, s, d)
    else:
        schedule_cuda(phase, s, d)


def graph_nodes(graph: torch.cuda.CUDAGraph) -> tuple[int, int]:
    """(nodes, kernel nodes) of a captured graph (kept with keep_graph)."""
    fn = _lib_fn("cc_graph_nodes", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)])
    n, k = ctypes.c_int(), ctypes.c_int()
    _build.check(fn(graph.raw_cuda_graph(), ctypes.byref(n), ctypes.byref(k)), "cudaGraphGetNodes")
    return n.value, k.value


#: cudaGraphNodeType's names, in its order (CUDA 12.4)
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
              "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc", "mem_free",
              "batch_mem_op", "conditional")


def graph_node_types(graph: torch.cuda.CUDAGraph) -> dict[str, int]:
    """A captured graph's top-level nodes by type (kept with keep_graph)."""
    fn = _lib_fn("cc_graph_node_types", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int])
    counts = (ctypes.c_int * 32)()
    _build.check(fn(graph.raw_cuda_graph(), counts, 32), "cudaGraphGetNodes")
    return {(NODE_TYPES[t] if t < len(NODE_TYPES) else str(t)): counts[t] for t in range(32)
            if counts[t]}


def cuda_versions() -> tuple[int, int]:
    """(runtime, driver) CUDA versions, e.g. 12040 for 12.4."""
    fn = _lib_fn("cc_cuda_versions", [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)])
    rt, dv = ctypes.c_int(), ctypes.c_int()
    _build.check(fn(ctypes.byref(rt), ctypes.byref(dv)), "cudaRuntimeGetVersion")
    return rt.value, dv.value


def require_conditional_graphs(what: str) -> None:
    """Raise unless the runtime and the driver run `what` (a graph with
    conditional nodes around child graphs): CUDA 12.4 or later in both."""
    rt, dv = cuda_versions()
    if min(rt, dv) < MIN_CUDA:
        raise RuntimeError(
            f"{what}, which needs CUDA 12.4 or later in the runtime and the driver; found "
            f"runtime {rt}, driver {dv}"
        )


def launch_graph_exec(exec_: ctypes.c_void_p, stream: int, what: str) -> None:
    """Launch an instantiated graph built by one of the package's
    libraries (an opaque cudaGraphExec_t) on `stream`."""
    fn = _lib_fn("cc_loop_graph_launch", [ctypes.c_void_p, ctypes.c_void_p])
    _build.check(fn(exec_, stream), f"{what} launch")


def destroy_graph_exec(exec_: ctypes.c_void_p, graph: ctypes.c_void_p, what: str) -> None:
    """Destroy an instantiated graph and its template (opaque handles)."""
    fn = _lib_fn("cc_loop_graph_destroy", [ctypes.c_void_p, ctypes.c_void_p])
    with kernels.graph_lock():
        status = fn(exec_, graph)
    _build.check(status, f"{what} destroy")


class _Copy(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("src", ctypes.c_void_p), ("bytes", ctypes.c_size_t)]


def _copy_specs(copies) -> ctypes.Array:
    """The C copy specs of (pinned host, CUDA) tensor pairs; raises on
    anything else."""
    for dst, src in copies:
        if (not dst.is_pinned() or src.device.type != "cuda" or not dst.is_contiguous()
                or not src.is_contiguous() or dst.nbytes != src.nbytes):
            raise ValueError("loop graph copies take contiguous (pinned host, CUDA) tensor pairs "
                             "of equal size")
    return (_Copy * max(1, len(copies)))(*(_Copy(dst.data_ptr(), src.data_ptr(), src.nbytes)
                                           for dst, src in copies))


class LoopGraph:
    """The whole fused schedule as one instantiated CUDA graph:
    child(init) -> WHILE(loop){GATE -> IF(need_full){eval} -> DECIDE ->
    IF(run){body [, obj]} -> CLOSE} -> EXIT [-> IF(over){post -> post_copies}]
    [-> copies], over the captured graphs `init`, `eval`, `body`, `obj` and
    `post` (which must outlive it: their memory pools hold the buffers the
    nodes use).  Without `init` it is the loop alone: a segmented run's
    slice graph (rounds up to SLICE_END a launch), which on a finished run
    times one masked iteration.  `copies` and `post_copies`, (pinned host
    tensor, CUDA tensor) pairs of equal bytes, are copy nodes: `copies`
    after everything else (a slice's fetch of the schedule, part of every
    launch), `post_copies` after `post` inside its IF node (the reported
    run's payload, copied by the last slice only)."""

    def __init__(self, s: Schedule, d: ScheduleDims, init_graph, eval_graph, body_graph,
                 obj_graph=None, post_graph=None, copies=(), post_copies=()):
        require_conditional_graphs(
            "the fused route's loop graph nests conditional IF nodes in a WHILE node")
        self._ptrs, self._dims = _c(s, d)
        if post_copies and post_graph is None:
            raise ValueError("loop graph post_copies need a post graph")
        fn = _lib_fn("cc_loop_graph_build", [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(_Copy), ctypes.c_int, ctypes.POINTER(_Copy), ctypes.c_int, _Ptrs, _Dims,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)])
        self._exec, self._graph = ctypes.c_void_p(), ctypes.c_void_p()

        def raw(g):
            return g.raw_cuda_graph() if g is not None else None

        post_specs, specs = _copy_specs(post_copies), _copy_specs(copies)
        with kernels.graph_lock():
            status = fn(raw(init_graph), raw(eval_graph), raw(body_graph), raw(obj_graph),
                        raw(post_graph), post_specs, len(post_copies), specs, len(copies),
                        self._ptrs, self._dims, ctypes.byref(self._exec), ctypes.byref(self._graph))
        _build.check(status, "loop graph build")
        self._keep = (s, init_graph, eval_graph, body_graph, obj_graph, post_graph, tuple(copies),
                      tuple(post_copies))
        self.launches = 0

    def launch(self, stream: int) -> None:
        launch_graph_exec(self._exec, stream, "loop graph")
        self.launches += 1

    def close(self) -> None:
        if self._exec:
            destroy_graph_exec(self._exec, self._graph, "loop graph")
            self._exec = ctypes.c_void_p()
            self._keep = None


class NodeFloorGraph:
    """reset -> WHILE{tick -> `extra` empty one-thread kernels}, `iters`
    iterations a launch (csrc/schedule.cu `cc_node_floor_graph_build`):
    what one one-thread kernel node costs inside a WHILE body, the floor
    of round_schedule's and scenario_step's nodes.  A measuring tool;
    nothing on the main path builds one."""

    def __init__(self, iters: int, extra: int, device):
        require_conditional_graphs("the node-floor graph holds a WHILE node")
        self._counter = torch.zeros(1, dtype=torch.int32, device=device)
        fn = _lib_fn("cc_node_floor_graph_build", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p)])
        self._exec, self._graph = ctypes.c_void_p(), ctypes.c_void_p()
        with kernels.graph_lock():
            status = fn(self._counter.data_ptr(), iters, extra, ctypes.byref(self._exec),
                        ctypes.byref(self._graph))
        _build.check(status, "node floor graph build")

    def launch(self, stream: int) -> None:
        launch_graph_exec(self._exec, stream, "node floor graph")

    def iterations(self) -> int:
        return int(self._counter.item())

    def close(self) -> None:
        if self._exec:
            destroy_graph_exec(self._exec, self._graph, "node floor graph")
            self._exec = ctypes.c_void_p()
