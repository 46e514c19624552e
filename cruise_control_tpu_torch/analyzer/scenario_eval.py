"""Batched what-if evaluation — N hypothetical clusters, one graph launch.

N scenario states of ONE shared (bucketed) shape are scored by the goal
chain (analyzer/objective.py) in one device program: the fields every
scenario shares ride in once, the fields that differ are stacked, and a
loop on the device runs the single-state chain once per scenario, so each
scenario's numbers are exactly those of scoring it alone.  That is the
planner's workhorse: a rightsize sweep or a rack-loss matrix is dozens of
hypotheticals, and evaluating them one by one would pay the chain's
launches from the host per scenario for arrays that are 99% identical.

On the card the program is one instantiated CUDA graph per (shape,
varying-field set): a conditional WHILE node whose body is
the captured chain on a slot state (scenario i's varying fields copied in
from the stacked buffers, i read on the device) followed by the
`scenario_step` kernel (kernels/scenario.py), which stores row i of the
outputs, advances i and ends the loop at n.  The graph owns every buffer
its kernels read (kernels bake pointers into their parameter blocks): the
slot state, the stacked buffers (capacity `max_scenarios`) and the
outputs.  A call copies the base's shared fields and each scenario's
varying fields into them, launches the graph once and syncs once, so one
graph serves every batch size up to `max_scenarios` and any contents.  On
the CPU (`device="cpu"`) the same body runs as the sequential loop with
the plain kernels: the route is the device the caller named, never a
fallback.

The optional `optimize=True` pass runs the FULL anneal per scenario
through the caller's GoalOptimizer: every scenario state shares the batch
shape, so its engine cache builds ONE engine and rebinds it for the rest.
A rebind copies the scenario into the engine's own tensors, so the graphs
captured by the first anneal serve every later one of the bucket, whatever
liveness or capacities it changes; only a scenario of another member-table
width (max_rf) captures anew.  Each anneal's captures and its bucket are
reported in `last_batch["fix"]`.

The JAX package's analyzer/scenario_eval.py, scoring in f32 as it does.
With a `supervisor` (common/device_watchdog.py, shared with the
optimizer) the batch and `score_state` run inside a supervised call
(`DeviceSupervisor.run`): on the card a classified device failure or an
open breaker raises `DeviceDegradedError`; on the CPU, where the states
already lie on the host, it is answered by the sequential CPU twin
(`_evaluate_cpu`), flagged `degraded`.  Without one (the default) a
device failure raises.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer.engine import REPORT_STATS
from cruise_control_tpu_torch.analyzer.objective import (
    DEFAULT_CHAIN,
    GoalChain,
    balancedness_score,
)
from cruise_control_tpu_torch.common.device_watchdog import device_op
from cruise_control_tpu_torch.common.dispatch import count_dispatch
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT, BalancingConstraint
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.kernels import schedule as sched_k
from cruise_control_tpu_torch.kernels.scenario import ScenarioGraph, ScenarioLoop, scenario_step
from cruise_control_tpu_torch.models.aggregates import compute_aggregates
from cruise_control_tpu_torch.models.builder import pad_state
from cruise_control_tpu_torch.models.state import STATE_FIELDS, ClusterState
from cruise_control_tpu_torch.models.stats import ClusterStats, compute_stats
from cruise_control_tpu_torch.models.whatif import _MEMBER_FIELDS, HostState
from cruise_control_tpu_torch.planner.scenario import _apply, plan_shape

#: goals violated above this are "failed" — the same f32-noise epsilon
#: balancedness_score and OptimizerResult.violated_goals_after use
VIOLATION_TOL = 1e-6
#: bounded LRU of batch programs (each holds a graph and its buffers)
_CACHE_CAP = 8


@dataclasses.dataclass(frozen=True)
class ScenarioOutcome:
    """What one hypothetical looks like, before and (optionally) after a fix."""

    name: str
    objective: float
    violations: np.ndarray  # f32[G] per-goal violation at current placement
    violated_goals: list
    balancedness: float
    hard_goals_satisfied: bool
    brokers_alive: int
    #: scored by the sequential CPU twin because the device path was
    #: unavailable or failed (a supervised evaluator on the CPU only)
    degraded: bool = False
    #: present when the full anneal ran: the projected post-fix cluster
    fix: dict | None = None

    def to_json(self) -> dict:
        out = {
            "name": self.name,
            "objective": self.objective,
            "violatedGoals": list(self.violated_goals),
            "balancedness": self.balancedness,
            "hardGoalsSatisfied": self.hard_goals_satisfied,
            "brokersAlive": self.brokers_alive,
        }
        if self.fix is not None:
            out["fix"] = self.fix
        return out


@dataclasses.dataclass
class _Program:
    """The buffers of one batch program and, on the card, its graphs."""

    slot: ClusterState  # every field a buffer of the program's own
    members: torch.Tensor  # i32[P, M]: the member table the chain reads
    stacks: dict  # varying field -> [cap, *field shape]; "members" when the rows vary
    loop: ScenarioLoop
    body: torch.cuda.CUDAGraph | None = None
    graph: ScenarioGraph | None = None
    launches_per_replay: dict = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=dict)
    host: dict | None = None  # pinned staging (ctrl) and host outputs

    def close(self) -> None:
        with kernels.graph_lock():
            if self.graph is not None:
                self.graph.close()
                self.graph = None
            self.body = None


@dataclasses.dataclass
class _ScoreProgram:
    """score_state's buffers per shape: the slot, its member table, the
    f32 report row (objective, violations, REPORT_STATS) and, on the card,
    the captured graph and a pinned host row."""

    slot: ClusterState
    members: torch.Tensor
    row: torch.Tensor
    graph: torch.cuda.CUDAGraph | None = None
    host_row: torch.Tensor | None = None


def _launches_since(before: dict) -> dict:
    """The kernels' launch counts since the snapshot `before`, nonzero only."""
    return {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] != before[k]}


def _empty_like_state(state: ClusterState) -> ClusterState:
    return dataclasses.replace(state, **{f: torch.empty_like(getattr(state, f))
                                         for f in STATE_FIELDS})


class ScenarioEvaluator:
    """Batch-scores scenario states on the goal chain; optionally anneals
    each through the shared GoalOptimizer.

    `device` is where states must live and the batch runs: the current
    CUDA device when None (raising without one), or the CPU when the
    caller names it."""

    def __init__(
        self,
        chain: GoalChain = DEFAULT_CHAIN,
        constraint: BalancingConstraint = DEFAULT_CONSTRAINT,
        *,
        optimizer=None,
        supervisor=None,
        sensors=None,
        balancedness_weights: tuple[float, float] = (1.1, 1.5),
        max_scenarios: int = 32,
        device=None,
    ):
        """optimizer: GoalOptimizer for the optimize=True pass (its chain
        should be this chain), on this evaluator's device; supervisor:
        DeviceSupervisor shared with the optimizer, so that a failed card
        opens one breaker for the whole analyzer surface (None: a device
        failure raises unsupervised); sensors: anything with counter(name).inc(n),
        gauge(name).set(v) and timer(name).update(seconds)."""
        self.device = resolve_device(device)
        if optimizer is not None and optimizer.device != self.device:
            raise ValueError(f"the optimizer runs on {optimizer.device}, the evaluator on {self.device}")
        self.chain = chain
        self.constraint = constraint
        self.optimizer = optimizer
        self.supervisor = supervisor
        self.sensors = sensors
        self.balancedness_weights = balancedness_weights
        self.max_scenarios = max_scenarios
        self._weights = torch.tensor(chain.weights, dtype=torch.float32, device=self.device)
        #: batch programs per (shape, member width, varying fields) in LRU
        #: order.  Locked for the whole batch: the facade
        #: shares one evaluator across its request threads, and a program's
        #: buffers serve one batch at a time.
        self._programs: OrderedDict = OrderedDict()
        self._score_programs: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        #: what the last batch did: n, captured, capture_s, nodes,
        #: graph_launches, wall_s, device_ms; after evaluate(optimize=)
        #: also "fix", one record a scenario annealed
        self.last_batch: dict = {}

    # ------------------------------------------------------------------
    # batched scoring
    # ------------------------------------------------------------------

    def _check_states(self, states) -> None:
        for s in states:
            if s.device != self.device:
                raise ValueError(f"a scenario state is on {s.device}, the evaluator on {self.device}")

    def evaluate_states(self, states: list[ClusterState]):
        """(objectives f64[N], violations f64[N, G], degraded) for N states
        of ONE shared shape: one program, one graph launch and one sync on
        the card.  `degraded` is True when a supervised evaluator on the
        CPU answered from the sequential CPU twin."""
        obj, viol, rec = self._score(states)
        self.last_batch = rec
        return obj, viol, rec.get("degraded", False)

    def _score(self, states):
        """(objectives, violations, the batch's record) of N states, the
        record's `degraded` set where the CPU twin answered."""
        if not states:
            return np.zeros(0), np.zeros((0, len(self.chain.goals))), dict(n=0)
        shapes = {s.shape for s in states}
        if len(shapes) > 1:
            raise ValueError(
                f"scenario batch spans {len(shapes)} shapes; plan_shape the "
                "batch so it shares one program"
            )
        if len(states) > self.max_scenarios:
            raise ValueError(
                f"{len(states)} scenario states exceed max_scenarios={self.max_scenarios}"
            )
        self._check_states(states)
        sup = self.supervisor
        if sup is None:
            return self._evaluate_on_device(states)

        def degraded(reason, cause):
            t0 = time.monotonic()
            obj, viol = self._evaluate_cpu(states)
            self._count_degraded()
            return obj, viol, dict(n=len(states), degraded=True, wall_s=time.monotonic() - t0)

        return sup.run(lambda: self._evaluate_on_device(states), op="scenario-eval",
                       degraded=degraded if self.device.type == "cpu" else None)

    def _count_degraded(self) -> None:
        if self.sensors is not None:
            self.sensors.counter("planner.degraded-evaluations").inc()

    def _evaluate_cpu(self, hosts):
        """The degraded twin: each state on the CPU scored alone, op by op
        — the batch's numbers up to the order of float sums."""
        weights = torch.tensor(self.chain.weights, dtype=torch.float32)
        objs, viols = [], []
        for s in hosts:
            agg = compute_aggregates(s, s.members)
            obj, viol, _ = self.chain.evaluate(s, agg=agg, constraint=self.constraint,
                                               weights=weights)
            objs.append(float(obj))
            viols.append(viol.numpy().astype(np.float64))
        return np.asarray(objs, np.float64), np.stack(viols)

    @device_op("scenario.batch-eval")
    def _evaluate_on_device(self, states):
        t0 = time.monotonic()
        # scenario states alias the shared base's tensors for every field
        # their scenario did not touch (models/whatif.py dirty tracking):
        # those ride into the program once; only the fields that differ
        # are stacked
        shared, varying = [], []
        for f in STATE_FIELDS:
            vals = [getattr(s, f) for s in states]
            (shared if all(v is vals[0] for v in vals[1:]) else varying).append(f)
        n = len(states)
        if not varying:
            # every scenario is the identity: score the base once, fan out
            obj, viol = self._single_eval(states[0])
            return (np.full(n, float(obj), np.float64),
                    np.tile(np.asarray(viol, np.float64), (n, 1)),
                    dict(n=n, identity=True, wall_s=time.monotonic() - t0, degraded=False))
        base = states[0]
        # where the replica rows' partition, position or validity differ,
        # each scenario's member table is one more varying field, padded
        # with R to the widest
        rows_vary = bool(set(varying) & _MEMBER_FIELDS)
        tables = [s.members for s in states] if rows_vary else [base.members]
        width = max(int(t.shape[1]) for t in tables)
        key = (base.shape, width, frozenset(varying))
        with self._lock:
            prog = self._programs.get(key)
            captured = prog is None
            if prog is None:
                prog = self._new_program(base, width, varying, rows_vary)
                self._programs[key] = prog
                while len(self._programs) > _CACHE_CAP:
                    self._programs.popitem(last=False)[1].close()
            else:
                self._programs.move_to_end(key)
            self._fill(prog, states, shared, varying, tables)
            if self.device.type == "cuda":
                obj, viol, rec = self._run_graph(prog, n, captured)
            else:
                obj, viol, rec = self._run_eager(prog, n)
        rec.update(n=n, identity=False, captured=captured, wall_s=time.monotonic() - t0,
                   varying=sorted(varying), degraded=False)
        return obj.astype(np.float64), viol.astype(np.float64), rec

    def _new_program(self, base: ClusterState, width: int, varying, rows_vary: bool) -> _Program:
        cap = self.max_scenarios
        stacks = {f: torch.empty((cap,) + tuple(getattr(base, f).shape),
                                 dtype=getattr(base, f).dtype, device=self.device)
                  for f in varying}
        if rows_vary:
            stacks["members"] = torch.empty((cap, base.shape.P, width), dtype=torch.int32,
                                            device=self.device)
        return _Program(
            slot=_empty_like_state(base),
            members=torch.empty((base.shape.P, width), dtype=torch.int32, device=self.device),
            stacks=stacks,
            loop=ScenarioLoop.create(cap, len(self.chain.goals), self.device),
        )

    def _fill(self, prog: _Program, states, shared, varying, tables) -> None:
        """This batch's data into the program's buffers, in stream order:
        the base's shared fields into the slot, each scenario's varying
        fields into its row of the stacks, and the member tables: the
        base's one, or each scenario's into its row, padded with R."""
        base = states[0]
        for f in shared:
            getattr(prog.slot, f).copy_(getattr(base, f))
        for f in varying:
            stack = prog.stacks[f]
            for j, s in enumerate(states):
                stack[j].copy_(getattr(s, f))
        if "members" not in prog.stacks:
            prog.members.copy_(tables[0])
            return
        stack = prog.stacks["members"]
        for j, table in enumerate(tables):
            w = int(table.shape[1])
            stack[j, :, :w].copy_(table)
            stack[j, :, w:].fill_(base.shape.R)

    def _chain_eval(self, state: ClusterState, members: torch.Tensor):
        """(objective, violations) of `state`: its aggregates from the
        member table, then the goal chain with the device weights."""
        agg = compute_aggregates(state, members)
        obj, viol, _ = self.chain.evaluate(state, agg=agg, constraint=self.constraint,
                                           weights=self._weights)
        return obj, viol

    def _body(self, prog: _Program) -> None:
        """One scenario: row ctrl[0] of the stacks into the slot, the chain
        on the slot, its outputs into the loop's slot outputs."""
        i = prog.loop.ctrl[:1]
        for f, stack in prog.stacks.items():
            dst = prog.members if f == "members" else getattr(prog.slot, f)
            torch.index_select(stack, 0, i, out=dst.unsqueeze(0))
        obj, viol = self._chain_eval(prog.slot, prog.members)
        prog.loop.obj_slot.copy_(obj.reshape(1))
        prog.loop.viol_slot.copy_(viol)

    def _run_eager(self, prog: _Program, n: int):
        """The batch as the sequential loop on CPU tensors."""
        loop = prog.loop
        loop.ctrl.copy_(torch.tensor([0, n], dtype=torch.int32))
        while True:
            self._body(prog)
            if not scenario_step(loop):
                break
        return (loop.obj_out[:n].numpy().copy(), loop.viol_out[:n].numpy().copy(),
                dict(steps=int(loop.ctrl[0])))

    def _capture(self, prog: _Program) -> None:
        """The body's graph and the batch graph around it.  The body runs
        once eagerly first, on the capture stream, so lazy initialisations
        happen outside the capture; its launches are real and counted
        (`warmup_launches`), the capture's are not: the body's kernels are
        counted once a scenario the device ran (`_run_graph`)."""
        t0 = time.monotonic()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        before = dict(kernels.LAUNCHES)
        with torch.cuda.stream(stream):
            self._body(prog)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        warmup = _launches_since(before)
        t_warm = time.monotonic()
        body = torch.cuda.CUDAGraph(keep_graph=True)
        with kernels.capture(body, stream) as rec:
            self._body(prog)
        prog.launches_per_replay = {k: n for k, n in rec.items() if n}
        t_cap = time.monotonic()
        prog.body = body
        prog.graph = ScenarioGraph(prog.loop, body)
        cap = prog.loop.cap
        prog.host = dict(
            ctrl=torch.empty(2, dtype=torch.int32, pin_memory=True),
            ctrl_out=torch.empty(2, dtype=torch.int32, pin_memory=True),
            obj=torch.empty(cap, dtype=torch.float32, pin_memory=True),
            viol=torch.empty((cap, prog.loop.n_goals), dtype=torch.float32, pin_memory=True),
        )
        prog.stats = dict(warmup_s=t_warm - t0, capture_s=t_cap - t_warm,
                          instantiate_s=time.monotonic() - t_cap,
                          body_nodes=sched_k.graph_nodes(body), warmup_launches=warmup)

    def _run_graph(self, prog: _Program, n: int, new: bool):
        """One launch of the batch graph and one sync.  The loop's counter
        comes back with the outputs: the scenarios the device ran, from
        which the body's kernels and the step kernel are counted."""
        if new:
            self._capture(prog)
        stream = torch.cuda.current_stream(self.device)
        h = prog.host
        h["ctrl"][0], h["ctrl"][1] = 0, n
        prog.loop.ctrl.copy_(h["ctrl"], non_blocking=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        count_dispatch("scenario.batch")
        start.record(stream)
        prog.graph.launch(stream.cuda_stream)
        end.record(stream)
        h["obj"][:n].copy_(prog.loop.obj_out[:n], non_blocking=True)
        h["viol"][:n].copy_(prog.loop.viol_out[:n], non_blocking=True)
        h["ctrl_out"].copy_(prog.loop.ctrl, non_blocking=True)
        count_dispatch("scenario.sync")
        stream.synchronize()
        steps = int(h["ctrl_out"][0])
        kernels.add_launches(prog.launches_per_replay, steps)
        kernels.count("scenario_step", steps)
        if steps != n:
            raise RuntimeError(f"the scenario batch graph ran {steps} scenarios of {n}")
        rec = dict(graph_launches=1, blocking_syncs=1, device_ms=start.elapsed_time(end),
                   steps=steps, body_launches=dict(prog.launches_per_replay), **prog.stats)
        return h["obj"][:n].numpy().copy(), h["viol"][:n].numpy().copy(), rec

    def _single_eval(self, state: ClusterState):
        """(objective f32, violations f32[G]) of one state: the chain op
        by op (on the card, every launch from the host), fetched with one
        sync."""
        self._check_states([state])
        count_dispatch("scenario.single")
        obj, viol = self._chain_eval(state, state.members)
        count_dispatch("scenario.sync")
        return obj.cpu().numpy(), viol.cpu().numpy()

    # ------------------------------------------------------------------
    # calibration scoring (the decision ledger's scorer)
    # ------------------------------------------------------------------

    def _score_program(self, state: ClusterState) -> _ScoreProgram:
        members = state.members
        key = (state.shape, int(members.shape[1]))
        prog = self._score_programs.get(key)
        if prog is not None:
            self._score_programs.move_to_end(key)
            return prog
        G = len(self.chain.goals)
        width = 1 + G + sum(k for _, k in REPORT_STATS)
        prog = _ScoreProgram(slot=_empty_like_state(state), members=torch.empty_like(members),
                             row=torch.empty(width, dtype=torch.float32, device=self.device))
        self._score_programs[key] = prog
        while len(self._score_programs) > _CACHE_CAP:
            self._score_programs.popitem(last=False)
        return prog

    def _score_row(self, prog: _ScoreProgram) -> None:
        st = prog.slot
        agg = compute_aggregates(st, prog.members)
        obj, viol, _ = self.chain.evaluate(st, agg=agg, constraint=self.constraint,
                                           weights=self._weights)
        stats = compute_stats(st, agg)
        prog.row.copy_(torch.cat([obj.reshape(1), viol,
                                  *(getattr(stats, f).reshape(-1) for f, _ in REPORT_STATS)]))

    def score_state(self, state: ClusterState):
        """(objective, per-goal violations f64[G], ClusterStats, degraded)
        of ONE measured cluster state — the calibration loop's scorer: the
        SAME goal chain + constraint the decision's prediction rode, with
        the cluster stats; on the card one captured graph per shape, one
        sync.  Supervised like every other evaluator dispatch; on the CPU
        its degraded route is the sequential CPU twin (`degraded` True)."""
        self._check_states([state])
        sup = self.supervisor
        if sup is None:
            return (*self._score_state_on_device(state), False)

        def degraded(reason, cause):
            objs, viols = self._evaluate_cpu([state])
            self._count_degraded()
            return (float(objs[0]), viols[0],
                    compute_stats(state, compute_aggregates(state, state.members)), True)

        return sup.run(lambda: (*self._score_state_on_device(state), False),
                       op="calibration-score",
                       degraded=degraded if self.device.type == "cpu" else None)

    @device_op("scenario.score-state")
    def _score_state_on_device(self, state: ClusterState):
        """(objective, violations f64[G], ClusterStats) of one state."""
        with self._lock:
            prog = self._score_program(state)
            for f in STATE_FIELDS:
                getattr(prog.slot, f).copy_(getattr(state, f))
            prog.members.copy_(state.members)
            count_dispatch("scenario.score")
            if self.device.type == "cuda":
                if prog.graph is None:
                    stream = torch.cuda.Stream(self.device)
                    stream.wait_stream(torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(stream):
                        self._score_row(prog)
                    torch.cuda.current_stream(self.device).wait_stream(stream)
                    graph = torch.cuda.CUDAGraph()
                    with kernels.capture(graph, stream):
                        self._score_row(prog)
                    prog.graph = graph
                    prog.host_row = torch.empty(prog.row.shape, dtype=torch.float32,
                                                pin_memory=True)
                prog.graph.replay()
                prog.host_row.copy_(prog.row, non_blocking=True)
                count_dispatch("scenario.sync")
                torch.cuda.current_stream(self.device).synchronize()
                row = prog.host_row.numpy().copy()
            else:
                self._score_row(prog)
                row = prog.row.numpy().copy()
        G = len(self.chain.goals)
        stats, at = {}, 1 + G
        for f, k in REPORT_STATS:
            v = torch.from_numpy(row[at: at + k].copy())
            stats[f] = v if k > 1 else v.reshape(())
            at += k
        return float(row[0]), row[1: 1 + G].astype(np.float64), ClusterStats(**stats)

    # ------------------------------------------------------------------
    # the full planner pass
    # ------------------------------------------------------------------

    def evaluate(
        self,
        base_state: ClusterState,
        scenarios,
        catalog=None,
        *,
        optimize=False,
        bucket=None,
    ) -> list[ScenarioOutcome]:
        """Apply each scenario to `base_state`, batch-score all of them,
        and anneal for the projected post-fix view.  `optimize`: one bool
        for the whole batch, or a per-scenario sequence (the facade rides
        a baseline scenario in every /simulate batch and must not pay a
        full anneal for a fix block it never serializes)."""
        outcomes, batch = self._evaluate(base_state, scenarios, catalog, optimize=optimize,
                                         bucket=bucket)
        self.last_batch = batch
        return outcomes

    def _evaluate(self, base_state, scenarios, catalog, *, optimize, bucket):
        """evaluate's outcomes and this call's batch record (with "fix",
        one record a scenario annealed), built from locals so that
        concurrent calls keep their own."""
        scenarios = list(scenarios)
        if len(scenarios) > self.max_scenarios:
            raise ValueError(
                f"{len(scenarios)} scenarios exceed planner.max.scenarios="
                f"{self.max_scenarios}"
            )
        if isinstance(optimize, bool):
            optimize = [optimize] * len(scenarios)
        elif len(optimize) != len(scenarios):
            raise ValueError(
                f"optimize mask has {len(optimize)} entries for "
                f"{len(scenarios)} scenarios"
            )
        t0 = time.monotonic()
        shape = plan_shape(base_state, scenarios, bucket=bucket)
        if shape != base_state.shape:
            # pad ONCE: every scenario state then aliases this base's
            # tensors for its untouched fields, which is what lets the
            # batch take the shared fields once
            base_state = pad_state(base_state, shape)
        # the base's fields come to the host once; each scenario edits a
        # copy, and its live-broker count is read there, before the upload
        host = HostState.of(base_state)
        applied = [_apply(base_state, sc, catalog, shape=shape, host=host) for sc in scenarios]
        states = [s for s, _ in applied]
        alive = [int(h.alive_mask().sum()) for _, h in applied]
        objs, viols, batch = self._score(states)
        degraded = batch.get("degraded", False)
        hard = self.chain.hard_mask()
        names = self.chain.names()
        pw, sw = self.balancedness_weights
        outcomes, fixes = [], []
        for i, sc in enumerate(scenarios):
            v = viols[i]
            fix = None
            if optimize[i] and self.optimizer is not None:
                fix, rec = self._fix_summary(states[i])
                fixes.append(dict(name=sc.name, **rec))
            outcomes.append(
                ScenarioOutcome(
                    name=sc.name,
                    objective=float(objs[i]),
                    violations=v,
                    violated_goals=[n for n, x in zip(names, v) if x > VIOLATION_TOL],
                    balancedness=balancedness_score(
                        v, self.chain, priority_weight=pw, strictness_weight=sw
                    ),
                    hard_goals_satisfied=bool((v[hard] <= VIOLATION_TOL).all()),
                    brokers_alive=alive[i],
                    degraded=degraded,
                    fix=fix,
                )
            )
        if fixes:
            batch["fix"] = fixes
        if self.sensors is not None:
            self.sensors.counter("planner.scenarios-evaluated").inc(len(scenarios))
            self.sensors.gauge("planner.last-batch-size").set(len(scenarios))
            self.sensors.timer("planner.batch-eval-timer").update(
                time.monotonic() - t0
            )
        return outcomes, batch

    def _fix_summary(self, state: ClusterState) -> tuple[dict, dict]:
        """Run the full anneal on one scenario state; the projected
        post-fix cluster as a summary dict, and a record of the run (the
        engine-cache hit, the graphs it captured, `captures` (1 where its
        run captured, else 0) and its bucket with max_rf).  Every scenario
        shares the planned shape, so the optimizer builds one engine and
        rebinds it N-1 times."""
        result = self.optimizer.optimize(state)
        out = result.summary()
        out["violatedGoalsBefore"] = [
            n for n, v in zip(result.goal_names, result.violations_before)
            if v > VIOLATION_TOL
        ]
        hard = self.chain.hard_mask()
        after = np.asarray(result.violations_after)
        out["hardGoalsSatisfiedAfter"] = bool(
            (after[hard[: after.size]] <= VIOLATION_TOL).all()
        )
        timing = next(h for h in result.history if h.get("timing"))
        captured = list(timing.get("captured", []))
        rec = dict(engine_cache_hit=timing.get("engine_cache_hit"), captured=captured,
                   captures=int(bool(captured)), bucket=dict(timing.get("bucket", {})),
                   wall_s=result.wall_seconds)
        return out, rec
