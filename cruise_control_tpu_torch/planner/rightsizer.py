"""Rightsizing: the minimum broker count satisfying every hard goal.

Cruise Control's `ProvisionStatus` (UNDER_PROVISIONED / RIGHT_SIZED /
OVER_PROVISIONED) answers "is this cluster the right size" for the
current topology only.  Here the question is asked as a what-if sweep:
each candidate broker count becomes a Scenario (drop the highest-id
brokers, or add median-profile brokers), every candidate is screened in
ONE batched goal-score evaluation, and a monotone binary search runs the
full anneal on the shortlist to confirm that a rebalance at that size
actually satisfies every hard goal.  Candidates share one planned shape,
so the anneal reuses a single compiled engine across the whole search.

Monotonicity is the search's load-bearing assumption: if n brokers can
satisfy the hard goals, n+1 can (the optimizer may simply not use the
extra broker).  That is what turns a sweep into O(log n) anneals.

The JAX package's planner/rightsizer.py, kept here as its own copy: the
screen is one batched evaluation on the card (one graph launch, one
sync), each anneal a `GoalOptimizer.optimize` of the port.
"""

from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np

from cruise_control_tpu_torch.models.state import ClusterState
from cruise_control_tpu_torch.planner.scenario import BrokerAdd, Scenario


def _alive_mask(state: ClusterState) -> np.ndarray:
    return (state.broker_valid & state.broker_alive).cpu().numpy()


class ProvisionStatus(enum.Enum):
    """Reference: analyzer ProvisionStatus semantics."""

    RIGHT_SIZED = "RIGHT_SIZED"
    UNDER_PROVISIONED = "UNDER_PROVISIONED"
    OVER_PROVISIONED = "OVER_PROVISIONED"
    UNDECIDED = "UNDECIDED"


@dataclasses.dataclass(frozen=True)
class CandidateResult:
    brokers: int
    feasible: bool  # hard goals satisfiable (post-anneal) at this count
    violated_hard_goals: tuple
    objective_after: float | None
    num_moves: int | None
    #: verdict came from a degraded route (the JAX package's CPU fallback;
    #: this package has none yet, so always False)
    degraded: bool = False

    def to_json(self) -> dict:
        return {
            "brokers": self.brokers,
            "feasible": self.feasible,
            "violatedHardGoals": list(self.violated_hard_goals),
            "objectiveAfter": self.objective_after,
            "numMoves": self.num_moves,
        }


class Rightsizer:
    """Monotone broker-count search over the batched scenario evaluator."""

    def __init__(
        self,
        evaluator,
        *,
        min_brokers: int = 1,
        max_broker_factor: float = 2.0,
        bucket=None,
        sensors=None,
    ):
        """evaluator: analyzer.scenario_eval.ScenarioEvaluator with an
        optimizer attached (the anneal is what makes a verdict honest —
        pre-move violations only prove a rebalance is NEEDED, not that
        one is impossible).  bucket: the CONFIGURED ShapeBucketPolicy —
        candidate shapes that outgrow the base padding must land in the
        same buckets the engine cache serves, or every grown candidate
        pays a fresh compile and the O(log n) search degrades."""
        self.evaluator = evaluator
        self.min_brokers = min_brokers
        self.max_broker_factor = max_broker_factor
        self.bucket = bucket
        self.sensors = sensors
        #: the last rightsize's anneals in the order they ran: brokers,
        #: feasible, and the evaluator's record of the anneal
        #: (engine_cache_hit, captured, captures, bucket, wall_s)
        self.last_anneals: list[dict] = []

    # ------------------------------------------------------------------

    def _scenario_for_count(
        self, state: ClusterState, n: int, current: int, base: Scenario | None
    ) -> Scenario:
        """The what-if that makes the cluster n brokers big.  Shrinks drop
        the highest-id ALIVE brokers (the conventional decommission order);
        grows add median-profile brokers round-robin over racks."""
        if n < current:
            alive = np.nonzero(_alive_mask(state))[0]
            sc = Scenario(
                name=f"brokers={n}",
                remove_brokers=tuple(int(b) for b in alive[n:]),
            )
        elif n > current:
            sc = Scenario(
                name=f"brokers={n}", add_brokers=(BrokerAdd(count=n - current),)
            )
        else:
            sc = Scenario(name=f"brokers={n}")
        return sc if base is None else base.compose(sc, name=sc.name)

    def _floor(self, state: ClusterState, current: int) -> int:
        """No candidate below max replication factor (a partition cannot
        place two replicas on one broker — such counts are structurally
        infeasible, not merely unbalanced) or the configured minimum."""
        part = state.replica_partition.cpu().numpy()[state.replica_valid.cpu().numpy()]
        max_rf = int(np.bincount(part).max()) if part.size else 1
        return max(self.min_brokers, max_rf, 1)

    def _feasible(self, state, catalog, scenario) -> tuple[CandidateResult, dict]:
        """Post-anneal hard-goal verdict for one candidate, and the
        evaluator's record of its anneal.  No memo on purpose: the binary
        search never revisits a count, and a cache that can never hit only
        suggests reuse that does not exist."""
        outcomes, batch = self.evaluator._evaluate(
            state, [scenario], catalog, optimize=True, bucket=self.bucket
        )
        outcome = outcomes[0]
        fix = outcome.fix or {}
        hard_names = [
            g.name for g in self.evaluator.chain.goals if g.hard
        ]
        violated_hard = tuple(
            v for v in fix.get("violatedGoalsAfter", []) if v in hard_names
        )
        res = CandidateResult(
            brokers=outcome.brokers_alive,
            feasible=bool(fix.get("hardGoalsSatisfiedAfter", False)),
            violated_hard_goals=violated_hard,
            objective_after=fix.get("objectiveAfter"),
            num_moves=fix.get("numReplicaMovements"),
            degraded=outcome.degraded or bool(fix.get("degraded")),
        )
        anneal = dict(brokers=res.brokers, feasible=res.feasible)
        for rec in batch.get("fix", []):
            anneal.update({k: v for k, v in rec.items() if k != "name"})
        return res, anneal

    # ------------------------------------------------------------------

    def rightsize(
        self,
        state: ClusterState,
        catalog=None,
        *,
        load_scenario: Scenario | None = None,
        max_anneals: int = 16,
        screen_limit: int = 16,
    ) -> dict:
        """Minimum brokers satisfying all hard goals at current (and, via
        `load_scenario`, forecast) load.

        Phase 1 screens a bounded grid of candidate counts in ONE batched
        goal-score program (the pre-move violation curve, reported for
        operators); phase 2 binary-searches the integer range for the
        feasibility boundary with full anneals (engine compiled once,
        rebound per candidate — O(log n) anneals even at 2600 brokers).
        `max_anneals` bounds the search wall clock; an unfinished search
        reports UNDECIDED rather than guessing.
        """
        t0 = time.monotonic()
        current = int(_alive_mask(state).sum())
        lo = self._floor(state, current)
        hi = max(current, int(np.ceil(current * self.max_broker_factor)))
        # screening grid: every count when small, else evenly spread with
        # lo/current/hi always present
        span = hi - lo + 1
        if span <= screen_limit:
            grid = list(range(lo, hi + 1))
        else:
            grid = sorted(
                {lo, current, hi}
                | {int(x) for x in np.linspace(lo, hi, screen_limit - 2)}
            )
        scenarios = [
            self._scenario_for_count(state, n, current, load_scenario)
            for n in grid
        ]
        # phase 1: one batched evaluation of every screened candidate's
        # PRE-move violations — the curve an operator reads to see how
        # stressed each size starts out
        pre = self.evaluator.evaluate(
            state, scenarios, catalog, optimize=False, bucket=self.bucket
        )
        degraded = any(o.degraded for o in pre)
        pre_by_count = {
            n: {"objective": o.objective, "violatedGoals": o.violated_goals}
            for n, o in zip(grid, pre)
        }

        # phase 2: monotone binary search on post-anneal feasibility over
        # the FULL integer range (not just the grid)
        anneals = 0
        verdicts: dict[int, CandidateResult] = {}
        records: list[dict] = []

        def check(n: int) -> bool:
            nonlocal anneals, degraded
            sc = self._scenario_for_count(state, n, current, load_scenario)
            res, rec = self._feasible(state, catalog, sc)
            verdicts[n] = res
            records.append(rec)
            degraded = degraded or res.degraded
            anneals += 1
            return res.feasible

        min_feasible: int | None = None
        upper_bound: int | None = None
        undecided = False
        # check(hi) always runs (max_anneals >= 1).  An INFEASIBLE ceiling
        # is a completed proof, not an exhausted search: by monotonicity no
        # smaller count can work either -> decided UNDER_PROVISIONED.
        if check(hi):
            lo_n, hi_n = lo, hi  # hi_n always feasible
            while lo_n < hi_n and anneals < max_anneals:
                mid = (lo_n + hi_n) // 2
                if check(mid):
                    hi_n = mid
                else:
                    lo_n = mid + 1
            if lo_n < hi_n:
                # budget ran out mid-bracket: hi_n only bounds the true
                # minimum from ABOVE — reporting it as "the minimum" could
                # flip an OVER_PROVISIONED cluster to UNDER.  Say so.
                undecided = True
                upper_bound = hi_n
            else:
                min_feasible = hi_n

        self.last_anneals = records
        if undecided:
            status = ProvisionStatus.UNDECIDED
        elif min_feasible is None:
            # even the largest candidate cannot satisfy the hard goals
            status = ProvisionStatus.UNDER_PROVISIONED
        elif min_feasible > current:
            status = ProvisionStatus.UNDER_PROVISIONED
        elif min_feasible < current:
            status = ProvisionStatus.OVER_PROVISIONED
        else:
            status = ProvisionStatus.RIGHT_SIZED

        if self.sensors is not None:
            self.sensors.timer("planner.rightsize-timer").update(
                time.monotonic() - t0
            )
            self.sensors.counter("planner.rightsize-anneals").inc(anneals)
        return {
            "provisionStatus": status.value,
            "currentBrokers": current,
            "minBrokers": min_feasible,
            # best upper bound the unfinished search established (UNDECIDED
            # only): "no more than this many brokers suffice"
            "minBrokersUpperBound": upper_bound,
            "searchedRange": [lo, hi],
            "annealsRun": anneals,
            "undecided": undecided,
            "degraded": degraded,
            "preMoveViolations": pre_by_count,
            "candidates": [
                verdicts[n].to_json() for n in sorted(verdicts)
            ],
            "loadScenario": load_scenario.to_json() if load_scenario else None,
            "wallSeconds": round(time.monotonic() - t0, 3),
        }
