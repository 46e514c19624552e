"""The two entries a window drives, and the reference's check of each.

  optimize   GoalOptimizer.optimize on a ClusterState that the program's
             model builder (models/builder.py state_from_numpy) made from
             the request's host columns: what /proposals, /rebalance and
             /remove_broker call.  A request runs from the host columns to
             the proposals on the host.
  simulate   ScenarioEvaluator.evaluate(optimize=False) of one batch of
             what-ifs on the live model: what /simulate calls.

Each keeps a sample of its answers, drawn from the seed as the window
runs (a reservoir, so every answer of the window is equally likely to be
checked, however many there are) plus the last, and `check` holds them
against the reference once the window has closed.  Nothing of the
program is imported before an entry is built.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import generator
from reference import answer, goals, scenario

#: floors of the report comparison: an objective and a goal's violation
#: are compared relative to themselves, or to these where they are smaller
#: (an objective of a placement that meets every goal is a sum of
#: rounding-level excursions at the band edges, whose float32 error is a
#: share of itself of no meaning)
VIOLATION_FLOOR = 1e-4
OBJECTIVE_FLOOR = 1e-6


def _span(name):
    return torch.profiler.record_function(name)


def gap(obj, ref_obj, viol, ref_viol) -> tuple[float, int]:
    """The widest relative gap between an answered report (objective,
    violations) and the reference's, and where: -1 the objective, else the
    goal's index."""
    g = abs(float(obj) - ref_obj) / max(abs(ref_obj), OBJECTIVE_FLOOR)
    v = np.abs(np.asarray(viol, np.float64) - ref_viol) / np.maximum(np.abs(ref_viol),
                                                                     VIOLATION_FLOOR)
    if v.size and v.max() > g:
        return float(v.max()), int(v.argmax())
    return float(g), -1


class Sample:
    """A reservoir of `k` items of a stream of unknown length, drawn from
    the seed, and the stream's last item."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen, self.last = k, [], 0, None
        self.rng = generator.rng(seed, 4)

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
        self.last = item

    def all(self) -> list:
        out = list(self.items)
        if self.last is not None and all(x is not self.last for x in out):
            out.append(self.last)
        return out


class OptimizeEntry:
    def __init__(self, config: dict, traffic, device, seed: int, score_dtype=None, search=None):
        from cruise_control_tpu_torch.analyzer import GoalOptimizer
        from cruise_control_tpu_torch.analyzer.engine import OptimizerConfig
        from cruise_control_tpu_torch.analyzer.objective import GoalChain
        from cruise_control_tpu_torch.config.balancing import BalancingConstraint
        from cruise_control_tpu_torch.models.builder import state_from_numpy
        from cruise_control_tpu_torch.models.state import ClusterShape

        self.config, self.traffic, self.device = config, traffic, device
        self.names = list(config["goals"])
        self.constraint = config["constraint"]
        self.shape = ClusterShape(**traffic.dims)
        self.build = state_from_numpy
        cfg = OptimizerConfig(**{**config["search"], **(search or {})},
                              score_dtype=score_dtype or config["score_dtype"])
        self.opt = GoalOptimizer(
            chain=GoalChain.from_names(self.names),
            constraint=BalancingConstraint(**{k: tuple(v) if isinstance(v, list) else v
                                              for k, v in self.constraint.items()}),
            config=cfg, device=device)
        self.sample = Sample(traffic.sample, seed)
        self.units = 1

    def request(self, i: int, rec: dict) -> None:
        cols = self.traffic.ring[i % len(self.traffic.ring)]
        t0 = time.perf_counter()
        with _span("bench.build"):
            state = self.build(cols, self.shape, self.device)
        t1 = time.perf_counter()
        with _span("bench.optimize"):
            res = self.opt.optimize(state)
        t2 = time.perf_counter()
        timing = next((h for h in res.history if h.get("timing")), {})
        rounds = [h for h in res.history if "round" in h]
        rec.update(build_s=t1 - t0, call_s=t2 - t1, host_extract_s=timing.get("host_extract_s"),
                   device_s=timing.get("device_s"), engine_build_s=timing.get("engine_build_s"),
                   captured=bool(timing.get("captured")), rounds=len(rounds),
                   accepted=sum(int(h.get("accepted", 0)) for h in rounds),
                   degraded=bool(res.degraded), units=1)
        a = res.state_after
        self.sample.offer(dict(i=i, proposals=res.proposals,
                               after=(a.replica_broker, a.replica_is_leader, a.replica_disk),
                               obj=(res.objective_before, res.objective_after),
                               viol=(res.violations_before, res.violations_after)))
        del state, res

    def capture_s(self) -> float:
        rows = self.opt.compile_attribution().values()
        return float(sum(r["captureSeconds"] + r["buildSeconds"] for r in rows))

    def release(self) -> None:
        """The sampled answers to the host, and the program's state let go
        (the reference runs after it)."""
        for s in self.sample.all():
            s["after"] = tuple(t.cpu().numpy() for t in s["after"])
        self.opt = None

    def check(self, control_dtype=None) -> dict:
        """The numbers compared, each with its limit's key: summed faults
        of the answered placements and proposals, the worst hard goal's
        violation of an answered placement, the largest ratio of an
        answered placement's objective to its input's (both the
        reference's: how far the search took the cluster), and the widest
        gap between the answered before and after reports and the
        reference's.  With
        `control_dtype` the reference computed in that precision stands in
        the program's place for the reports."""
        dims = self.traffic.dims
        hard = np.array([n in goals.HARD_GOALS for n in self.names])
        faults, worst_hard, worst_gap, ratios, where = 0, 0.0, 0.0, [], None
        for s in self.sample.all():
            cols = self.traffic.ring[s["i"] % len(self.traffic.ring)]
            after = dict(zip(("replica_broker", "replica_is_leader", "replica_disk"), s["after"]))
            faults += answer.placement_faults(cols, dims, after)
            faults += answer.proposal_faults(cols, after, s["proposals"])
            reports = []
            for placement in (None, after):
                ref = goals.evaluate(goals.Cluster(cols, dims, placement=placement), self.names,
                                     self.constraint)
                reports.append(ref)
            worst_hard = max(worst_hard, float(reports[1][1][hard].max(initial=0.0)))
            ratios.append(reports[1][0] / max(reports[0][0], 1e-300))
            answered = list(zip(s["obj"], s["viol"]))
            if control_dtype is not None:
                answered = [goals.evaluate(goals.Cluster(cols, dims, control_dtype, placement=p),
                                           self.names, self.constraint)
                            for p in (None, after)]
            for when, (obj, viol), (r_obj, r_viol) in zip(("before", "after"), answered, reports):
                g, at = gap(obj, r_obj, viol, r_viol)
                if g >= worst_gap:
                    worst_gap, where = g, f"{when}:{'objective' if at < 0 else self.names[at]}"
        # not compared: where the widest gap was, and the ratios' range
        self.readings = dict(report_gap_at=where,
                             objective_ratio_range=[min(ratios), max(ratios)] if ratios else None)
        return dict(proposal_faults=faults, hard_violation=worst_hard,
                    objective_ratio=max(ratios, default=0.0), report_gap=worst_gap)


class SimulateEntry:
    def __init__(self, config: dict, traffic, device, seed: int, score_dtype=None, search=None):
        from cruise_control_tpu_torch.analyzer import ScenarioEvaluator
        from cruise_control_tpu_torch.analyzer.objective import GoalChain
        from cruise_control_tpu_torch.config.balancing import BalancingConstraint
        from cruise_control_tpu_torch.models.builder import state_from_numpy
        from cruise_control_tpu_torch.models.state import ClusterShape
        from cruise_control_tpu_torch.planner import BrokerAdd, Scenario

        self.config, self.traffic, self.device = config, traffic, device
        self.names = list(config["goals"])
        self.constraint = config["constraint"]
        self.ev = ScenarioEvaluator(
            chain=GoalChain.from_names(self.names),
            constraint=BalancingConstraint(**{k: tuple(v) if isinstance(v, list) else v
                                              for k, v in self.constraint.items()}),
            max_scenarios=max(len(b) for b in traffic.ring), device=device)
        # the live model: built once, as the service holds it
        self.base = state_from_numpy(traffic.cols, ClusterShape(**traffic.dims), device)
        self.batches = [[Scenario(name=s["name"], kill_racks=tuple(s.get("kill_racks", ())),
                                  remove_brokers=tuple(s.get("remove_brokers", ())),
                                  add_brokers=tuple(BrokerAdd(count=n, rack=r)
                                                    for n, r in s.get("add_brokers", ())),
                                  topic_load_factors=dict(s.get("topic_factors", {})))
                         for s in batch] for batch in traffic.ring]
        self.sample = Sample(traffic.sample, seed)
        self.units = len(traffic.ring[0])
        self.capture = 0.0

    def request(self, i: int, rec: dict) -> None:
        k = i % len(self.batches)
        t0 = time.perf_counter()
        with _span("bench.evaluate"):
            out = self.ev.evaluate(self.base, self.batches[k], optimize=False)
        t1 = time.perf_counter()
        batch = dict(self.ev.last_batch)
        if batch.get("captured"):
            self.capture += batch.get("warmup_s", 0.0) + batch.get("capture_s", 0.0) \
                + batch.get("instantiate_s", 0.0)
        asked = [s.name for s in self.batches[k]]
        answered = [o.name for o in out]
        rec.update(call_s=t1 - t0, device_ms=batch.get("device_ms"), wall_s=batch.get("wall_s"),
                   degraded=any(o.degraded for o in out), units=len(out),
                   missing=int(answered != asked) * max(1, len(asked) - len(answered)))
        for j, o in enumerate(out):
            self.sample.offer(dict(i=i, j=j, name=o.name, obj=o.objective,
                                   viol=np.asarray(o.violations, np.float64)))

    def capture_s(self) -> float:
        return self.capture

    def release(self) -> None:
        self.ev = self.base = None

    def check(self, control_dtype=None) -> dict:
        """The widest gap between an answered scenario's score (objective,
        violations) and the reference's application and score of it; the
        reference computed in `control_dtype` stands in the program's place
        for the control."""
        worst, where = 0.0, None
        for s in self.sample.all():
            sc = self.traffic.ring[s["i"] % len(self.traffic.ring)][s["j"]]
            if s["name"] != sc["name"]:
                worst = float("inf")
                continue
            cols, dims = scenario.apply(self.traffic.cols, self.traffic.dims, sc)
            r_obj, r_viol = goals.evaluate(goals.Cluster(cols, dims), self.names, self.constraint)
            obj, viol = s["obj"], s["viol"]
            if control_dtype is not None:
                obj, viol = goals.evaluate(goals.Cluster(cols, dims, control_dtype), self.names,
                                           self.constraint)
            g, at = gap(obj, r_obj, viol, r_viol)
            if g >= worst:
                worst, where = g, f"{s['name']}:{'objective' if at < 0 else self.names[at]}"
        self.readings = dict(scenario_gap_at=where)
        return dict(scenario_gap=worst)


ENTRIES = {"optimize": OptimizeEntry, "simulate": SimulateEntry}
