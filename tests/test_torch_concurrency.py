"""The port's GoalOptimizer under concurrent callers, held to its own
single-thread results and to the JAX package's.

One optimizer shared by threads: its engine cache is locked, a run pins its
engine until its result is on the host, an eviction that finds the engine
pinned leaves the release to the last unpin, and runs on one engine (one
fixed workspace) take turns.  Bars: every threaded run's placements,
proposals and round history equal the single-thread run of the same state
(and the JAX package's placements on the small fixtures); no engine is
released while a run holds it.
"""

import dataclasses
import threading

import numpy as np
import pytest

from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import GoalOptimizer, OptimizerConfig, ScenarioEvaluator
from cruise_control_tpu_torch.analyzer.engine import Engine
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.planner import Scenario

FAST = dict(num_candidates=128, leadership_candidates=32, steps_per_round=12, num_rounds=2, seed=1)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk", "replica_offline")
SHAPES = ("small_cluster", "dead_broker_cluster")


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _outcome(res):
    """What a run decided: its placement, proposals and round records (the
    timing record, with its clocks and cache hits, aside)."""
    place = tuple(getattr(res.state_after, f).numpy().tobytes() for f in PLACEMENT)
    props = [(p.partition, p.old_leader, p.new_leader, p.old_replicas, p.new_replicas,
              p.disk_moves) for p in res.proposals]
    rounds = [h for h in res.history if not h.get("timing")]
    return place, props, rounds, float(res.objective_after)


@pytest.fixture(scope="module")
def states():
    return {n: getattr(jf, n)() for n in SHAPES}


@pytest.fixture(scope="module")
def single(states):
    """Each fixture's single-thread outcome, checked against the JAX
    package's placement."""
    out = {}
    for name, js in states.items():
        res = GoalOptimizer(config=OptimizerConfig(**FAST), device="cpu").optimize(_port(js))
        jres = JOptimizer(config=JConfig(**FAST)).optimize(js)
        for f in PLACEMENT:
            np.testing.assert_array_equal(getattr(res.state_after, f).numpy(),
                                          np.asarray(getattr(jres.state_after, f)), err_msg=f)
        out[name] = _outcome(res)
    return out


@pytest.fixture
def release_log(monkeypatch):
    """Every release of an engine evicted from a cache, with the pins it
    held then (an engine also releases its own graphs in a rebind)."""
    log = []
    real = Engine.release

    def release(self):
        if getattr(self, "_cc_evicted", False):
            log.append((id(self), self._cc_pins))
        real(self)

    monkeypatch.setattr(Engine, "release", release)
    return log


def _run_threads(jobs):
    """Run each job list in a thread of its own; the results per thread, in
    order.  A thread's exception fails the test."""
    results = [[] for _ in jobs]
    errors = []
    start = threading.Barrier(len(jobs))

    def work(i):
        try:
            start.wait()
            for job in jobs[i]:
                results[i].append(job())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def test_two_threads_one_shape(states, single, release_log):
    """Two threads optimizing one shape share one engine and take turns on
    it: each gets the single-thread result."""
    opt = GoalOptimizer(config=OptimizerConfig(**FAST), device="cpu")
    st = _port(states["small_cluster"])
    job = lambda: _outcome(opt.optimize(st))  # noqa: E731
    results = _run_threads([[job] * 3, [job] * 3])
    for per_thread in results:
        assert per_thread == [single["small_cluster"]] * 3
    assert opt.engine_cache_misses + opt.engine_cache_hits == 6
    assert len(opt._engines) == 1 and all(e._cc_pins == 0 for e in opt._engines.values())
    assert all(pins == 0 for _, pins in release_log)


def test_threads_alternate_two_shapes_one_slot(states, single, release_log):
    """Threads alternating two shapes through a cache of one engine: every
    run evicts the other shape's engine, often while a run holds it; each
    run gets its single-thread result and no engine is released pinned."""
    opt = GoalOptimizer(config=OptimizerConfig(**FAST), device="cpu", engine_cache_size=1)
    ports = {n: _port(js) for n, js in states.items()}

    def job(name):
        return lambda: (name, _outcome(opt.optimize(ports[name])))

    a, b = SHAPES
    results = _run_threads([[job(a), job(b), job(a)], [job(b), job(a), job(b)]])
    for per_thread in results:
        for name, got in per_thread:
            assert got == single[name], name
    assert opt.engine_cache_misses >= 2
    assert all(pins == 0 for _, pins in release_log)
    assert len(opt._engines) == 1


def test_eviction_waits_for_the_last_unpin(states, release_log, monkeypatch):
    """Deterministic order: a run on shape A holds its engine while another
    thread's miss on shape B evicts it from a one-engine cache; the engine
    is released only when A's run ends, and both results are the
    single-thread ones."""
    opt = GoalOptimizer(config=OptimizerConfig(**FAST), device="cpu", engine_cache_size=1)
    sa, sb = (_port(states[n]) for n in SHAPES)
    want_a = _outcome(GoalOptimizer(config=OptimizerConfig(**FAST), device="cpu").optimize(sa))
    inside, go_on = threading.Event(), threading.Event()
    real = Engine.run_reported

    def run_reported(self, **kw):
        if self.shape == sa.shape:
            inside.set()
            assert go_on.wait(60)
        return real(self, **kw)

    monkeypatch.setattr(Engine, "run_reported", run_reported)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("a", _outcome(opt.optimize(sa))))
    t.start()
    assert inside.wait(60)
    (engine_a,) = opt._engines.values()
    opt.optimize(sb)  # a miss: publishes B's engine and evicts A's, pinned
    assert engine_a._cc_evicted and engine_a._cc_pins == 1
    assert id(engine_a) not in [e for e, _ in release_log]
    assert opt.has_engine_for(sb.shape) and not opt.has_engine_for(sa.shape)
    go_on.set()
    t.join()
    assert out["a"] == want_a
    assert (id(engine_a), 0) in release_log  # released at the last unpin
    assert all(pins == 0 for _, pins in release_log)


def test_scenario_fixes_from_threads(states, release_log):
    """ScenarioEvaluator.evaluate(optimize=True) from two threads: each
    fix anneals through the shared optimizer outside the evaluator's lock;
    both calls give the single-thread outcomes."""
    chain_opt = lambda: GoalOptimizer(config=OptimizerConfig(**FAST), device="cpu")  # noqa: E731
    st = _port(states["small_cluster"])
    scen = [Scenario(name="lose-0", remove_brokers=(0,)), Scenario(name="id")]

    def fixes(ev):
        return [(o.objective, o.fix["numReplicaMovements"], o.fix["numLeaderMovements"],
                 o.fix["objectiveAfter"]) for o in ev.evaluate(st, scen, optimize=True)]

    want = fixes(ScenarioEvaluator(optimizer=chain_opt(), device="cpu"))
    ev = ScenarioEvaluator(optimizer=chain_opt(), device="cpu")
    job = lambda: fixes(ev)  # noqa: E731
    results = _run_threads([[job, job], [job, job]])
    for per_thread in results:
        assert per_thread == [want, want]
    assert all(pins == 0 for _, pins in release_log)
