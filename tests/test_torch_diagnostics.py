"""Convergence diagnostics of the port against the JAX package's, on the CPU.

- The JAX package's pins (tests/test_ledger.py:143-171, :207-218) on the
  port: with diagnostics on, the placements of the run without them bit
  for bit; the off path's records and timing carry no diagnostics field;
  the on path's history schema (per-goal violations, survivors by kind
  adding up to `accepted`, prior usage, the convergence summary); the ys
  key constants.
- Against the JAX package's engine with diagnostics on, on the small
  fixtures (test_ledger's `SMALL` and the four of testing/fixtures.py):
  the placements of both routes, and on the fused route every round's
  accepted count, survivors by kind and prior usage exactly; the round
  objectives and per-goal violations, and the convergence summary's
  trajectories, within rtol 1e-5 (plus the 1e-8 of the records' rounding
  to 8 decimals): the reference's compiled chain contracts multiply-adds,
  the port rounds each operation, as in tests/test_torch_fused.py.  The
  temperatures within rtol 1e-6 (they scale the initial objective).
- The fused route keeps its one blocking sync; the legacy route ignores
  diagnostics, as the reference's does.
- The plain versions of the two kernels that carry them: select_survivors'
  six counts (kernels/select.py DIAG_FIELDS) against the reference's
  `stats` formula, and the schedule's diagnostics columns (counts and
  violations of rounds that ran, 0 and NaN elsewhere, EXIT included).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer import engine as j_engine
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer import engine as t_engine
from cruise_control_tpu_torch.common.dispatch import dispatch_meter
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import schedule as sk
from cruise_control_tpu_torch.kernels import select as select_k
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.testing import fixtures as tf

SMALL = dict(num_brokers=12, num_partitions=200, num_racks=4, num_topics=6, skew=1.0)
#: test_ledger's and test_controller's search config
CFG = dict(num_candidates=128, leadership_candidates=32, swap_candidates=16, steps_per_round=8,
           num_rounds=3, seed=0)
FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
#: (JAX state builder, search config) of each small fixture
CASES = {
    "SMALL": (lambda: jf.random_cluster_fast(jf.RandomClusterSpec(**SMALL), seed=3), CFG),
    "small_cluster": (jf.small_cluster, FAST),
    "rack_violated_cluster": (jf.rack_violated_cluster, FAST),
    "dead_broker_cluster": (jf.dead_broker_cluster, FAST),
    "jbod_cluster": (jf.jbod_cluster, FAST),
}
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
RTOL, ATOL = 1e-5, 1e-8


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _rounds(history):
    return [h for h in history if "round" in h]


def _timing(history):
    (t,) = [h for h in history if h.get("timing")]
    return t


def _same_placement(t_state, j_state):
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f)),
                                      err_msg=f)


def _same_port_placement(a, b):
    for f in PLACEMENT:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_diagnostics_byte_parity_plain_and_history_schema():
    """tests/test_ledger.py test_diagnostics_byte_parity_plain_and_history_schema
    on the port."""
    state = tf.random_cluster_fast(tf.RandomClusterSpec(**SMALL), seed=3, device="cpu")
    off, hist_off = TEngine(state, T_CHAIN, config=TConfig(**CFG)).run()
    on, hist_on = TEngine(state, T_CHAIN, config=TConfig(**CFG, diagnostics=True)).run()
    _same_port_placement(off, on)
    rounds_off, rounds_on = _rounds(hist_off), _rounds(hist_on)
    assert len(rounds_off) == len(rounds_on)
    for rec in rounds_off:
        assert "goal_violations" not in rec and "objective" not in rec
    assert "convergence" not in _timing(hist_off)
    n_goals = len(T_CHAIN.goals)
    for rec in rounds_on:
        assert len(rec["goal_violations"]) == n_goals
        assert set(rec["accepted_by_kind"]) == {"replica", "swap", "leadership"}
        assert rec["accepted"] == sum(rec["accepted_by_kind"].values())
        assert rec["prior"] == {"candidates": 0, "accepted": 0}  # prior off
    conv = _timing(hist_on)["convergence"]
    assert conv["rounds"] == len(rounds_on)
    assert len(conv["objective_trajectory"]) == conv["rounds"]
    assert conv["goal_names"] == T_CHAIN.names()
    assert len(conv["final_goal_violations"]) == n_goals
    assert conv["objective_trajectory"][-1] <= conv["objective_trajectory"][0]


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol,
                               atol=ATOL)


def _same_diag_records(t_hist, j_hist):
    tr, jr = _rounds(t_hist), _rounds(j_hist)
    assert len(tr) == len(jr)
    floats = ("objective", "goal_violations", "temperature")
    assert [{k: v for k, v in h.items() if k not in floats} for h in tr] == \
        [{k: v for k, v in h.items() if k not in floats} for h in jr]
    for a, b in zip(tr, jr):
        _close(a["objective"], b["objective"])
        _close(a["goal_violations"], b["goal_violations"])
        _close(a["temperature"], b["temperature"], rtol=1e-6)
    tc, jc = _timing(t_hist)["convergence"], _timing(j_hist)["convergence"]
    assert set(tc) == set(jc)
    floats = ("objective_trajectory", "temperatures", "final_goal_violations")
    assert {k: v for k, v in tc.items() if k not in floats} == \
        {k: v for k, v in jc.items() if k not in floats}
    _close(tc["objective_trajectory"], jc["objective_trajectory"])
    _close(tc["final_goal_violations"], jc["final_goal_violations"])
    _close(tc["temperatures"], jc["temperatures"], rtol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_diagnostics_match_jax(name):
    """Both routes' placements, and the fused route's diagnostics records
    and convergence summary, against the JAX package's on one fixture."""
    build, cfg = CASES[name]
    js = build()
    for fused in (True, False):
        c = dict(cfg, diagnostics=True, fused_rounds=fused)
        j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**c)).run()
        t_final, t_hist = TEngine(_port(js), T_CHAIN, config=TConfig(**c)).run()
        _same_placement(t_final, j_final)
        if fused:
            _same_diag_records(t_hist, j_hist)
        else:
            assert [h["accepted"] for h in _rounds(t_hist)] == [h["accepted"] for h in _rounds(j_hist)]
            assert "accepted_by_kind" not in _rounds(t_hist)[0]


def test_diagnostics_with_prior_match_jax():
    """The prior counts: a peaked prior at mix 0.5 on SMALL, diagnostics on;
    every round's prior candidates and survivors equal the JAX package's."""
    js = jf.random_cluster_fast(jf.RandomClusterSpec(**SMALL), seed=3)
    weights = np.zeros((js.shape.num_topics, js.shape.B), np.float32)
    weights[:, 0] = 1.0
    weights[::2, 5] = 3.0
    prior = tf.prior_table(js.shape, 0, 0.5)
    prior = dataclasses.replace(prior, weights=weights)
    c = dict(CFG, diagnostics=True, prior_enabled=True)
    j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**c), prior=prior).run()
    t_final, t_hist = TEngine(_port(js), T_CHAIN, config=TConfig(**c), prior=prior).run()
    _same_placement(t_final, j_final)
    _same_diag_records(t_hist, j_hist)
    conv = _timing(t_hist)["convergence"]
    assert 0 < conv["prior"]["accepted"] <= conv["prior"]["candidates"]


def test_diag_ys_key_constants_are_consistent():
    """tests/test_ledger.py test_diag_ys_key_constants_are_consistent on the
    port, whose constants are the JAX package's."""
    assert t_engine.FUSED_YS_KEYS == j_engine.FUSED_YS_KEYS
    assert t_engine.FUSED_DIAG_YS_KEYS == j_engine.FUSED_DIAG_YS_KEYS
    assert set(t_engine.FUSED_YS_KEYS) < set(t_engine.FUSED_DIAG_YS_KEYS)
    state = tf.random_cluster_fast(tf.RandomClusterSpec(**SMALL), seed=3, device="cpu")
    eng_off = TEngine(state, T_CHAIN, config=TConfig(**CFG))
    eng_on = TEngine(state, T_CHAIN, config=TConfig(**CFG, diagnostics=True))
    assert eng_off._ys_keys() == t_engine.FUSED_YS_KEYS
    assert eng_on._ys_keys() == t_engine.FUSED_DIAG_YS_KEYS
    assert eng_on._workspace().sched.ys.shape[1] == len(sk.YS) + len(sk.DIAG_YS) + len(T_CHAIN.goals)
    assert eng_off._workspace().sched.ys.shape[1] == len(sk.YS)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_diagnostics_syncs(fused):
    """The fused route with diagnostics makes its one blocking sync; the
    legacy route makes the syncs it makes without them and reports no
    diagnostics (the reference's legacy loop ignores the flag)."""
    state = tf.small_cluster("cpu")
    counts = []
    for diag in (False, True):
        eng = TEngine(state, T_CHAIN, config=TConfig(**FAST, fused_rounds=fused, diagnostics=diag))
        with dispatch_meter() as m:
            _, hist = eng.run()
        counts.append(m.counts)
        assert ("convergence" in _timing(hist)) == (diag and fused)
    assert counts[0] == counts[1]
    if fused:
        assert counts[1] == {"engine.init": 1, "engine.run": 1, "engine.sync": 1}


@pytest.mark.parametrize("with_prior", [False, True], ids=["no_prior", "prior"])
@pytest.mark.parametrize("case", tf.SELECT_CASES)
def test_select_plain_diag_counts(case, with_prior):
    """select_plain's diagnostics counts are the reference's `stats`
    (engine.py:2699-2711) of its survivor mask: survivors by kind, the
    prior-drawn relocations and those that survived; the survivors and
    the relocation mask are those of the count-only call."""
    c = tf.select_case(case)
    args = [torch.from_numpy(c[f]) for f in tf.SELECT_INPUTS]
    n_r, n_s = c["n_r"], c["n_s"]
    fp = torch.from_numpy(np.random.default_rng(len(case)).random(n_r) < 0.4) if with_prior else None
    acc = torch.full((len(select_k.DIAG_FIELDS),), 2, dtype=torch.int64)
    survive, sv_r, got = select_k.select_plain(*args, c["B"], c["P"], n_r, n_s, acc=acc,
                                              from_prior=fp, diag=True)
    ref = select_k.select_plain(*args, c["B"], c["P"], n_r, n_s)
    assert torch.equal(survive, ref[0]) and torch.equal(sv_r, ref[1])
    fp = torch.zeros(n_r, dtype=torch.bool) if fp is None else fp
    sv = survive.numpy()
    want = [sv.sum(), sv[:n_r].sum(), sv[n_r:n_r + n_s].sum(), sv[n_r + n_s:].sum(),
            fp.numpy().sum(), (sv[:n_r] & fp.numpy()).sum()]
    assert got is acc and (got - 2).tolist() == [int(x) for x in want]


def test_schedule_plain_diag_columns():
    """The schedule's plain version with diagnostics: a round that ran gets
    the step counts after the total and the stage's objective and
    violations; a masked round, and the rounds EXIT writes, get 0 counts
    and NaN; the base columns are those of the same run without
    diagnostics."""
    G = 4
    tol = float(np.float32(1e-6))
    rows = {}
    for diag in (False, True):
        dims = sk.ScheduleDims(n_main=3, total=6, tol_on=True, checks=2, verbose=False, tol=tol,
                               scale=float(np.float32(1e-2)), diag=diag, n_goals=G if diag else 0)
        s = sk.Schedule.create(6, 0.5, "cpu", diag=diag, n_goals=G if diag else 0)
        s.sf[sk.OBJ] = 10.0
        sk.round_schedule(sk.INIT, s, dims)
        cheap = [1.0, 1.0, 1.0, 1.0]
        while True:
            rnd = int(s.si[sk.RND])
            sk.round_schedule(sk.GATE, s, dims)
            if s.si[sk.NEED_FULL]:
                s.sf[sk.FULL_V] = 0.0 if rnd == 4 else 1.0  # polish round 4 ends the run
            sk.round_schedule(sk.DECIDE, s, dims)
            if s.si[sk.RUN]:
                s.acc[0] += 10 + rnd
                if diag:
                    s.acc[1:] += torch.tensor([4, 3, 3 + rnd, 6, 2])
                    s.stage.copy_(torch.tensor([1.0 / (rnd + 1), 0.25, 0.0, 0.5, 1e-7]))
                s.sf[sk.CHEAP] = cheap[rnd]
            sk.round_schedule(sk.CLOSE, s, dims)
            if not s.si[sk.LOOP]:
                break
        sk.round_schedule(sk.EXIT, s, dims)
        rows[diag] = s.ys.clone()
    off, on = rows[False], rows[True]
    col = sk.ys_columns(dims)
    assert on.shape == (6, len(sk.YS) + len(sk.DIAG_YS) + G)
    base = [c for k, c in col.items() if k in sk.YS and k != "objective"]
    assert torch.equal(on[:, base], off[:, base])
    ran = on[:, col["ran"]] == 1
    assert ran.tolist() == [True, True, True, True, False, False]
    r = torch.arange(6, dtype=torch.float64)[ran]
    assert torch.equal(on[ran, col["accepted"]], 10 + r)
    assert torch.equal(on[ran][:, [col[k] for k in sk.DIAG_YS]],
                       torch.stack([torch.full_like(r, 4), torch.full_like(r, 3), 3 + r,
                                    torch.full_like(r, 6), torch.full_like(r, 2)], 1))
    assert torch.equal(on[ran, col["objective"]], torch.tensor([1.0, 0.5, 1 / 3, 0.25]).float().double())
    g0 = col["goal_viol"]
    assert torch.equal(on[ran, g0:g0 + G], torch.tensor([0.25, 0.0, 0.5, 1e-7]).float().double().expand(4, G))
    assert bool(on[~ran, g0:].isnan().all()) and bool((on[~ran][:, [col[k] for k in sk.DIAG_YS]] == 0).all())
    assert bool(on[~ran, col["objective"]].isnan().all()) and bool(off[:, col["objective"]].isnan().all())
