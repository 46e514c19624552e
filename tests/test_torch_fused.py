"""The port's round loops against the JAX package's, and the plain versions
of the fused route's kernels against the reference.

- The fused route (one blocking sync a run) and the legacy route (a host
  loop) each give the reference's placements and history records on the
  four small fixtures at FAST, and each other's at T=0.  Per-round
  objectives (verbose runs) are the goal chain evaluated by the
  reference's compiled program, whose multiply-adds XLA contracts, against
  the port's separately rounded operations: rtol=1e-5, as in
  tests/test_torch_optimizer.py; the temperatures scale the initial
  objective: rtol=1e-6.  Everything else is exact.
- group_by_broker's plain version is a stable argsort; refresh_aggregates'
  is the reference's `_refresh_impl` bit for bit; step_globals' is the
  reference's `_globals` (rtol=1e-6: f32 sums over brokers, which add in
  the same order on these sizes); round_schedule's is the reference's
  `_fused_round_step` on a table of gate inputs covering every branch.
"""

import dataclasses
import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.common.dispatch import dispatch_meter
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import schedule as sk
from cruise_control_tpu_torch.kernels.group import group_by_broker
from cruise_control_tpu_torch.kernels.refresh import AGG_FIELDS
from cruise_control_tpu_torch.models.builder import prewarm_state
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.testing import fixtures as tf

FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
FIXTURES = ["small_cluster", "rack_violated_cluster", "dead_broker_cluster", "jbod_cluster"]
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


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


def _same_records(t_hist, j_hist):
    """Identical round records; the temperatures within rtol=1e-6 (they
    scale the initial objective, which the reference's compiled program
    may round one f32 ulp apart), objectives (verbose) within rtol=1e-5."""
    tr, jr = _rounds(t_hist), _rounds(j_hist)
    drop = ("objective", "temperature")
    assert [{k: v for k, v in h.items() if k not in drop} for h in tr] == \
        [{k: v for k, v in h.items() if k not in drop} for h in jr]
    np.testing.assert_allclose([h["temperature"] for h in tr], [h["temperature"] for h in jr],
                               rtol=1e-6)
    for a, b in zip(tr, jr):
        assert ("objective" in a) == ("objective" in b)
        if "objective" in a:
            np.testing.assert_allclose(a["objective"], b["objective"], rtol=1e-5)


@pytest.mark.parametrize("name", FIXTURES)
def test_fused_route_matches_jax(name):
    js = getattr(jf, name)()
    cfg = dict(FAST, fused_rounds=True)
    j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**cfg)).run(verbose=True)
    t_final, t_hist = TEngine(_port(js), T_CHAIN, config=TConfig(**cfg)).run(verbose=True)
    _same_placement(t_final, j_final)
    _same_records(t_hist, j_hist)
    t = _timing(t_hist)
    assert t["fused"] is True and t["blocking_syncs"] == 1 == _timing(j_hist)["blocking_syncs"]
    assert t["host_dispatch_s"] >= 0.0 and t["device_s"] >= 0.0
    assert any(h.get("extra") for h in _rounds(t_hist))  # a polish round ran


@pytest.mark.parametrize("name", FIXTURES)
def test_legacy_route_matches_jax(name):
    js = getattr(jf, name)()
    cfg = dict(FAST, fused_rounds=False)
    j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**cfg)).run()
    t_final, t_hist = TEngine(_port(js), T_CHAIN, config=TConfig(**cfg)).run()
    _same_placement(t_final, j_final)
    _same_records(t_hist, j_hist)
    t, j = _timing(t_hist), _timing(j_hist)
    assert t["fused"] is False and t["blocking_syncs"] == j["blocking_syncs"]
    assert t["blocking_syncs"] >= len(_rounds(t_hist))


def test_fused_matches_legacy_round_loop():
    """The JAX package's own parity pin (tests/test_optimizer.py
    test_fused_matches_legacy_round_loop) on the port: T=0, fixed seed."""
    state = tf.random_cluster(tf.RandomClusterSpec(num_brokers=10, num_partitions=150, skew=1.2),
                              seed=13, device="cpu")
    base = dict(FAST, num_rounds=4, seed=9, init_temperature_scale=0.0)
    final_f, hist_f = TEngine(state, T_CHAIN, config=TConfig(**base, fused_rounds=True)).run()
    final_l, hist_l = TEngine(state, T_CHAIN, config=TConfig(**base, fused_rounds=False)).run()
    for f in PLACEMENT:
        assert torch.equal(getattr(final_f, f), getattr(final_l, f)), f

    def key(h):
        return (h["round"], h["accepted"], h.get("early_stop"), h.get("extra"))

    assert [key(h) for h in _rounds(hist_f)] == [key(h) for h in _rounds(hist_l)]
    assert _timing(hist_f)["blocking_syncs"] == 1 < _timing(hist_l)["blocking_syncs"]


@pytest.mark.parametrize("fused", [True, False])
def test_main_round_early_stop_matches_jax(fused):
    """A cluster whose full chain is satisfied after round 2 of 6: the
    early stop fires in the main rounds, in both routes, as in the reference."""
    spec = dict(num_brokers=8, num_partitions=100, skew=1.0)
    js = jf.random_cluster(jf.RandomClusterSpec(**spec), seed=17)
    cfg = dict(FAST, num_rounds=6, fused_rounds=fused)
    j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**cfg)).run()
    t_final, t_hist = TEngine(_port(js), T_CHAIN, config=TConfig(**cfg)).run()
    _same_placement(t_final, j_final)
    _same_records(t_hist, j_hist)
    rounds = _rounds(t_hist)
    assert rounds[-1].get("early_stop") is True and len(rounds) < 6


def test_fused_run_meters_one_sync():
    te = TEngine(tf.small_cluster("cpu"), T_CHAIN, config=TConfig(**FAST))
    with dispatch_meter() as m:
        te.run()
    assert m.counts == {"engine.init": 1, "engine.run": 1, "engine.sync": 1}
    te_l = TEngine(tf.small_cluster("cpu"), T_CHAIN, config=TConfig(**FAST, fused_rounds=False))
    with dispatch_meter() as m:
        _, hist = te_l.run()
    assert m.counts["engine.sync"] == _timing(hist)["blocking_syncs"] > 1


def test_second_run_repeats_the_first():
    """A run reuses the engine's buffers: the second run starts from the
    statics again and gives the same result, and the first run's state is
    its own."""
    te = TEngine(tf.dead_broker_cluster("cpu"), T_CHAIN, config=TConfig(**FAST))
    a, ha = te.run()
    kept = a.replica_broker.clone()
    b, hb = te.run()
    assert torch.equal(a.replica_broker, kept)
    assert torch.equal(a.replica_broker, b.replica_broker)
    assert _rounds(ha) == _rounds(hb)


@pytest.mark.parametrize("case", ["random", "one_segment", "all_padding", "empty_segments"])
def test_group_plain_is_stable_argsort(case):
    rng = np.random.default_rng(len(case))
    n_seg, n = 37, 5000
    seg = {
        "random": rng.integers(0, n_seg + 1, n),
        "one_segment": np.full(n, 5),
        "all_padding": np.full(n, n_seg),
        "empty_segments": rng.choice([0, 3, n_seg], n),
    }[case].astype(np.int32)
    kernels.reset_launches()
    g = group_by_broker(torch.from_numpy(seg), n_seg)
    assert kernels.LAUNCHES["group_by_broker"] == 0  # the CPU takes the plain version
    np.testing.assert_array_equal(g.order.numpy(), np.argsort(seg, kind="stable"))
    count = np.bincount(seg, minlength=n_seg + 1)[:n_seg]
    np.testing.assert_array_equal(g.count.numpy(), count)
    np.testing.assert_array_equal(g.start.numpy(), np.cumsum(count) - count)


@pytest.mark.parametrize("name", FIXTURES + ["random"])
def test_refresh_plain_equals_jax_refresh(name):
    """refresh_aggregates' plain version (the engine's refresh) against the
    reference's `_refresh_impl`, bit for bit, on a placement a few greedy
    steps away from the input (so brokers hold mixed, moved rows)."""
    js = (jf.random_cluster(jf.RandomClusterSpec(num_brokers=12, num_partitions=200, skew=1.0), seed=3)
          if name == "random" else getattr(jf, name)())
    je = JEngine(js, J_CHAIN, config=JConfig(**FAST))
    te = TEngine(_port(js), T_CHAIN, config=TConfig(**FAST))
    carry = te.init_carry(Key.from_seed(2))
    for _ in range(4):
        carry, _ = te.step(carry, 0.0)
    jc = je._jit_init(je.statics, jax.random.PRNGKey(2))
    jc = dataclasses.replace(jc, **{f: jnp.asarray(getattr(carry, f).numpy()) for f in PLACEMENT})
    want = je._refresh_impl(je.statics, jc)
    for f in (*AGG_FIELDS, "host_load"):
        getattr(carry, f).fill_(-1)
    te.refresh(carry)
    for f in (*AGG_FIELDS, "host_load"):
        got, ref = getattr(carry, f).numpy(), np.asarray(getattr(want, f))
        if got.dtype == np.float32:
            got, ref = got.view(np.int32), ref.view(np.int32)
        np.testing.assert_array_equal(got, ref, err_msg=f)


@pytest.mark.parametrize("name", ["small_cluster", "dead_broker_cluster", "jbod_cluster"])
def test_globals_plain_matches_jax(name):
    js = getattr(jf, name)()
    je = JEngine(js, J_CHAIN, config=JConfig(**FAST))
    te = TEngine(_port(js), T_CHAIN, config=TConfig(**FAST))
    jc = je._jit_init(je.statics, jax.random.PRNGKey(0))
    g = te._globals(te.init_carry(Key.from_seed(0)))
    want = je._globals(je.statics, jc)
    for k, v in want.items():
        np.testing.assert_allclose(g[k].numpy(), np.asarray(v), rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(g["vec"].numpy()[:4], np.asarray(want["avg_pct"]))


def _jax_round(cfg: JConfig, state, rnd, full_v, acc, cheap):
    """One `_fused_round_step` of the reference with the full chain, the
    steps and the round prep stubbed: the chain reports `full_v`, every
    step accepts `acc`, the prep reports `cheap`."""
    stub = SimpleNamespace(
        config=cfg,
        _eval_impl=lambda sx, c: (jnp.float32(0.0), full_v),
        _scan_impl=lambda sx, c, temps, plan: (c, {"accepted": jnp.full(temps.shape, acc, jnp.int32)}),
        _round_prep_impl=lambda sx, c: (c, plan0, cheap),
        _ys_keys=lambda: ("accepted", "ran", "stopped", "temperature", "cheap"),
    )
    plan0 = jnp.int32(0)
    st = (jnp.int32(0), plan0, *state)
    (_, _, *out, _t0), ys = JEngine._fused_round_step(stub, None, st, rnd, verbose=False)
    return tuple(out), ys


#: gate inputs: round, done, checks_left, cheap_prev, full_v, prev_v, has_prev
_TOL = float(np.float32(1e-6))
_TABLE = list(itertools.product(
    [0, 1, 2, 3, 4], [False, True], [0, 1, 2], [0.0, _TOL, 1e-3, np.inf], [0.0, _TOL, 5e-4, 1e-3],
    [np.inf, 1e-3, 5e-4], [False, True],
))


@pytest.mark.parametrize("decay", [0.5, 0.7])
def test_schedule_plain_matches_jax(decay):
    """round_schedule's plain version, phase by phase, against the
    reference's round step on every row of a table of gate inputs (3 main
    rounds and 2 polish rounds: the cheap gate, the check budget, the
    main stop, the polish stop on a satisfied chain and on a stall, done)."""
    cfg = JConfig(num_rounds=3, max_extra_rounds=2, steps_per_round=2, temperature_decay=decay)
    t0 = np.float32(0.37)
    rows = np.asarray(_TABLE, dtype=np.float64)
    acc, cheap = 7, np.float32(2e-3)

    def ref(rnd, done, checks, cheap_prev, full_v, prev_v, has_prev):
        state = (jnp.float32(cheap_prev), done, checks, jnp.float32(prev_v), has_prev, jnp.float32(t0))
        return _jax_round(cfg, state, rnd, jnp.float32(full_v), acc, jnp.float32(cheap))

    (j_cheap, j_done, j_checks, j_prev, j_has), j_ys = jax.jit(jax.vmap(ref))(
        jnp.asarray(rows[:, 0], jnp.int32), jnp.asarray(rows[:, 1], bool),
        jnp.asarray(rows[:, 2], jnp.int32), jnp.asarray(rows[:, 3], jnp.float32),
        jnp.asarray(rows[:, 4], jnp.float32), jnp.asarray(rows[:, 5], jnp.float32),
        jnp.asarray(rows[:, 6], bool),
    )
    dims = sk.ScheduleDims(n_main=3, total=5, tol_on=True, checks=2, verbose=False, tol=_TOL,
                           scale=1.0)
    for i, (rnd, done, checks, cheap_prev, full_v, prev_v, has_prev) in enumerate(_TABLE):
        s = sk.Schedule.create(5, decay, "cpu")
        s.si[sk.RND], s.si[sk.DONE], s.si[sk.CHECKS], s.si[sk.HAS_PREV] = rnd, done, checks, has_prev
        s.sf[sk.CHEAP_PREV], s.sf[sk.PREV_V], s.sf[sk.T0] = cheap_prev, prev_v, float(t0)
        sk.round_schedule(sk.GATE, s, dims)
        if s.si[sk.NEED_FULL]:
            s.sf[sk.FULL_V] = full_v
        sk.round_schedule(sk.DECIDE, s, dims)
        if s.si[sk.RUN]:
            s.acc += acc * cfg.steps_per_round
            s.sf[sk.CHEAP] = float(cheap)
        sk.round_schedule(sk.CLOSE, s, dims)
        y = dict(zip(sk.YS, s.ys[rnd].tolist()))
        got = (y["accepted"], bool(y["ran"]), bool(y["stopped"]), y["temperature"], y["cheap"],
               bool(s.si[sk.DONE]), int(s.si[sk.CHECKS]), float(s.sf[sk.PREV_V]),
               bool(s.si[sk.HAS_PREV]), float(s.sf[sk.CHEAP_PREV]), int(s.si[sk.RND]))
        want = (float(j_ys["accepted"][i]), bool(j_ys["ran"][i]), bool(j_ys["stopped"][i]),
                float(j_ys["temperature"][i]), float(j_ys["cheap"][i]), bool(j_done[i]),
                int(j_checks[i]), float(j_prev[i]), bool(j_has[i]), float(j_cheap[i]), rnd + 1)
        assert got == want, (_TABLE[i], got, want)
    # every branch is in the table
    assert j_ys["stopped"].any() and j_ys["ran"].any() and not j_ys["ran"].all()
    assert (np.asarray(j_checks) < rows[:, 2]).any()


def test_rebind_keeps_the_run_buffers_only_for_equal_statics():
    """Every generation of the engine's bucket keeps the run's buffers (and,
    on the card, its captured graphs): a repeated request, new loads, other
    capacities; each is copied into the engine's own tensors.  Only a
    member table of another width (max_rf), which the shape does not fix,
    releases them.  Either way the next run is a fresh engine's."""
    st = tf.dead_broker_cluster("cpu")
    te = TEngine(st, T_CHAIN, config=TConfig(**FAST))
    te.run()
    ws = te._ws
    te.rebind(tf.dead_broker_cluster("cpu"))
    assert te._ws is ws
    loads = dataclasses.replace(st, replica_load_leader=st.replica_load_leader * 1.5)
    other = dataclasses.replace(loads, broker_capacity=st.broker_capacity * 2.0)
    wider = prewarm_state(st.shape, max_rf=te.max_rf + 1, device="cpu")
    for gen in (loads, other, wider):
        te.rebind(gen)
        assert (te._ws is ws) == (gen is not wider)
        a, ha = te.run()
        b, hb = TEngine(gen, T_CHAIN, config=TConfig(**FAST)).run()
        assert torch.equal(a.replica_broker, b.replica_broker)
        assert _rounds(ha) == _rounds(hb)
