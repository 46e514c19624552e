"""The port's single-device engine against the JAX package's, step by step.

Both engines start from the same model, carry key and sampling plan; one
step's candidate ids, deltas, survivors and post-apply carry are compared.
Candidate ids and survivors are integer outputs of a bit-exact draw stream
and must be equal.  Deltas and float aggregates are equal on these
clusters too (their broker-axis sums have few enough terms that PyTorch
and XLA add in the same order); the check allows rtol=1e-6, atol=1e-12 —
f32 rounding of sums over brokers — so that it states the contract rather
than the coincidence.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer.engine import build_statics as j_build_statics
from cruise_control_tpu.analyzer.options import OptimizationOptions as JOptions
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.engine import build_statics as t_build_statics
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions as TOptions
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels.candidates import StepKeys, candidates_plain
from cruise_control_tpu_torch.kernels.select import select_plain
from cruise_control_tpu_torch.models import compute_aggregates, validate
from cruise_control_tpu_torch.models.state import STATE_FIELDS

RTOL, ATOL = 1e-6, 1e-12
FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
CARRY_INTS = ("replica_broker", "replica_is_leader", "replica_disk", "broker_replica_count",
              "broker_leader_count", "broker_topic_count", "part_rack_count")
CARRY_FLOATS = ("broker_load", "broker_potential_nw_out", "broker_leader_bytes_in", "disk_load",
                "host_load")


def _jax_state(name):
    if name == "random":
        return jf.random_cluster(jf.RandomClusterSpec(num_brokers=12, num_partitions=200, skew=1.0), seed=3)
    return getattr(jf, name)()


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _engines(js, **cfg):
    cfg = {**FAST, **cfg}
    return JEngine(js, J_CHAIN, config=JConfig(**cfg)), TEngine(_port(js), T_CHAIN, config=TConfig(**cfg))


def _assert_carry_equal(jc, tc):
    for f in CARRY_INTS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)
    for f in CARRY_FLOATS:
        np.testing.assert_allclose(
            getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), rtol=RTOL, atol=ATOL, err_msg=f
        )


@pytest.mark.parametrize("name", ["small_cluster", "dead_broker_cluster", "jbod_cluster", "random"])
def test_build_statics_equal(name):
    js = _jax_state(name)
    B, T = js.shape.B, js.shape.num_topics
    opts = (
        (JOptions(), TOptions()),
        (
            JOptions(excluded_brokers_for_replica_move=np.arange(B) == 1,
                     excluded_topics=np.arange(T) == 0),
            TOptions(excluded_brokers_for_replica_move=np.arange(B) == 1,
                     excluded_topics=np.arange(T) == 0),
        ),
    )
    for jo, to in opts:
        jsx, tsx = j_build_statics(js, jo), t_build_statics(_port(js), to)
        for f in ("part_replicas", "alive", "dest_ids", "dest_ok", "lead_ok", "topic_movable",
                  "host_multi", "host_cap", "total_cap"):
            np.testing.assert_array_equal(getattr(tsx, f).numpy(), np.asarray(getattr(jsx, f)), err_msg=f)
        got = tsx.gen.values()
        for f in ("n_alive", "n_valid", "total_disk_cap", "n_source", "n_dest", "n_brokers"):
            assert got[f] == np.asarray(getattr(jsx, f)).item(), f


@pytest.mark.parametrize("name", ["small_cluster", "dead_broker_cluster", "random"])
def test_one_step_matches(name):
    js = _jax_state(name)
    je, te = _engines(js)
    jsx = je.statics
    jc = je._jit_init(jsx, jax.random.PRNGKey(4))
    tc = te.init_carry(Key.from_seed(4))
    _assert_carry_equal(jc, tc)
    jp, tp = je._jit_plan(jsx, jc), te.plan(tc)
    np.testing.assert_array_equal(tp.order.numpy(), np.asarray(jp.order))
    # the reference's compiled plan contracts multiply-adds (FMA) that its
    # op-by-op evaluation and the port round separately: an ulp apart
    np.testing.assert_allclose(tp.broker_cdf.numpy(), np.asarray(jp.broker_cdf), rtol=RTOL)

    # candidates from the same carry, plan and key: ids exact, deltas within
    # rtol of the reference's op-by-op (IEEE, uncontracted) evaluation
    key, k_r, k_s, k_l, k_u = jax.random.split(jc.key, 5)
    tkeys = StepKeys.of(tc.key)
    g = je._globals(jsx, jc)
    jprop = je._assemble_prop(jsx, jc, *je._propose_kinds(jsx, jc, k_r, k_s, k_l, g, jp))
    tg = te._globals(tc)
    for temperature in (0.0, 1e-3):
        tprop = candidates_plain(te.cand, te.statics, tc, tkeys, tg, tp, temperature)
        for f in ("r", "src", "dst", "d_dst", "topic", "part"):
            np.testing.assert_array_equal(tprop["payr"][f].numpy(), np.asarray(jprop["payr"][f]), err_msg=f)
        for f in ("rf", "rt", "src_b", "dst_b"):
            np.testing.assert_array_equal(tprop["payl"][f].numpy(), np.asarray(jprop["payl"][f]), err_msg=f)
        np.testing.assert_array_equal(tprop["feas"].numpy(), np.asarray(jprop["feas"]))
        np.testing.assert_allclose(tprop["delta"].numpy(), np.asarray(jprop["delta"]), rtol=RTOL, atol=ATOL)

        # survivors exact, post-apply carry matching, greedy and Metropolis
        jc2, jstats = je._accept_select_apply(jsx, jc, jprop, jnp.float32(temperature), key, k_u)
        tc2, tstats = te.select_apply(tc.clone(), tprop, tkeys.next)
        assert int(tstats["accepted"]) == int(jstats["accepted"]) > 0
        assert tc2.key.words == tuple(int(x) for x in np.asarray(jc2.key))
        _assert_carry_equal(jc2, tc2)


def test_incremental_aggregates_stay_consistent():
    """The scatter-updated carry equals a from-scratch aggregation (the
    port's twin of tests/test_optimizer.py::test_incremental_aggregates_stay_consistent)."""
    ts = _port(_jax_state("random"))
    te = TEngine(ts, T_CHAIN, config=TConfig(**FAST))
    carry = te.init_carry(Key.from_seed(0))
    accepted = 0
    for _ in range(24):
        carry, stats = te.step(carry, 0.0)
        accepted += int(stats["accepted"])
    assert accepted > 0
    fresh = compute_aggregates(te.carry_to_state(carry))
    for f in ("broker_replica_count", "broker_leader_count", "part_rack_count", "broker_topic_count"):
        np.testing.assert_array_equal(getattr(carry, f).numpy(), getattr(fresh, f).numpy(), err_msg=f)
    for f in ("broker_load", "broker_potential_nw_out", "broker_leader_bytes_in", "disk_load"):
        np.testing.assert_allclose(
            getattr(carry, f).numpy(), getattr(fresh, f).numpy(), rtol=1e-4, atol=1e-2, err_msg=f
        )


@pytest.mark.parametrize("case", ["ties", "signed_zero", "two_partitions", "random"])
def test_select_plain_equals_argsort_formula(case):
    """The packed-key selection gives exactly the survivors of the
    reference's stable double argsort + segment_min (engine.py:2643)."""
    B, P, K = 5, 7, 64
    rng = np.random.default_rng({"ties": 0, "signed_zero": 1, "two_partitions": 2, "random": 3}[case])
    src = rng.integers(0, B, K).astype(np.int32)
    dst = rng.integers(0, B, K).astype(np.int32)
    part1 = rng.integers(0, P, K).astype(np.int32)
    part2 = part1.copy()
    delta = rng.normal(size=K).astype(np.float32)
    if case == "ties":
        delta = rng.choice(np.float32([-2.0, -1.0, -1.0, 0.5]), K)
    elif case == "signed_zero":
        delta = rng.choice(np.float32([-0.0, 0.0, -1e-30, 1e-30, -3.0]), K)
    elif case == "two_partitions":
        part2 = rng.integers(0, P, K).astype(np.int32)
    accept = rng.random(K) < 0.7
    ref = JEngine._select(
        SimpleNamespace(shape=SimpleNamespace(B=B, P=P)),
        jnp.asarray(accept), jnp.asarray(delta), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(part1), jnp.asarray(part2),
    )
    n_r, n_s = 40, 8
    got, sv_r, acc = select_plain(
        torch.from_numpy(accept), torch.from_numpy(delta), torch.from_numpy(src),
        torch.from_numpy(dst), torch.from_numpy(part1), torch.from_numpy(part2), B, P, n_r, n_s,
    )
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(sv_r.numpy(), np.concatenate([ref[:n_r], ref[n_r:n_r + n_s],
                                                               ref[n_r:n_r + n_s]]))
    assert acc.tolist() == [int(ref.sum())]
    assert got.any()


@pytest.mark.parametrize("field,value", [
    ("intra_broker", True), ("prior_enabled", True), ("diagnostics", True),
    ("score_dtype", "bfloat16"),
])
def test_unported_modes_raise(field, value):
    """Every mode of the JAX package's OptimizerConfig is ported (the name
    is kept from when these raised): each builds an engine and runs on the
    fused route with one blocking sync.  intra_broker draws intra-broker
    disk moves only; prior_enabled carries the prior's CDF (a cold prior
    with none) and the step keys' prior columns; diagnostics adds the
    convergence summary; bfloat16 sums the broker terms in bf16."""
    ts = _port(_jax_state("small_cluster"))
    eng = TEngine(ts, T_CHAIN, config=TConfig(**{**FAST, field: value}))
    final, hist = eng.run()
    timing = hist[-1]
    assert timing["fused"] is True and timing["blocking_syncs"] == 1
    assert validate(final, strict=False) == []
    if field == "intra_broker":
        assert (eng.K_r, eng.K_s, eng.K_l) == (FAST["num_candidates"], 0, 0)
    elif field == "prior_enabled":
        assert tuple(eng.statics.prior_cdf.shape) == (ts.shape.num_topics, ts.shape.B)
        assert float(eng.statics.prior_mix) == 0.0 and eng._ws.prior_keys is not None
    elif field == "diagnostics":
        assert timing["convergence"]["rounds"] == len(hist) - 1
    else:
        assert eng.tp.bf16


def _report_divergence():
    """Where the port's and the reference's trajectories part on a
    50-broker cluster, and the float facts behind it (ROADMAP queue 3)."""
    js = jf.random_cluster(jf.RandomClusterSpec(num_brokers=50, num_partitions=1000, skew=1.0), seed=3)
    je, te = _engines(js)
    jsx = je.statics
    jc, tc = je._jit_init(jsx, jax.random.PRNGKey(0)), te.init_carry(Key.from_seed(0))
    jp, tp = je._jit_plan(jsx, jc), te.plan(tc)
    for step in range(64):
        g, tg = je._globals(jsx, jc), te._globals(tc)
        key, k_r, k_s, k_l, k_u = jax.random.split(jc.key, 5)
        tkeys = StepKeys.of(tc.key)
        jprop = je._assemble_prop(jsx, jc, *je._propose_kinds(jsx, jc, k_r, k_s, k_l, g, jp))
        tprop = candidates_plain(te.cand, te.statics, tc, tkeys, tg, tp, 0.0)
        jc, js_ = je._accept_select_apply(jsx, jc, jprop, jnp.float32(0.0), key, k_u)
        tc, ts_ = te.select_apply(tc, tprop, tkeys.next)
        if int(js_["accepted"]) != int(ts_["accepted"]):
            print(f"first diverging step {step}: survivors {int(js_['accepted'])} (reference) "
                  f"vs {int(ts_['accepted'])} (port)")
            for k in g:
                a, b = np.asarray(g[k]), tg[k].numpy()
                if not np.array_equal(a, b):
                    print(f"  _globals[{k!r}]: reference {a} port {b}")
            d1, d2 = np.asarray(jprop["delta"]), tprop["delta"].numpy()
            acc1 = np.asarray(jprop["feas"]) & (d1 < -1e-12)
            acc2 = tprop["feas"].numpy() & (d2 < -1e-12)
            for i in np.nonzero(acc1 != acc2)[0]:
                print(f"  candidate {i}: delta {d1[i]:.3e} (reference) vs {d2[i]:.3e} (port)")
            break
    else:
        print("no divergence in 64 steps")

    js = jf.small_cluster()
    je, te = _engines(js)
    jc = je._jit_init(je.statics, jax.random.PRNGKey(4))
    jp = je._jit_plan(je.statics, jc)
    key, k_r, k_s, k_l, k_u = jax.random.split(jc.key, 5)

    def delta(sx, c, k_r, k_s, k_l, plan):
        return je._assemble_prop(sx, c, *je._propose_kinds(sx, c, k_r, k_s, k_l, je._globals(sx, c), plan))["delta"]

    eager = np.asarray(delta(je.statics, jc, k_r, k_s, k_l, jp))
    jitted = np.asarray(jax.jit(delta)(je.statics, jc, k_r, k_s, k_l, jp))
    print(f"small_cluster deltas, reference jitted vs op-by-op: max abs diff {np.abs(eager - jitted).max():.3e}")

    rng = np.random.default_rng(0)
    u = rng.random(100_000).astype(np.float32)
    exact = np.sqrt(u.astype(np.float64)).astype(np.float32)
    print("f32 sqrt not correctly rounded: torch CPU", int((torch.sqrt(torch.from_numpy(u)).numpy() != exact).sum()),
          "of", u.size, "; jnp", int((np.asarray(jnp.sqrt(jnp.asarray(u))) != exact).sum()))
    print("f32 log, torch CPU vs jnp: differ in", int((torch.log(torch.from_numpy(u)).numpy()
                                                    != np.asarray(jnp.log(jnp.asarray(u)))).sum()), "of", u.size)
    bad_t = bad_j = 0
    for _ in range(200):
        p = rng.random(4).astype(np.float32)
        p /= p.sum()
        seq = np.cumsum(p, dtype=np.float32)
        bad_t += int((torch.cumsum(torch.from_numpy(p), 0).numpy() != seq).sum())
        bad_j += int((np.asarray(jnp.cumsum(jnp.asarray(p))) != seq).sum())
    print(f"f32 prefix sums of 200 4-broker CDFs differing from the sequential f32 sum: "
          f"torch CPU {bad_t} of 800 entries, jnp {bad_j}")


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_engine.py
    # prints the divergence record of ROADMAP queue 3
    _report_divergence()
