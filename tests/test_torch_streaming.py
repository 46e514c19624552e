"""The streaming cycle against the JAX package's, on the CPU.

`LiveState` (models/whatif.py), `Engine.run_cycle` and
`GoalOptimizer.optimize_streaming_cycle` / `has_engine_for` are held to the
JAX package's on the same numpy-seeded inputs.  Bars: LiveState's scatter
and liveness update exact (loads, widths, replica_offline), sentinel rows
and an empty window included; `run_cycle` on three fixtures, warm from the
JAX package's first result: scattered loads, placements, checks, round
records and the width exact, but temperatures and objectives (f32 sums in
another order: rtol 1e-6 and 1e-5) and stats (rtol 1e-6); a 4-window
replay with the learned prior on two clusters: the port's fused path
equals its staged path (LiveState.set_partition_loads + optimize) byte for
byte, every port cycle counts exactly its two dispatches, and the live
loads and before-reports are the JAX package's cycles'; on the JBOD
fixture so is the whole chain, while on the random cluster the JAX
package's compiled anneal parts from its own op-by-op evaluation, which
the port follows (ROADMAP queue 3).  No cycle without a cached engine; a
rebind with new loads only keeps the workspace, builds its statics once
and writes no tensor an earlier caller holds.

The JAX package's cycle donates the load arrays it is given, so each JAX
call gets fresh arrays and the donated ones are never read again.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.models.whatif import HostState as JHostState
from cruise_control_tpu.models.whatif import LiveState as JLiveState
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import GoalOptimizer as TOptimizer
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer import engine as engine_mod
from cruise_control_tpu_torch.analyzer.proposals import fetch_before_host
from cruise_control_tpu_torch.common.dispatch import dispatch_meter
from cruise_control_tpu_torch.controller import MoveAcceptancePrior
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.models import ClusterCatalog
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.models.whatif import HostState, LiveState, default_capacity_profile

# tests/test_controller.py's cluster and search config
SMALL = jf.RandomClusterSpec(num_brokers=12, num_partitions=200, num_racks=4, num_topics=6, skew=1.0)
CFG = dict(num_candidates=128, leadership_candidates=32, swap_candidates=16, steps_per_round=8,
           num_rounds=3, seed=0)
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
STATS = ("avg", "max", "min", "std", "replica_count_std", "leader_count_std",
         "potential_nw_out_std")


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _window(state, every: int, factor: float, sentinels: int = 0, offset: int = 0):
    """The replica rows of every `every`-th partition (from `offset`), at
    `factor` times their loads, then `sentinels` rows of the sentinel R
    (dropped by the scatter)."""
    valid = np.asarray(state.replica_valid)
    part = np.asarray(state.replica_partition)
    rows = np.nonzero(valid & ((part - offset) % every == 0))[0].astype(np.int32)
    ll = np.asarray(state.replica_load_leader)[rows] * np.float32(factor)
    fl = np.asarray(state.replica_load_follower)[rows] * np.float32(factor)
    R = state.shape.R
    pad = np.full(sentinels, R, np.int32)
    z = np.ones((sentinels, 4), np.float32)
    return (np.concatenate([rows, pad]), np.concatenate([ll, z]).astype(np.float32),
            np.concatenate([fl, z]).astype(np.float32))


def _catalog(shape):
    return ClusterCatalog(topics=tuple(f"t{t}" for t in range(shape.num_topics)), partitions=())


def _same_rounds(t_hist, j_hist):
    """Round records equal, temperatures within rtol 1e-6 (T0 scales the
    initial objective, an f32 sum taken in another order, as in
    tests/test_torch_fused.py)."""
    tr = [h for h in t_hist if "round" in h]
    jr = [h for h in j_hist if "round" in h]
    assert [{k: v for k, v in h.items() if k != "temperature"} for h in tr] == \
        [{k: v for k, v in h.items() if k != "temperature"} for h in jr]
    np.testing.assert_allclose([h["temperature"] for h in tr], [h["temperature"] for h in jr],
                               rtol=1e-6)


# ----------------------------------------------------------------- live state


@pytest.mark.parametrize("case", ["rows", "sentinels", "empty", "all"])
def test_live_state_scatter_matches_jax(case):
    """LiveState.set_partition_loads: the same loads and width as the JAX
    package's, untouched rows and the placement unchanged, in place."""
    js = jf.random_cluster_fast(SMALL, seed=9)
    R = js.shape.R
    rows, ll, fl = {
        "rows": lambda: _window(js, 7, 1.1),
        "sentinels": lambda: _window(js, 5, 0.5, sentinels=9),
        "empty": lambda: (np.zeros(0, np.int32), np.zeros((0, 4), np.float32),
                          np.zeros((0, 4), np.float32)),
        "all": lambda: _window(js, 1, 1.03),
    }[case]()
    if case == "sentinels":
        rows[1] = R + 3  # past the sentinel: dropped too
    ts = _port(js)
    t_live = LiveState(ts)
    t_ll = ts.replica_load_leader
    t_width = t_live.set_partition_loads(rows, ll, fl)
    assert t_live.state.replica_load_leader is t_ll  # in place
    fresh = jf.random_cluster_fast(SMALL, seed=9)
    j_live = JLiveState(dataclasses.replace(
        fresh, replica_load_leader=jnp.array(np.asarray(fresh.replica_load_leader)),
        replica_load_follower=jnp.array(np.asarray(fresh.replica_load_follower))))
    j_width = j_live.set_partition_loads(rows, ll, fl)
    assert t_width == j_width
    for f in ("replica_load_leader", "replica_load_follower", *PLACEMENT):
        np.testing.assert_array_equal(getattr(t_live.state, f).numpy(),
                                      np.asarray(getattr(j_live.state, f)), err_msg=f)
    if case == "empty":
        np.testing.assert_array_equal(t_live.state.replica_load_leader.numpy(),
                                      np.asarray(js.replica_load_leader))


def test_live_state_broker_liveness_matches_jax():
    """set_broker_liveness: broker_alive replaced and replica_offline
    re-derived as the JAX package's, dead disks included; new tensors."""
    js = jf.jbod_cluster()
    ts = _port(js)
    alive = np.asarray(js.broker_alive).copy()
    alive[int(np.asarray(js.replica_broker)[0])] = False
    t_live, j_live = LiveState(ts), JLiveState(js)
    t_live.set_broker_liveness(alive)
    j_live.set_broker_liveness(alive)
    for f in ("broker_alive", "replica_offline"):
        np.testing.assert_array_equal(getattr(t_live.state, f).numpy(),
                                      np.asarray(getattr(j_live.state, f)), err_msg=f)
    assert t_live.state.replica_offline is not ts.replica_offline
    assert bool(t_live.state.replica_offline.any())


def test_host_state_round_trip_and_capacity_profile():
    """HostState.of(s).to_state(s) is s; a touched field comes back as a new
    tensor of the edited values; default_capacity_profile is the JAX
    package's."""
    js = jf.random_cluster_fast(SMALL, seed=9)
    ts = _port(js)
    h = HostState.of(ts)
    assert h.to_state(ts) is ts
    h.scale_topic_load(2, 1.5)
    jh = JHostState.of(js)
    jh.scale_topic_load(2, 1.5)
    out = h.to_state(ts)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jh.to_state(js), f)))
    assert out.replica_broker is ts.replica_broker
    assert out.replica_load_leader is not ts.replica_load_leader
    from cruise_control_tpu.models.whatif import default_capacity_profile as j_profile

    np.testing.assert_array_equal(default_capacity_profile(h), j_profile(jh))


# ------------------------------------------------------------------ run_cycle


@pytest.mark.parametrize("fixture", ["small_cluster", "jbod_cluster", "random_small"])
def test_run_cycle_matches_jax(fixture):
    """Engine.run_cycle against the JAX package's on the same window, warm
    from the JAX package's first result."""
    def make():
        return jf.random_cluster_fast(SMALL, seed=9) if fixture == "random_small" \
            else getattr(jf, fixture)()

    js = make()
    cfg = dict(CFG, seed=1)
    jeng = JEngine(js, J_CHAIN, config=JConfig(**cfg))
    first, _ = jeng.run()
    warm = tuple(np.array(getattr(first, f)) for f in PLACEMENT)
    rows, ll, fl = _window(js, 3, 1.25, sentinels=3)
    j_ll, j_fl, host, j_hist = jeng.run_cycle(
        jnp.array(np.asarray(js.replica_load_leader)), jnp.array(np.asarray(js.replica_load_follower)),
        rows, ll, fl, warm)
    ts = _port(make())
    teng = TEngine(ts, T_CHAIN, config=TConfig(**cfg))
    t_ll, t_fl = ts.replica_load_leader.clone(), ts.replica_load_follower.clone()
    with dispatch_meter() as m:
        out_ll, out_fl, payload, t_hist = teng.run_cycle(
            t_ll, t_fl, rows, ll, fl, tuple(torch.from_numpy(a) for a in warm))
    assert m.counts == {"engine.cycle": 1, "engine.extract": 1}
    assert out_ll is t_ll and out_fl is t_fl
    np.testing.assert_array_equal(t_ll.numpy(), np.asarray(j_ll))
    np.testing.assert_array_equal(t_fl.numpy(), np.asarray(j_fl))
    for f in (*PLACEMENT, "replica_offline", "replica_disk_bytes", "checks"):
        np.testing.assert_array_equal(payload[f], np.asarray(host[f]), err_msg=f)
    for t, f in zip(payload["placement"], (*PLACEMENT, "replica_offline")):
        np.testing.assert_array_equal(t.numpy(), np.asarray(host[f]), err_msg=f)
    _same_rounds(t_hist, j_hist)
    for when in ("before", "after"):
        np.testing.assert_allclose(payload[f"obj_{when}"], np.asarray(host[f"obj_{when}"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(payload[f"viol_{when}"], np.asarray(host[f"viol_{when}"]),
                                   rtol=1e-5, atol=1e-7)
        for f in STATS:
            np.testing.assert_allclose(getattr(payload[f"stats_{when}"], f).numpy(),
                                       np.asarray(getattr(host[f"stats_{when}"], f)), rtol=1e-6,
                                       err_msg=f)
    t_time, j_time = t_hist[-1], j_hist[-1]
    assert t_time["fused_cycle"] and j_time["fused_cycle"]
    assert t_time["scatter_width"] == j_time["scatter_width"]
    assert t_time["blocking_syncs"] == 1


# --------------------------------------------------------- the streaming replay


#: the replay's windows after the reflatten: (every, factor, sentinels,
#: offset); every=0 is an empty window
WINDOWS = ((7, 1.1, 0, 0), (0, 1.0, 0, 0), (1, 1.03, 0, 0), (3, 0.9, 5, 1))
#: the replay's clusters: tests/test_controller.py's (SMALL, seed 9) and
#: the JBOD fixture
CLUSTERS = {"random": lambda: jf.random_cluster_fast(SMALL, seed=9), "jbod": jf.jbod_cluster}


@pytest.fixture(scope="module", params=sorted(CLUSTERS))
def replay(request):
    """A reflatten, then the four windows: the port's fused cycles, its
    staged path, and the JAX package's cycles, with the learned prior
    refreshed each window from the fused path's proposals."""
    make = CLUSTERS[request.param]
    cfg = dict(CFG, prior_enabled=True)
    js = make()
    shape = js.shape
    catalog = _catalog(shape)
    prior = MoveAcceptancePrior(mix=0.5, min_observations=0)
    t_cfg = TConfig(**cfg)
    fused, staged = TOptimizer(config=t_cfg, device="cpu"), TOptimizer(config=t_cfg, device="cpu")
    jopt = JOptimizer(config=JConfig(**cfg))
    f_live, s_live = LiveState(_port(js)), LiveState(_port(js))
    fresh = make()
    j_live = JLiveState(dataclasses.replace(
        fresh, replica_load_leader=jnp.array(np.asarray(fresh.replica_load_leader)),
        replica_load_follower=jnp.array(np.asarray(fresh.replica_load_follower))))
    table = prior.table(catalog, shape)
    f_res = fused.optimize(f_live.state, prior=table)
    s_res = staged.optimize(s_live.state, prior=table)
    j_res = jopt.optimize(j_live.state, prior=table)
    before_host = fetch_before_host(f_live.state)
    out = []
    for every, factor, sentinels, offset in WINDOWS:
        prior.observe_proposals(f_res.proposals, catalog)
        table = prior.table(catalog, shape)
        if every:
            rows, ll, fl = _window(f_live.state, every, factor, sentinels, offset)
        else:
            rows, ll, fl = (np.zeros(0, np.int32), np.zeros((0, 4), np.float32),
                            np.zeros((0, 4), np.float32))
        warm = tuple(getattr(f_res.state_after, f) for f in PLACEMENT)
        with dispatch_meter() as m:
            f_out = fused.optimize_streaming_cycle(
                f_live.state, rows=rows, leader_loads=ll, follower_loads=fl,
                initial_placement=warm, prior=table, before_host=before_host)
        f_res, (new_ll, new_fl) = f_out
        f_live.adopt_loads(new_ll, new_fl)
        s_live.set_partition_loads(rows, ll, fl)
        s_warm = tuple(getattr(s_res.state_after, f) for f in PLACEMENT)
        s_res = staged.optimize(s_live.state, initial_placement=s_warm, prior=table)
        j_warm = tuple(np.asarray(getattr(j_res.state_after, f)) for f in PLACEMENT)
        j_res, (j_ll, j_fl) = jopt.optimize_streaming_cycle(
            j_live.state, rows=rows, leader_loads=ll, follower_loads=fl,
            initial_placement=j_warm, prior=table)
        j_live.adopt_loads(j_ll, j_fl)
        out.append(dict(cluster=request.param, fused=f_res, staged=s_res, jax=j_res,
                        counts=dict(m.counts), f_loads=[t.clone() for t in (new_ll, new_fl)],
                        s_loads=[s_live.state.replica_load_leader.clone(),
                                 s_live.state.replica_load_follower.clone()],
                        j_loads=[np.asarray(j_ll), np.asarray(j_fl)], mix=table.mix))
    return out


def _proposal_columns(res) -> dict:
    return {k: np.asarray(v) for k, v in res.proposals._c.items()}


@pytest.mark.parametrize("window", range(len(WINDOWS)))
def test_replay_fused_equals_staged(replay, window):
    """The port's fused cycle publishes the staged path's placements,
    proposals, reports and live loads, byte for byte."""
    w = replay[window]
    f, s = w["fused"], w["staged"]
    for a, b in zip(w["f_loads"], w["s_loads"]):
        assert torch.equal(a, b)
    for fld in (*PLACEMENT, "replica_offline"):
        assert torch.equal(getattr(f.state_after, fld), getattr(s.state_after, fld)), fld
    fc, sc = _proposal_columns(f), _proposal_columns(s)
    assert fc.keys() == sc.keys()
    for k in fc:
        np.testing.assert_array_equal(fc[k], sc[k], err_msg=k)
    assert f.objective_before == s.objective_before and f.objective_after == s.objective_after
    np.testing.assert_array_equal(f.violations_before, s.violations_before)
    np.testing.assert_array_equal(f.violations_after, s.violations_after)
    for fld in STATS:
        assert torch.equal(getattr(f.stats_after, fld), getattr(s.stats_after, fld)), fld
    assert [h for h in f.history if "round" in h] == [h for h in s.history if "round" in h]


@pytest.mark.parametrize("window", range(len(WINDOWS)))
def test_replay_matches_jax_cycles(replay, window):
    """Against the JAX package's optimize_streaming_cycle chain on the same
    windows: every fused cycle counts exactly its two dispatches and makes
    one blocking sync; the live loads are the JAX package's exactly and the
    before-reports within f32 summation order (objective and violations
    rtol 1e-5, stats rtol 1e-6).  On the JBOD fixture the whole chain is the
    JAX package's: placements, round records and proposals.  On the random
    cluster the JAX package's compiled anneal parts from its own op-by-op
    evaluation in window 0 (XLA:CPU contracts multiply-adds, ROADMAP queue
    3; the port follows the op-by-op evaluation), so there the anneal's
    outcome is held to the JAX package's only in that both lower the
    objective in every window."""
    w = replay[window]
    f, j = w["fused"], w["jax"]
    assert w["counts"] == {"engine.cycle": 1, "engine.extract": 1}
    timing = next(h for h in f.history if h.get("timing"))
    assert timing["fused_cycle"] and timing["blocking_syncs"] == 1
    assert w["mix"] == 0.5  # the prior is warm from the first window on
    for a, b in zip(w["f_loads"], w["j_loads"]):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(f.objective_before, j.objective_before, rtol=1e-5)
    np.testing.assert_allclose(f.violations_before, j.violations_before, rtol=1e-5, atol=1e-7)
    for fld in STATS:
        np.testing.assert_allclose(getattr(f.stats_before, fld).numpy(),
                                   np.asarray(getattr(j.stats_before, fld)), rtol=1e-6, err_msg=fld)
    if w["cluster"] == "jbod":
        for fld in PLACEMENT:
            np.testing.assert_array_equal(getattr(f.state_after, fld).numpy(),
                                          np.asarray(getattr(j.state_after, fld)), err_msg=fld)
        assert len(f.proposals) == len(j.proposals)
        _same_rounds(f.history, j.history)
        np.testing.assert_allclose(f.objective_after, j.objective_after, rtol=1e-5)
    else:
        assert f.objective_after < f.objective_before and j.objective_after < j.objective_before


# -------------------------------------------------------------- engine cache


def test_cycle_needs_a_cached_engine():
    """optimize_streaming_cycle returns None with no engine cached for
    (shape, config), and has_engine_for says the same; after optimize both
    say there is one."""
    ts = _port(jf.small_cluster())
    cfg = TConfig(**CFG)
    opt = TOptimizer(config=cfg, device="cpu")
    rows, ll, fl = _window(ts, 2, 1.5)
    warm = tuple(getattr(ts, f) for f in PLACEMENT)

    def cycle(config=None):
        return opt.optimize_streaming_cycle(ts, rows=rows, leader_loads=ll, follower_loads=fl,
                                            initial_placement=warm, config=config)

    assert not opt.has_engine_for(ts.shape) and cycle() is None
    opt.optimize(ts)
    assert opt.has_engine_for(ts.shape) and opt.has_engine_for(ts.shape, config=cfg)
    other = dataclasses.replace(cfg, seed=5)
    assert not opt.has_engine_for(ts.shape, config=other) and cycle(other) is None
    res, _ = cycle()
    assert next(h for h in res.history if h.get("timing"))["fused_cycle"]


def test_loads_only_rebind_keeps_workspace_and_callers_tensors(monkeypatch):
    """A new generation that differs only in its loads keeps the workspace
    (on the card, the captured graphs) and builds its statics once; the
    engine's load tables are its own, so the earlier caller's state and
    result keep their tensors and values, and no returned state holds the
    engine's tables."""
    ts = _port(jf.random_cluster_fast(SMALL, seed=9))
    opt = TOptimizer(config=TConfig(**CFG), device="cpu")
    first = opt.optimize(ts)
    (engine,) = opt._engines.values()
    ws = engine._ws
    saved = {f: getattr(ts, f).clone() for f in ("replica_load_leader", "replica_load_follower")}
    calls = []
    real = engine_mod.build_statics
    monkeypatch.setattr(engine_mod, "build_statics", lambda *a, **k: calls.append(1) or real(*a, **k))
    live = LiveState(dataclasses.replace(
        ts, replica_load_leader=ts.replica_load_leader.clone(),
        replica_load_follower=ts.replica_load_follower.clone()))
    rows, ll, fl = _window(ts, 2, 3.0)
    live.set_partition_loads(rows, ll, fl)
    second = opt.optimize(live.state)
    assert len(calls) == 1 and engine._ws is ws
    for f, t in saved.items():
        assert torch.equal(getattr(ts, f), t)
        assert getattr(first.state_before, f) is getattr(ts, f)
        assert getattr(first.state_after, f) is getattr(ts, f)
        assert getattr(second.state_after, f) is getattr(live.state, f)
    own = {t.data_ptr() for t in engine._loads}
    for res in (first, second):
        for st in (res.state_before, res.state_after):
            assert not own & {st.replica_load_leader.data_ptr(), st.replica_load_follower.data_ptr()}
    # the second run saw the new loads: it is a fresh optimizer's run on them
    again = TOptimizer(config=TConfig(**CFG), device="cpu").optimize(live.state)
    assert second.objective_before == again.objective_before
    for f in PLACEMENT:
        assert torch.equal(getattr(second.state_after, f), getattr(again.state_after, f))
    # a cycle writes the live tensors it is given, not the earlier states'
    res, (n_ll, _) = opt.optimize_streaming_cycle(
        live.state, rows=rows, leader_loads=ll * 2, follower_loads=fl * 2,
        initial_placement=tuple(getattr(second.state_after, f) for f in PLACEMENT))
    assert n_ll is live.state.replica_load_leader
    for f, t in saved.items():
        assert torch.equal(getattr(ts, f), t)
    assert not own & {res.state_after.replica_load_leader.data_ptr()}
