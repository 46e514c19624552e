"""The port's streaming controller against the JAX package's, on the CPU.

Both controllers are built by their own package's `build_simulated_service`
with one seed and one set of props (the JAX package's tests/test_controller.py
`_controller_service`, plus a plan-sizing ladder and one metric window), and
fed the same replay: both samplers lose their jitter after the build, so a
window without drift repeats its predecessor, and with one window kept the
replay holds

  w4  the initial reflatten (full width K = 256);
  w5  every partition changed (the window before drifted by 1.05);
  w6  every partition changed again;
  w7  an empty window (nothing changed; plan-sized to K/2, a new width,
      so it goes staged and builds that width's engine);
  w8  topic T0's 12 partitions changed (x1.2; plan-sized to K/2, fused);
  w9  an empty window again (fused).

Held exactly, window by window: the cycle's integer and boolean outputs
(`reflattened`, `reflatten_reason`, `delta_partitions`, `fused`,
`published`, `rounds`, `warm_start`, `prior_observed`), every counter of
`_stats`, `_delta_rows`' triple, the live load tensors, and the published
placements and proposals.  The JAX package's compiled anneal agrees with
its op-by-op evaluation on this replay, so the placements are held byte for
byte (where it does not, ROADMAP queue 3's recorded CPU bar applies, as in
tests/test_torch_streaming.py).  The objectives are left out: an objective
near zero sums terms that cancel, and XLA contracts their multiply-adds.
Also exact: `_plan_config` over a sweep of widths and delta sizes, and in
cold mode (warm starts off, delta off, prior mix 0) the last window's
placement, which is byte for byte a direct optimize of a freshly built
model and the JAX controller's.
"""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.config.app_config import CruiseControlConfig as JConfig
from cruise_control_tpu.service.main import build_simulated_service as j_build
from cruise_control_tpu_torch.config import CruiseControlConfig as TConfig
from cruise_control_tpu_torch.service.main import build_simulated_service as t_build

PROPS = {
    "partition.metrics.window.ms": 1000,
    "min.samples.per.partition.metrics.window": 1,
    "num.partition.metrics.windows": 1,
    "execution.progress.check.interval.ms": 100,
    "webserver.http.port": 0,
    "tpu.num.candidates": 256,
    "tpu.leadership.candidates": 32,
    "tpu.steps.per.round": 16,
    "tpu.num.rounds": 2,
    "controller.enabled": True,
    "controller.prior.min.observations": 8,
    "controller.plan.min.candidates": 128,
    "controller.plan.candidates.per.partition": 8,
}
#: (window, drift applied before the window's fetch, topic or None)
REPLAY = ((4, None, None), (5, 1.05, None), (6, None, None), (7, 1.2, "T0"),
          (8, None, None), (9, None, None))
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
INFO_KEYS = ("reflattened", "reflatten_reason", "delta_partitions", "fused", "published", "rounds",
             "warm_start", "prior_observed")
#: `_stats` keys that are not counters: the last cycle's objective, walls
#: and wall-clock stamps
NOT_COUNTERS = ("lastObjective", "lastWallSeconds", "lastPublishMs", "coldCycleSeconds",
                "fusedColdCycleSeconds")
#: a staged cycle's dispatches in the port: its optimize is one reported
#: run (the reports and checks ride the run and its one sync), where the
#: JAX package's staged optimize also dispatches its reports, validation
#: and extraction apart; a fused cycle's two are the same in both
STAGED_DISPATCHES = {"engine.init": 1, "engine.run": 1, "engine.sync": 1}


def _services(props):
    j = j_build(JConfig(props), seed=5)
    t = t_build(TConfig(props), seed=5, device="cpu")
    for sampler in (j[3], t[3]):
        sampler.spec = dataclasses.replace(sampler.spec, jitter=0.0)
    return j, t


def _spy_delta_rows(ctl, out: list):
    orig = ctl._delta_rows

    def spy(delta):
        r = orig(delta)
        out.append(r)
        return r

    ctl._delta_rows = spy


def _proposal_columns(result) -> list:
    return [p.to_json() for p in result.proposals]


def _roll(services, window, drift, topic):
    for _app, fetcher, _admin, sampler in services:
        if drift is not None:
            sampler.drift(drift, topic=topic)
        fetcher.fetch_once(sampler.all_partition_entities(), window * 1000, (window + 1) * 1000 - 1)


@pytest.fixture(scope="module")
def replay():
    j, t = _services(PROPS)
    jc, tc = j[0].cc.controller, t[0].cc.controller
    rows = {"jax": [], "port": []}
    _spy_delta_rows(jc, rows["jax"])
    _spy_delta_rows(tc, rows["port"])
    windows = []
    try:
        for w, drift, topic in REPLAY:
            _roll((j, t), w, drift, topic)
            n_j, n_p = len(rows["jax"]), len(rows["port"])
            ji, ti = jc.run_once(), tc.run_once()
            windows.append(dict(
                jax=ji, port=ti, jax_stats=jc.state_json(), port_stats=tc.state_json(),
                jax_rows=rows["jax"][n_j:], port_rows=rows["port"][n_p:],
                jax_loads=[np.asarray(jc._live.state.replica_load_leader).copy(),
                           np.asarray(jc._live.state.replica_load_follower).copy()],
                port_loads=[tc._live.state.replica_load_leader.numpy().copy(),
                            tc._live.state.replica_load_follower.numpy().copy()],
                jax_proposals=_proposal_columns(ji["result"]),
                port_proposals=_proposal_columns(ti["result"]),
                jax_placement=[np.asarray(getattr(ji["result"].state_after, f)) for f in PLACEMENT],
                port_placement=[getattr(ti["result"].state_after, f).numpy() for f in PLACEMENT],
                controllers=(jc, tc)))
        yield windows
    finally:
        j[0].stop()
        t[0].stop()


def test_replay_is_the_intended_one(replay):
    """The replay exercises what it claims: one reflatten, full, empty and
    small windows, a staged cycle at a new plan width, and fused cycles."""
    infos = [w["port"] for w in replay]
    assert [i["reflattened"] for i in infos] == [True] + [False] * 5
    assert [i["delta_partitions"] for i in infos] == [0, 24, 24, 0, 12, 0]
    assert [i["fused"] for i in infos] == [False, True, True, False, True, True]
    stats = replay[-1]["port_stats"]
    assert stats["planSizedCycles"] == 3 and stats["fusedCycles"] == 4
    assert stats["fullReflattensByReason"] == {"initial": 1}


@pytest.mark.parametrize("window", range(len(REPLAY)))
def test_cycle_outputs_and_counters_match_jax(replay, window):
    w = replay[window]
    for k in INFO_KEYS:
        assert w["port"].get(k) == w["jax"].get(k), k
    js, ts = w["jax_stats"], w["port_stats"]
    if w["port"]["fused"]:
        assert w["port"]["dispatches"] == w["jax"]["dispatches"] == {"engine.cycle": 1, "engine.extract": 1}
        assert ts["lastCycleDispatches"] == js["lastCycleDispatches"] == 2
    else:
        assert w["port"]["dispatches"] == STAGED_DISPATCHES
        assert ts["lastCycleDispatches"] == 3
    assert js.keys() == ts.keys()
    for k in js:
        if k not in NOT_COUNTERS and k != "lastCycleDispatches":
            assert ts[k] == js[k], k
    for k in NOT_COUNTERS:
        assert (ts[k] is None) == (js[k] is None), k


@pytest.mark.parametrize("window", range(len(REPLAY)))
def test_delta_rows_and_live_loads_match_jax(replay, window):
    w = replay[window]
    assert len(w["port_rows"]) == len(w["jax_rows"])
    for tr, jr in zip(w["port_rows"], w["jax_rows"]):
        assert tr[3] == jr[3]
        for a, b in zip(tr[:3], jr[:3]):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for a, b in zip(w["port_loads"], w["jax_loads"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window", range(len(REPLAY)))
def test_published_placements_and_proposals_match_jax(replay, window):
    w = replay[window]
    for a, b in zip(w["port_placement"], w["jax_placement"]):
        np.testing.assert_array_equal(a, b)
    assert w["port_proposals"] == w["jax_proposals"]


@pytest.mark.parametrize("K", [64, 128, 256, 512, 1024, 4096])
def test_plan_config_matches_jax(replay, K):
    jc, tc = replay[0]["controllers"]
    for delta in (0, 1, 4, 8, 15, 16, 17, 31, 32, 64, 100, 128, 256, 600):
        jcfg = dataclasses.replace(jc._opt_config, num_candidates=K, swap_candidates=K // 8)
        tcfg = dataclasses.replace(tc._opt_config, num_candidates=K, swap_candidates=K // 8)
        js, ts = jc._plan_config(jcfg, delta), tc._plan_config(tcfg, delta)
        assert (js is jcfg) == (ts is tcfg), (K, delta)
        for f in ("num_candidates", "leadership_candidates", "swap_candidates"):
            assert getattr(ts, f) == getattr(js, f), (K, delta, f)


def test_cold_mode_matches_direct_optimize_and_jax():
    """Warm starts off, delta off, prior mix 0: every window reflattens, and
    the last one's placement is byte for byte a direct optimize of a
    freshly built model (the JAX package's cold-parity gate) and the JAX
    controller's."""
    props = dict(PROPS, **{"controller.warm.start.enabled": False, "controller.delta.enabled": False,
                           "controller.prior.mix": 0.0, "num.partition.metrics.windows": 3})
    j, t = _services(props)
    try:
        infos = {}
        for w, drift, topic in ((4, 1.05, None), (5, 1.05, None), (6, 1.05, None)):
            _roll((j, t), w, drift, topic)
            infos = {"jax": j[0].cc.controller.run_once(), "port": t[0].cc.controller.run_once()}
        cc = t[0].cc
        stats = cc.controller.state_json()
        assert stats["fullReflattens"] == 3
        assert stats["fullReflattensByReason"] == {"initial": 1, "delta-disabled": 2}
        fresh = cc.monitor.cluster_model()
        direct = cc.optimizer.optimize(fresh, options=cc._build_options(fresh))
        for f in PLACEMENT:
            got = getattr(infos["port"]["result"].state_after, f).numpy()
            np.testing.assert_array_equal(got, getattr(direct.state_after, f).numpy())
            np.testing.assert_array_equal(got, np.asarray(getattr(infos["jax"]["result"].state_after, f)))
    finally:
        j[0].stop()
        t[0].stop()
