"""The port's decision ledger (cruise_control_tpu_torch.analyzer.ledger) and
the convergence diagnostics it records, on the CPU: tests/test_ledger.py's 6
tests that build no service and no mesh, pointed at the port (the engines
on the CPU).  Left out: test_diagnostics_byte_parity_mesh (the mesh, item
10).  The five that build the service or the fleet are at the end, over
the port's simulated service, the streaming controller's
test_controller_first_publish_excluded_from_calibration among them.  The port
adds test_card_result_record_costs_one_transfer: a decision record built
from a result on the card costs one device-to-host transfer, and its JSON
is the CPU copy's but for wallSeconds (marked cuda; it skips without a
card).  The reference's notes follow.

Decision ledger + convergence diagnostics tests: torn-tail
durability, rotation/retention honoring pending outcomes, fleet
two-cluster namespace isolation, the disabled path writing zero bytes,
diagnostics byte-parity across plain/segmented/mesh runs, MODEL_DRIFT
episode discipline, and the decision→outcome→calibration→/explain
acceptance story on the simulated cluster."""

import dataclasses as dc
import json
import os

import numpy as np
import pytest

from cruise_control_tpu_torch.analyzer.engine import (
    Engine,
    FUSED_DIAG_YS_KEYS,
    FUSED_YS_KEYS,
    OptimizerConfig,
    SegmentContext,
    segmented_execution,
)
from cruise_control_tpu_torch.analyzer.ledger import DecisionLedger
from cruise_control_tpu_torch.analyzer.objective import DEFAULT_CHAIN
from cruise_control_tpu_torch.testing.fixtures import (
    RandomClusterSpec,
    random_cluster_fast,
)
import urllib.error
import urllib.request
from cruise_control_tpu_torch.config.app_config import CruiseControlConfig

SMALL = RandomClusterSpec(
    num_brokers=12, num_partitions=200, num_racks=4, num_topics=6, skew=1.0
)
CFG = OptimizerConfig(
    num_candidates=128, leadership_candidates=32, swap_candidates=16,
    steps_per_round=8, num_rounds=3, seed=0,
)


def _placements(state):
    return tuple(
        np.asarray(getattr(state, f))
        for f in ("replica_broker", "replica_is_leader", "replica_disk")
    )


def _same_placement(a, b) -> bool:
    return all(bool((x == y).all()) for x, y in zip(_placements(a), _placements(b)))


# ------------------------------------------------------------- store


def test_torn_tail_append_after_truncate(tmp_path):
    """A crash-torn final line must neither poison replay nor glue onto
    the next append: reopening truncates back to the last valid record,
    and the episode written after the tear joins cleanly."""
    path = tmp_path / "decision-ledger.jsonl"
    led = DecisionLedger(str(path))
    did = led.record_decision({"source": "test", "goals": {}})
    led.close()
    with open(path, "ab") as f:
        f.write(b'{"t": "outco')  # torn mid-record
    # replay of the torn file trusts only the complete prefix
    led2 = DecisionLedger(str(path))
    assert [r["t"] for r in led2.replay()] == ["decision"]
    # appending repairs the tear first: the outcome joins its decision
    led2.record_outcome(did, {"completed": 3})
    entries = led2.entries()
    assert len(entries) == 1
    assert entries[0]["decision"]["id"] == did
    assert entries[0]["outcome"]["completed"] == 3
    # the file holds exactly two valid lines — no half-line remains
    lines = path.read_bytes().splitlines()
    assert len(lines) == 2
    for line in lines:
        json.loads(line)


def test_rotation_and_retention_respect_pending_outcomes(tmp_path):
    """The live file never rotates while a decision in it awaits its
    outcome, and prune_archives never deletes an archive holding a
    pending episode."""
    path = tmp_path / "decision-ledger.jsonl"
    led = DecisionLedger(str(path), rotate_records=2, retention_count=1)
    d1 = led.record_decision({"source": "test"})
    led.begin_outcome(d1)
    led.record_decision({"source": "test"})
    # live file is at the rotation bound but d1's outcome is pending:
    # the next decision must NOT rotate it away
    d3 = led.record_decision({"source": "test"})
    assert led._archives() == []
    assert {e["decision"]["id"] for e in led.entries()} >= {d1, d3}
    # outcome lands -> the following decision rotates the full file
    led.record_outcome(d1, {"completed": 1})
    led.record_decision({"source": "test"})
    assert len(led._archives()) == 1
    # retention: a pending episode inside an archive is sacrosanct
    d5 = led.record_decision({"source": "test"})
    led.begin_outcome(d5)
    led.record_decision({"source": "test"})
    led.record_decision({"source": "test"})  # would rotate, but d5 pending
    # force the bookkeeping: rotate only once d5 resolves
    led.record_outcome(d5, {"completed": 1})
    led.record_decision({"source": "test"})
    archives = led._archives()
    assert len(archives) >= 1
    # prune with an artificially pending id living in the oldest archive
    oldest = archives[-1][1]
    ids_in_oldest = {
        r["id"] for r in DecisionLedger._replay_file(oldest)
        if r.get("t") == "decision"
    }
    led.begin_outcome(next(iter(ids_in_oldest)))
    assert led.prune_archives() == 0 or os.path.exists(oldest)
    assert os.path.exists(oldest)
    # resolving it makes the archive prunable again
    for i in ids_in_oldest:
        led.record_outcome(i, {"completed": 0})
    led.prune_archives()
    assert len(led._archives()) <= led.retention_count


def test_entries_join_newest_first(tmp_path):
    led = DecisionLedger(str(tmp_path / "l.jsonl"))
    a = led.record_decision({"source": "a"})
    b = led.record_decision({"source": "b"})
    led.record_outcome(b, {"completed": 2})
    led.record_calibration(b, {"error": {"goalMaxAbs": 0.1}})
    entries = led.entries(limit=10)
    assert [e["decision"]["id"] for e in entries] == [b, a]
    assert entries[0]["calibration"]["error"]["goalMaxAbs"] == 0.1
    assert entries[1]["outcome"] is None
    assert led.find(decision_id=a)["decision"]["source"] == "a"
    assert led.find(decision_id="nope") is None


# ------------------------------------------- convergence diagnostics


def test_diagnostics_byte_parity_plain_and_history_schema():
    state = random_cluster_fast(SMALL, seed=3, device="cpu")
    off, hist_off = Engine(state, DEFAULT_CHAIN, config=CFG).run()
    on, hist_on = Engine(
        state, DEFAULT_CHAIN, config=dc.replace(CFG, diagnostics=True)
    ).run()
    assert _same_placement(off, on)
    rounds_off = [h for h in hist_off if not h.get("timing")]
    rounds_on = [h for h in hist_on if not h.get("timing")]
    assert len(rounds_off) == len(rounds_on)
    # the off path reports today's records bit-for-bit (no diag fields)
    for rec in rounds_off:
        assert "goal_violations" not in rec and "objective" not in rec
    assert "convergence" not in next(h for h in hist_off if h.get("timing"))
    # the on path carries the full per-round diagnostics
    n_goals = len(DEFAULT_CHAIN.goals)
    for rec in rounds_on:
        assert len(rec["goal_violations"]) == n_goals
        assert set(rec["accepted_by_kind"]) == {"replica", "swap", "leadership"}
        assert rec["accepted"] == sum(rec["accepted_by_kind"].values())
        assert rec["prior"] == {"candidates": 0, "accepted": 0}  # prior off
    conv = next(h for h in hist_on if h.get("timing"))["convergence"]
    assert conv["rounds"] == len(rounds_on)
    assert len(conv["objective_trajectory"]) == conv["rounds"]
    assert conv["goal_names"] == DEFAULT_CHAIN.names()
    assert len(conv["final_goal_violations"]) == n_goals
    # the trajectory is a real anneal: monotone-ish improvement start->end
    assert conv["objective_trajectory"][-1] <= conv["objective_trajectory"][0]


def test_diagnostics_byte_parity_segmented():
    state = random_cluster_fast(SMALL, seed=5, device="cpu")
    base, _ = Engine(
        state, DEFAULT_CHAIN, config=dc.replace(CFG, diagnostics=True)
    ).run()
    eng = Engine(state, DEFAULT_CHAIN, config=dc.replace(CFG, diagnostics=True))
    with segmented_execution(SegmentContext(slice_budget_s=1e-4)):
        seg, hist = eng.run()
    assert _same_placement(base, seg)
    timing = next(h for h in hist if h.get("timing"))
    assert timing["segmented"] and timing["segments"] >= 2
    conv = timing["convergence"]
    assert conv["rounds"] >= 1 and conv["goal_names"] == DEFAULT_CHAIN.names()


def test_diag_ys_key_constants_are_consistent():
    assert set(FUSED_YS_KEYS) < set(FUSED_DIAG_YS_KEYS)
    eng_off = Engine(
        random_cluster_fast(SMALL, seed=3, device="cpu"), DEFAULT_CHAIN, config=CFG
    )
    eng_on = Engine(
        random_cluster_fast(SMALL, seed=3, device="cpu"), DEFAULT_CHAIN,
        config=dc.replace(CFG, diagnostics=True),
    )
    assert eng_off._ys_keys() == FUSED_YS_KEYS
    assert eng_on._ys_keys() == FUSED_DIAG_YS_KEYS


# ------------------------------------------------- a result on the card


def _on_cpu(res):
    """The result with every tensor the decision record reads moved to the
    CPU (the state before, the stats after)."""
    from cruise_control_tpu_torch.models.state import STATE_FIELDS
    from cruise_control_tpu_torch.models.stats import ClusterStats

    st = res.state_before
    stats = res.stats_after
    return dc.replace(
        res, state_before=dc.replace(st, **{f: getattr(st, f).cpu() for f in STATE_FIELDS}),
        stats_after=ClusterStats(**{f.name: getattr(stats, f.name).cpu() for f in dc.fields(stats)}))


@pytest.mark.cuda
def test_card_result_record_costs_one_transfer():
    import torch

    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer import ledger as ledger_mod
    from cruise_control_tpu_torch.models.stats import compute_stats

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a result on the card")
    state = random_cluster_fast(SMALL, seed=3, device="cuda")
    res = GoalOptimizer(config=CFG, device="cuda").optimize(state)
    res = dc.replace(res, stats_after=compute_stats(res.state_after))
    assert res.state_before.broker_rack.is_cuda and res.stats_after.avg.is_cuda
    before = ledger_mod.TRANSFERS
    card = ledger_mod.build_decision_record(res, source="card")
    assert ledger_mod.TRANSFERS == before + 1
    host = ledger_mod.build_decision_record(_on_cpu(res), source="card")
    assert ledger_mod.TRANSFERS == before + 1
    card.pop("wallSeconds"), host.pop("wallSeconds")
    assert json.dumps(card) == json.dumps(host)


# ------------------------- the service and the fleet (tests/test_ledger.py :223-430)


def _ledger_service(tmp_path, extra=None, seed=11):
    from cruise_control_tpu_torch.service.main import build_simulated_service

    props = {
        "partition.metrics.window.ms": 1000,
        "min.samples.per.partition.metrics.window": 1,
        "num.partition.metrics.windows": 3,
        "execution.progress.check.interval.ms": 100,
        "webserver.http.port": 0,
        "tpu.num.candidates": 128,
        "tpu.leadership.candidates": 32,
        "tpu.steps.per.round": 16,
        "tpu.num.rounds": 2,
        "executor.journal.dir": str(tmp_path / "journal"),
        "tpu.prewarm.enabled": "false",
    }
    props.update(extra or {})
    return build_simulated_service(CruiseControlConfig(props), seed=seed, device="cpu")


def test_decision_outcome_calibration_explain_acceptance(tmp_path):
    """The acceptance story: one rebalance executed on the simulated
    cluster yields a ledger with linked decision → outcome → calibration
    records, and GET /explain replays it."""
    from cruise_control_tpu_torch.service.progress import OperationProgress

    app, fetcher, admin, sampler = _ledger_service(tmp_path)
    cc = app.cc
    assert cc.ledger is not None  # derived from executor.journal.dir
    result = cc.proposals(OperationProgress(), ignore_cache=True)
    did = cc._ledger_decision_id(result)
    assert did is not None
    out = cc.rebalance(OperationProgress(), dryrun=False)
    assert out["execution"]["completed"] > 0
    entry = cc.ledger.find(decision_id=did)
    assert entry["outcome"] is not None
    assert entry["outcome"]["completed"] == out["execution"]["completed"]
    assert entry["outcome"]["fencedAbort"] is False
    assert entry["calibration"] is None  # no window rolled yet
    # decision features: goals, predicted load, moves, convergence
    d = entry["decision"]
    assert d["goals"]["names"] == cc.chain.names()
    assert d["convergence"]["rounds"] >= 1  # diagnostics default-on
    assert d["predictedLoad"]["avg"]
    assert d["moves"] and "destinations" in d["moves"][0]
    # roll the next complete metric window -> calibration joins
    parts = sampler.all_partition_entities()
    fetcher.fetch_once(parts, 5000, 5999)
    assert cc._detect_model_drift() is None  # healthy: no drift anomaly
    entry = cc.ledger.find(decision_id=did)
    assert entry["calibration"] is not None
    err = entry["calibration"]["error"]
    assert err["goalMaxAbs"] >= 0.0 and "load" in err
    assert cc.calibration_state()["samples"] == 1
    # /explain replays the episode (facade + HTTP)
    ex = cc.explain(decision_id=did)
    assert ex["decisionId"] == did
    assert ex["outcome"]["completed"] == out["execution"]["completed"]
    assert ex["calibration"] is not None
    assert len(ex["goalDeltas"]) == len(cc.chain.names())
    with pytest.raises(KeyError):
        cc.explain(decision_id="nope")
    with pytest.raises(ValueError):
        cc.explain()
    app.start()
    try:
        base = f"http://{app.host}:{app.port}{app.prefix}"
        with urllib.request.urlopen(
            base + f"/explain?proposal={did}", timeout=30
        ) as resp:
            payload = json.loads(resp.read())
        assert payload["decisionId"] == did
        from cruise_control_tpu_torch.service.schemas import validate_response

        assert validate_response("explain", payload) == []
        with urllib.request.urlopen(base + "/ledger?limit=5", timeout=30) as resp:
            led = json.loads(resp.read())
        assert led["enabled"] and led["entries"]
        assert validate_response("ledger", led) == []
        # unknown episode -> 404; bare /explain -> 400
        with pytest.raises(urllib.error.HTTPError) as e404:
            urllib.request.urlopen(base + "/explain?proposal=nope", timeout=30)
        assert e404.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e400:
            urllib.request.urlopen(base + "/explain", timeout=30)
        assert e400.value.code == 400
    finally:
        app.stop()


def test_disabled_path_writes_zero_bytes(tmp_path):
    """analyzer.ledger.enabled=false: no ledger object, no _ledger
    directory, zero bytes — even across a real execution."""
    from cruise_control_tpu_torch.service.progress import OperationProgress

    app, fetcher, admin, sampler = _ledger_service(
        tmp_path, extra={"analyzer.ledger.enabled": "false"}
    )
    cc = app.cc
    assert cc.ledger is None
    cc.rebalance(OperationProgress(), dryrun=False)
    assert not (tmp_path / "journal" / "_ledger").exists()
    assert cc.ledger_entries() == []
    st = cc.state(["analyzer"])
    assert "ledger" not in st["AnalyzerState"]


def test_model_drift_fires_once_per_episode(tmp_path):
    """Sustained prediction error opens ONE MODEL_DRIFT episode; the
    episode re-arms only after the mean error recovers."""
    app, fetcher, admin, sampler = _ledger_service(
        tmp_path,
        extra={
            "analyzer.calibration.drift.threshold": "0.1",
            "analyzer.calibration.drift.min.samples": "2",
        },
    )
    cc = app.cc

    def feed(goal_err, n=2):
        for _ in range(n):
            cc._calibration_errors.append((goal_err, 0.0))

    feed(0.5)
    anom = cc._detect_model_drift()
    assert anom is not None and anom.episode == 1
    assert anom.mean_goal_error > 0.1 and not anom.fixable
    # still burning: the same episode stays silent
    feed(0.6)
    assert cc._detect_model_drift() is None
    assert cc.calibration_state()["driftActive"]
    # recovery re-arms...
    feed(0.0)
    assert cc._detect_model_drift() is None
    assert not cc.calibration_state()["driftActive"]
    # ...and a new burn opens episode 2
    feed(0.7)
    anom2 = cc._detect_model_drift()
    assert anom2 is not None and anom2.episode == 2


def test_fleet_two_cluster_ledger_isolation(tmp_path):
    """Each fleet cluster owns a namespaced ledger under the journal
    dir: east's decisions never appear in west's ledger (and vice
    versa), and the /fleet rollup carries per-cluster ledger blocks."""
    from cruise_control_tpu_torch.service.main import build_simulated_fleet
    from cruise_control_tpu_torch.service.progress import OperationProgress

    app, fleet = build_simulated_fleet(
        props={
            "fleet.clusters": "east,west",
            "executor.journal.dir": str(tmp_path / "journal"),
            "tpu.prewarm.enabled": "false",
        },
        clusters={
            "east": dict(num_brokers=6, topics={"T0": 12, "T1": 12}),
            "west": dict(num_brokers=6, topics={"T0": 12, "T1": 12}),
        }, device="cpu",
    )
    east = fleet.facade("east")
    west = fleet.facade("west")
    assert east.ledger is not None and west.ledger is not None
    assert east.ledger.path != west.ledger.path
    assert os.path.join("_ledger", "east") in east.ledger.path
    r_e = east.proposals(OperationProgress(), ignore_cache=True)
    did_e = east._ledger_decision_id(r_e)
    r_w = west.proposals(OperationProgress(), ignore_cache=True)
    did_w = west._ledger_decision_id(r_w)
    assert did_e and did_w and did_e != did_w
    assert east.ledger.find(decision_id=did_e) is not None
    assert east.ledger.find(decision_id=did_w) is None
    assert west.ledger.find(decision_id=did_w) is not None
    assert west.ledger.find(decision_id=did_e) is None
    # decision records carry their cluster id
    assert east.ledger.find(decision_id=did_e)["decision"]["cluster"] == "east"
    rollup = fleet.fleet_state()
    for cid in ("east", "west"):
        assert rollup["clusters"][cid]["ledger"]["recordsWritten"] >= 1
        assert "calibration" in rollup["clusters"][cid]


def test_controller_first_publish_excluded_from_calibration(tmp_path):
    """(tests/test_ledger.py:364) The controller's first (cold-capture)
    publish is calibration-ineligible — a restart can never fire a
    spurious MODEL_DRIFT — while later publishes are eligible."""
    app, fetcher, admin, sampler = _ledger_service(
        tmp_path, extra={"controller.enabled": "true"}
    )
    cc = app.cc
    ctl = cc.controller
    parts = sampler.all_partition_entities()
    for w in range(4, 6):
        fetcher.fetch_once(parts, w * 1000, (w + 1) * 1000 - 1)
        assert ctl.run_once() is not None
    entries = cc.ledger_entries()
    flags = [
        e["decision"]["calibrationEligible"]
        for e in entries
        if e["decision"]["source"] == "controller"
    ]
    # newest first: the LAST publish is eligible, the FIRST is not
    assert flags[-1] is False and flags[0] is True
