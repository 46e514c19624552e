"""Segmented (preemptible) execution of the port's fused anneal against its
one-launch run and the JAX package's segmented run, on the CPU.

- Every segmented run here is at SegmentContext(1e-9): the slice budget is
  floored at 1 ms, a round on these fixtures takes longer on both sides,
  so every slice is one round and a checkpoint fires between every two.
  Placements, per-round records and early stops equal the port's
  one-launch run exactly, and the JAX package's segmented run (the
  temperatures within rtol 1e-6: they scale the initial objective, which
  the reference's compiled program may round one ulp apart; with
  diagnostics the objectives and violations within rtol 1e-5, atol 1e-8,
  as tests/test_torch_diagnostics.py holds them); the slice count equals
  the JAX package's.
- A segmented run that another run on its engine interrupts (the pause of
  a checkpoint, `SegmentContext.paused`) restores its own generation and
  state and ends bit for bit its solo run.
- Snapshots (`offer_snapshot`) own their memory; the schedule's slice end
  stops a launch where the host asked.
"""

import contextvars
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.analyzer.engine import SegmentContext as JSegmentContext
from cruise_control_tpu.analyzer.engine import segmented_execution as j_segmented
from cruise_control_tpu.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER as J_INTRA
from cruise_control_tpu.analyzer.objective import GoalChain as JChain
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.engine import (
    CarryCheckpoint,
    SegmentContext,
    current_segment_context,
    segmented_execution,
)
from cruise_control_tpu_torch.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER
from cruise_control_tpu_torch.analyzer.objective import GoalChain as TChain
from cruise_control_tpu_torch.common.blackbox import RECORDER, read_spool
from cruise_control_tpu_torch.common.dispatch import dispatch_meter
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import schedule as sk
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.testing import fixtures as tf

FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=4, seed=1)
INTRA = dict(num_candidates=128, steps_per_round=16, num_rounds=3, intra_broker=True, seed=2)
#: the modes of the fused route: config overrides
MODES = {
    "default": {},
    "diagnostics": dict(diagnostics=True),
    "prior": dict(prior_enabled=True),
    "bf16": dict(score_dtype="bfloat16"),
    "intra": INTRA,
}
FIXTURES = ["small_cluster", "jbod_cluster"]
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


def _peaked(shape, mix=0.5):
    """A peaked prior (tests/test_controller.py:69-92): every topic's mass
    on broker 0, half the topics' also on one more broker."""
    w = np.zeros((shape.num_topics, shape.B), np.float32)
    w[:, 0] = 1.0
    w[::2, shape.B // 2] = 2.0
    return SimpleNamespace(weights=w, mix=mix)


def _case(fixture, mode):
    """(JAX state, config dict, JAX chain, port chain, prior) of a case."""
    js = getattr(jf, fixture)()
    if mode == "intra":
        return (js, dict(INTRA), JChain.from_names(J_INTRA),
                TChain.from_names(DEFAULT_INTRA_BROKER_GOAL_ORDER), None)
    prior = _peaked(js.shape) if mode == "prior" else None
    return js, dict(FAST, **MODES[mode]), J_CHAIN, T_CHAIN, prior


def decommission(state, broker: int):
    """`state` with `broker` dead (chip_smoke.py phase 5's decommission):
    its disks dead and its replicas offline."""
    alive = state.broker_alive.clone()
    alive[broker] = False
    return dataclasses.replace(
        state, broker_alive=alive, disk_alive=alive[:, None] & state.disk_alive,
        replica_offline=state.replica_offline | (state.replica_valid & ~alive[state.replica_broker]))


def _same_port_runs(a, b):
    (sa, ha), (sb, hb) = a, b
    for f in PLACEMENT:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert _rounds(ha) == _rounds(hb)


def _same_as_jax(t_final, t_hist, j_final, j_hist, diag):
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(t_final, f).numpy(), np.asarray(getattr(j_final, f)),
                                      err_msg=f)
    tr, jr = _rounds(t_hist), _rounds(j_hist)
    floats = ("objective", "goal_violations", "temperature")
    assert [{k: v for k, v in h.items() if k not in floats} for h in tr] == \
        [{k: v for k, v in h.items() if k not in floats} for h in jr]
    np.testing.assert_allclose([h["temperature"] for h in tr], [h["temperature"] for h in jr],
                               rtol=1e-6)
    if diag:
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a["objective"], b["objective"], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(a["goal_violations"], b["goal_violations"], rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture", FIXTURES)
def test_segmented_matches_one_launch_and_jax(fixture, mode):
    """One-round slices with a checkpoint between each two: the port's
    one-launch run bit for bit, the JAX package's segmented run, and its
    slice count."""
    js, cfg, jchain, tchain, prior = _case(fixture, mode)
    ts = _port(js)
    one = TEngine(ts, tchain, config=TConfig(**cfg), prior=prior).run()
    checkpoints = []
    with segmented_execution(SegmentContext(1e-9, checkpoint=lambda: checkpoints.append(1))):
        seg = TEngine(ts, tchain, config=TConfig(**cfg), prior=prior).run()
    _same_port_runs(one, seg)
    t = _timing(seg[1])
    assert t["segmented"] and t["segments"] > 1
    assert t["blocking_syncs"] == t["segments"] == len(checkpoints) + 1
    assert [s["rounds"] for s in t["slices"]] == [1] * t["segments"]
    assert t["loop_iterations"] == _timing(one[1])["loop_iterations"]
    if mode == "diagnostics":
        assert t["convergence"] == _timing(one[1])["convergence"]
    with j_segmented(JSegmentContext(1e-9)):
        j_final, j_hist = JEngine(js, jchain, config=JConfig(**cfg), prior=prior).run()
    _same_as_jax(*seg, j_final, j_hist, mode == "diagnostics")
    assert t["segments"] == _timing(j_hist)["segments"]


def test_segmented_warm_start_matches_jax():
    """Segmentation composes with the warm start (tests/test_scheduler.py
    :97): a run started from the first run's placement slices bit for bit
    its one-launch run, and gives the JAX package's segmented result."""
    js = jf.small_cluster()
    ts = _port(js)
    first, _ = TEngine(ts, T_CHAIN, config=TConfig(**FAST)).run()
    warm = tuple(getattr(first, f) for f in PLACEMENT)
    one = TEngine(ts, T_CHAIN, config=TConfig(**FAST)).run(initial_placement=warm)
    with segmented_execution(SegmentContext(1e-9)):
        seg = TEngine(ts, T_CHAIN, config=TConfig(**FAST)).run(initial_placement=warm)
    _same_port_runs(one, seg)
    j_first, _ = JEngine(js, J_CHAIN, config=JConfig(**FAST)).run()
    j_warm = tuple(getattr(j_first, f) for f in PLACEMENT)
    with j_segmented(JSegmentContext(1e-9)):
        j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**FAST)).run(initial_placement=j_warm)
    _same_as_jax(*seg, j_final, j_hist, False)
    assert _timing(seg[1])["segments"] == _timing(j_hist)["segments"]


def test_run_reported_segmented_payload():
    """`run_reported` honours the context: the before-report heads the
    slices, the after-report and checks follow the last, and the payload
    equals the one-launch reported run's; one sync a slice."""
    st = tf.dead_broker_cluster("cpu")
    f1, h1, p1 = TEngine(st, T_CHAIN, config=TConfig(**FAST)).run_reported()
    with segmented_execution(SegmentContext(1e-9)), dispatch_meter() as m:
        f2, h2, p2 = TEngine(st, T_CHAIN, config=TConfig(**FAST)).run_reported()
    _same_port_runs((f1, h1), (f2, h2))
    assert set(p1) == set(p2)
    for k in p1:
        if k.startswith("stats_"):
            for f in dataclasses.fields(p1[k]):
                assert torch.equal(getattr(p1[k], f.name), getattr(p2[k], f.name)), (k, f.name)
        else:
            np.testing.assert_array_equal(p1[k], p2[k], err_msg=k)
    t = _timing(h2)
    assert m.counts["engine.slice"] == m.counts["engine.sync"] == t["segments"] == t["blocking_syncs"]
    assert m.counts["engine.init"] == 1 and "engine.run" not in m.counts


def test_no_segment_context_means_unsegmented():
    """No ambient context: the one-launch fused run (one blocking sync, no
    `segmented` key), as tests/test_scheduler.py:115 pins it."""
    assert current_segment_context() is None
    _, h = TEngine(tf.small_cluster("cpu"), T_CHAIN, config=TConfig(**FAST)).run()
    t = _timing(h)
    assert "segmented" not in t and t["blocking_syncs"] == 1


def test_verbose_and_legacy_runs_stay_unsegmented():
    """A verbose run and the legacy route ignore the context, as in the
    JAX package; so does the streaming cycle (`run_cycle`)."""
    st = tf.small_cluster("cpu")
    with segmented_execution(SegmentContext(1e-9)):
        _, hv = TEngine(st, T_CHAIN, config=TConfig(**FAST)).run(verbose=True)
        _, hl = TEngine(st, T_CHAIN, config=TConfig(**FAST, fused_rounds=False)).run()
        eng = TEngine(st, T_CHAIN, config=TConfig(**FAST))
        rows = np.arange(2, dtype=np.int32)
        ll = st.replica_load_leader.clone()
        fl = st.replica_load_follower.clone()
        _, _, _, hc = eng.run_cycle(ll, fl, rows, ll[:2].numpy() * 1.1, fl[:2].numpy() * 1.1,
                                    tuple(getattr(st, f) for f in PLACEMENT))
    for h in (hv, hl, hc):
        assert "segmented" not in _timing(h)
    assert _timing(hv)["blocking_syncs"] == 1 and _timing(hc)["blocking_syncs"] == 1


def test_diagnostics_byte_parity_segmented():
    """The port of tests/test_ledger.py:173: a diagnostics run in slices
    of a 0.1 ms budget keeps the placement and its convergence summary."""
    spec = tf.RandomClusterSpec(num_brokers=12, num_partitions=200, num_racks=4, num_topics=6,
                                skew=1.0)
    state = tf.random_cluster_fast(spec, seed=5, device="cpu")
    cfg = TConfig(num_candidates=128, leadership_candidates=32, swap_candidates=16,
                  steps_per_round=8, num_rounds=3, seed=0, diagnostics=True)
    base = TEngine(state, T_CHAIN, config=cfg).run()
    with segmented_execution(SegmentContext(slice_budget_s=1e-4)):
        seg = TEngine(state, T_CHAIN, config=cfg).run()
    _same_port_runs(base, seg)
    timing = _timing(seg[1])
    assert timing["segmented"] and timing["segments"] >= 2
    conv = timing["convergence"]
    assert conv == _timing(base[1])["convergence"]
    assert conv["rounds"] >= 1 and conv["goal_names"] == T_CHAIN.names()


def test_offer_snapshot_cadence_one_in_flight_and_off_path():
    """The port of tests/test_mesh_ft.py:300 with a list as the sink: every
    Nth boundary captures, one persist in flight (a due one is skipped),
    a raising sink never reaches the run, and the default captures
    nothing."""
    import threading

    gate = threading.Event()
    landed = []

    def slow_sink(ckpt):
        gate.wait(10.0)
        landed.append(ckpt)

    ctx = SegmentContext(0.0, snapshot_every=2, snapshot_sink=slow_sink)
    ctx.offer_snapshot(lambda: "b1")  # boundary 1: not due
    assert ctx.snapshots_taken == 0
    ctx.offer_snapshot(lambda: "b2")  # boundary 2: captured, persisting
    ctx.offer_snapshot(lambda: "b3")  # boundary 3: not due
    ctx.offer_snapshot(lambda: "b4")  # boundary 4: due but one in flight: skipped
    assert ctx.snapshots_taken == 1 and ctx.snapshots_skipped == 1
    assert landed == []
    gate.set()
    ctx.wait_snapshot()
    assert landed == ["b2"]
    bad = SegmentContext(0.0, snapshot_every=1,
                         snapshot_sink=lambda c: (_ for _ in ()).throw(OSError("disk full")))
    bad.offer_snapshot(lambda: "x")
    bad.wait_snapshot()
    assert bad.snapshots_taken == 1
    off = SegmentContext(0.0, snapshot_sink=landed.append)
    off.offer_snapshot(lambda: pytest.fail("the off path must not capture"))
    assert off.snapshots_taken == 0


def test_snapshots_own_their_memory():
    """A snapshot taken mid-run equals the run's state at its boundary
    after the run has ended: the checkpoint records the workspace's carry
    at the same boundary, and later slices change neither."""
    st = tf.dead_broker_cluster("cpu")
    eng = TEngine(st, T_CHAIN, config=TConfig(**FAST))
    at_boundary = []

    def checkpoint():
        c = eng._ws.carry
        at_boundary.append({f: getattr(c, f).numpy().copy() for f in ("replica_broker",
                                                                      "broker_load")})

    sink = []
    ctx = SegmentContext(1e-9, checkpoint=checkpoint, snapshot_every=1, snapshot_sink=sink.append)
    with segmented_execution(ctx), dispatch_meter() as m:
        final, hist = eng.run()
    ctx.wait_snapshot()
    n = _timing(hist)["segments"]
    assert len(sink) == len(at_boundary) == n - 1 == m.counts["engine.snapshot"]
    for i, (snap, seen) in enumerate(zip(sink, at_boundary)):
        assert isinstance(snap, CarryCheckpoint) and snap.base == i + 1
        for f, a in seen.items():
            np.testing.assert_array_equal(snap.carry[f], a, err_msg=f)
        assert int(snap.seg["si"][sk.RND]) == snap.base
        assert len(snap.ys_parts) == snap.base
        assert all(len(p["ran"]) == 1 for p in snap.ys_parts)
    # the last snapshot is not the final state (later slices moved on)
    np.testing.assert_array_equal(final.replica_broker.numpy(),
                                  eng._ws.carry.replica_broker.numpy())


def test_paused_run_restores_after_another_run_on_its_engine():
    """At a checkpoint that pauses, a run of the holding thread
    (`Engine.locked`) lets go of the engine; another run on it, of another
    generation (a decommission), goes through; the paused run rebinds its
    own generation, copies its state back and ends bit for bit its solo
    run; the other run gives its own solo result too."""
    st = tf.dead_broker_cluster("cpu")
    decom = decommission(st, 1)
    cfg = TConfig(**FAST)
    solo = TEngine(st, T_CHAIN, config=cfg).run()
    solo_other = TEngine(decom, T_CHAIN, config=cfg).run()
    eng = TEngine(st, T_CHAIN, config=cfg)
    other = []

    def checkpoint():
        if other:
            return
        with ctx.paused():
            assert not eng.run_lock.locked()

            def urgent():
                with eng.locked():
                    eng.rebind(decom)
                    return eng.run()

            other.append(contextvars.Context().run(urgent))  # outside the segment context

    ctx = SegmentContext(1e-9, checkpoint=checkpoint)
    with segmented_execution(ctx), eng.locked():
        resumed = eng.run()
    _same_port_runs(resumed, solo)
    _same_port_runs(other[0], solo_other)
    t = _timing(resumed[1])
    assert t["pauses"] == 1 and t["restores"] == 1 and t["segments"] > 2
    assert "segmented" not in _timing(other[0][1])


def test_pause_without_the_run_lock_stashes_nothing():
    """A run whose thread does not hold the engine's lock (a direct
    Engine user) lets go of nothing at a pause, and a checkpoint that does
    not pause keeps the one path: no stash either way."""
    st = tf.small_cluster("cpu")
    eng = TEngine(st, T_CHAIN, config=TConfig(**FAST))
    ctx = SegmentContext(1e-9)

    def checkpoint():
        with ctx.paused():
            pass

    ctx.checkpoint = checkpoint
    with segmented_execution(ctx):
        _, h = eng.run()
    assert _timing(h)["pauses"] == _timing(h)["segments"] - 1 and _timing(h)["restores"] == 0
    assert eng._ws.stash is None


def _same_ys(a, b):
    """Equal ys rows, NaN (a round's unreported objective) equal to NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def _plain_schedule(total, slice_ends):
    """A 2-main, (total - 2)-polish schedule driven launch by launch, each
    launch ending where `slice_ends` says (None: the whole run), every round
    running; returns (ys, launches, rounds per launch)."""
    dims = sk.ScheduleDims(n_main=2, total=total, tol_on=False, checks=2, verbose=False,
                           tol=0.0, scale=float(np.float32(1e-2)))
    s = sk.Schedule.create(total, 0.5, "cpu")
    s.sf[sk.OBJ] = 10.0
    sk.round_schedule(sk.INIT, s, dims)
    assert int(s.si[sk.SLICE_END]) == total
    per_launch = []
    for end in slice_ends:
        if end is not None:
            s.si[sk.SLICE_END] = end
        start = int(s.si[sk.RND])
        while True:
            sk.round_schedule(sk.GATE, s, dims)
            sk.round_schedule(sk.DECIDE, s, dims)
            if s.si[sk.RUN]:
                s.acc[0] += 3
                s.sf[sk.CHEAP] = 1.0
            sk.round_schedule(sk.CLOSE, s, dims)
            if not s.si[sk.LOOP]:
                break
        ys_before = s.ys.clone()
        sk.round_schedule(sk.EXIT, s, dims)
        if not sk.run_over(s, dims):
            assert _same_ys(s.ys, ys_before)  # a slice that is not the last
        per_launch.append(int(s.si[sk.RND]) - start)
        if sk.run_over(s, dims):
            break
    return s.ys.clone(), per_launch


def test_slice_end_stops_a_launch_and_an_overhang_ends_at_total():
    """The schedule's slice end: a launch runs rounds [base, min(base + L,
    total)); EXIT leaves the rows alone at the end of a slice that is not
    the last; the ys of any slicing equal the whole run's, an overhanging
    last slice (base + L > total) included."""
    whole, launches = _plain_schedule(5, [None])
    assert launches == [5]
    for ends in ([1, 2, 3, 4, 5], [2, 4, 8], [1, 3, 7], [4, 100]):
        ys, per = _plain_schedule(5, ends)
        assert _same_ys(ys, whole), ends
        want = [min(e, 5) - b for b, e in zip([0] + ends[:-1], ends)]
        assert per == want[:len(per)], (ends, per)


def test_segmented_run_records_its_slices_in_the_black_box(tmp_path):
    """Each slice is one "engine-slice" record (common/blackbox.py), begun
    before the launch and ended after its sync."""
    path = str(tmp_path / "spool-1.jsonl")
    RECORDER.configure(path)
    try:
        with segmented_execution(SegmentContext(1e-9)):
            _, h = TEngine(tf.small_cluster("cpu"), T_CHAIN, config=TConfig(**FAST)).run()
    finally:
        RECORDER.configure(None)
    recs = [r for r in read_spool(path) if r["t"] == "engine-slice"]
    n = _timing(h)["segments"]
    assert [r["ph"] for r in recs] == ["B", "E"] * n
    assert [r["base_round"] for r in recs if r["ph"] == "B"] == list(range(n))
    assert all(r["ok"] for r in recs if r["ph"] == "E") and recs[-1]["done"] in (True, False)
    json.dumps(recs)

