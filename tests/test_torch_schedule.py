"""The fused route's early exit against the reference's masked rounds.

The reference scans every scheduled round (`num_rounds + max_extra_rounds`)
and masks the rounds after an early stop; the port's loop ends right after
the round that stops the run, and its EXIT phase writes the rounds it never
reached.  Here the plain schedule run as the loop runs it (round after round
until CLOSE clears `loop`, then EXIT) must leave the same ys bytes, NaN bits
included, and the same final state as the same schedule run over every
round with masked rounds: over scripted gate inputs (decays 0.5 and 0.7;
stops at round 1, at the last main round, in a polish round, on a polish
stall, and never), and through the engine on the four small fixtures, whose
history must also equal the JAX package's.  Temperatures scale the initial
objective, which the reference's compiled program may round one f32 ulp
apart: rtol=1e-6 against JAX; everything else exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import schedule as sk
from cruise_control_tpu_torch.models.state import STATE_FIELDS

FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
FIXTURES = ["small_cluster", "rack_violated_cluster", "dead_broker_cluster", "jbod_cluster"]
TOL = float(np.float32(1e-6))
BIG = 1e-2  # a signal far above the tolerance

#: per scheduled round (4 main, 3 polish): the cheap signal the round body
#: reports and the full-chain violation a check would find; the round the
#: run stops in (None: never)
SCRIPTS = {
    "stop_round_1": ([TOL, BIG, BIG, BIG, BIG, BIG, BIG], [BIG, 0.0, BIG, BIG, BIG, BIG, BIG], 1),
    "stop_last_main": ([BIG, BIG, TOL, BIG, BIG, BIG, BIG], [BIG, BIG, BIG, TOL, BIG, BIG, BIG], 3),
    # both checks spent in the main rounds, then a stall in the second polish round
    "checks_spent_then_stall": ([TOL, TOL, TOL, BIG, BIG, BIG, BIG],
                                [BIG, 5e-4, 5e-4, 0.0, BIG, BIG, BIG], 5),
    "stop_polish": ([BIG] * 7, [BIG, BIG, BIG, BIG, 1e-3, TOL, BIG], 5),
    "stop_polish_stall": ([BIG] * 7, [BIG, BIG, BIG, BIG, 1e-3, 9.5e-4, BIG], 5),
    "never": ([BIG] * 7, [BIG, BIG, BIG, BIG, 1e-3, 5e-4, 2e-4], None),
}


def _round(s: sk.Schedule, d: sk.ScheduleDims, cheap, full, rnd_acc=7) -> None:
    """One round of the plain schedule with the engine's work scripted."""
    rnd = int(s.si[sk.RND])
    sk.round_schedule(sk.GATE, s, d)
    if s.si[sk.NEED_FULL]:
        s.sf[sk.FULL_V] = full[rnd]
    sk.round_schedule(sk.DECIDE, s, d)
    if s.si[sk.RUN]:
        s.acc += rnd_acc + rnd
        s.sf[sk.CHEAP] = cheap[rnd]
        s.sf[sk.OBJ] = 3.0 / (rnd + 1)
    sk.round_schedule(sk.CLOSE, s, d)


def _run(d: sk.ScheduleDims, decay: float, cheap, full, *, as_loop: bool) -> sk.Schedule:
    s = sk.Schedule.create(d.total, decay, "cpu")
    s.sf[sk.OBJ] = 37.0
    sk.round_schedule(sk.INIT, s, d)
    if as_loop:
        while True:
            _round(s, d, cheap, full)
            if not s.si[sk.LOOP]:
                break
        sk.round_schedule(sk.EXIT, s, d)
    else:
        for _ in range(d.total):
            _round(s, d, cheap, full)
    return s


def _same_bytes(a: sk.Schedule, b: sk.Schedule) -> None:
    assert torch.equal(a.ys.view(torch.int64), b.ys.view(torch.int64))
    assert torch.equal(a.si, b.si)
    assert torch.equal(a.sf.view(torch.int32), b.sf.view(torch.int32))
    assert torch.equal(a.acc, b.acc)


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("decay", [0.5, 0.7])
@pytest.mark.parametrize("script", SCRIPTS)
def test_loop_exit_matches_masked_rounds(script, decay, verbose):
    cheap, full, stop = SCRIPTS[script]
    d = sk.ScheduleDims(n_main=4, total=7, tol_on=True, checks=2, verbose=verbose, tol=TOL,
                        scale=float(np.float32(1e-2)))
    loop = _run(d, decay, cheap, full, as_loop=True)
    scan = _run(d, decay, cheap, full, as_loop=False)
    _same_bytes(loop, scan)
    ran = loop.ys[:, sk.YS.index("ran")].numpy()
    iterations = int(loop.count[sk.ITERS])
    if stop is None:
        assert iterations == d.total and not bool(loop.si[sk.DONE])
    else:
        assert iterations == stop + 1 and bool(loop.si[sk.DONE])
        assert not ran[stop:].any() and ran[:stop].all()
    # the loop never runs a masked round; the scan runs one a round past the stop
    assert int(loop.count[sk.MASKED]) == 0
    assert int(scan.count[sk.MASKED]) == d.total - iterations
    # the rows EXIT wrote carry the temperature DECIDE gives a masked round
    temps = loop.ys[:, sk.YS.index("temperature")].numpy()
    t0 = np.float32(37.0) * np.float32(1e-2)
    for r in range(iterations, d.total):
        want = 0.0 if r >= d.n_main - 1 else float(t0 * np.float32(decay) ** np.float32(r))
        assert temps[r] == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("case", ["no_polish_rounds", "tolerance_off"])
def test_loop_exit_edge_schedules(case):
    """No polish rounds (the loop's last round is the last main round), and
    early stop disabled (every round runs; EXIT writes nothing)."""
    cheap, full, _ = SCRIPTS["stop_round_1"]
    total = 4 if case == "no_polish_rounds" else 7
    d = sk.ScheduleDims(n_main=4, total=total, tol_on=case != "tolerance_off", checks=2,
                        verbose=False, tol=TOL, scale=1.0)
    loop = _run(d, 0.5, cheap, full, as_loop=True)
    _same_bytes(loop, _run(d, 0.5, cheap, full, as_loop=False))
    assert int(loop.count[sk.ITERS]) == (2 if case == "no_polish_rounds" else total)


def test_exit_past_the_schedule_changes_nothing():
    """EXIT after a loop that ran every round (or past it) is a no-op."""
    cheap, full, _ = SCRIPTS["never"]
    d = sk.ScheduleDims(n_main=4, total=7, tol_on=True, checks=2, verbose=False, tol=TOL, scale=1.0)
    s = _run(d, 0.7, cheap, full, as_loop=False)
    before = [t.clone() for t in (s.si, s.sf, s.acc, s.ys)]
    sk.round_schedule(sk.EXIT, s, d)
    for a, b in zip(before, (s.si, s.sf, s.acc, s.ys)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


def _masked_scan(te: TEngine, verbose: bool):
    """The port's fused route run over every scheduled round, masked rounds
    and all, as the reference's scan runs (no loop exit, no EXIT)."""
    ws = te._workspace()
    dims = te._sched_dims(verbose)
    te._init_run(ws, dims)
    for _ in range(dims.total):
        te._round_eager(ws, dims)
    return ws.sched.ys.clone(), te._final_state(ws)


@pytest.mark.parametrize("name", FIXTURES)
def test_fused_history_matches_masked_scan_and_jax(name):
    js = getattr(jf, name)()
    cfg = dict(FAST, fused_rounds=True)
    j_final, j_hist = JEngine(js, J_CHAIN, config=JConfig(**cfg)).run()
    te = TEngine(_port(js), T_CHAIN, config=TConfig(**cfg))
    ys_scan, final_scan = _masked_scan(te, False)
    final, hist = te.run()
    ys_loop = te._ws.sched.ys
    assert torch.equal(ys_loop.view(torch.int64), ys_scan.view(torch.int64))
    rounds = [h for h in hist if "round" in h]
    assert te._fused_history(ys_scan.numpy(), verbose=False) == rounds
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert torch.equal(getattr(final, f), getattr(final_scan, f)), f
        np.testing.assert_array_equal(getattr(final, f).numpy(), np.asarray(getattr(j_final, f)))
    j_rounds = [h for h in j_hist if "round" in h]
    assert [{k: v for k, v in h.items() if k != "temperature"} for h in rounds] == \
        [{k: v for k, v in h.items() if k != "temperature"} for h in j_rounds]
    np.testing.assert_allclose([h["temperature"] for h in rounds],
                               [h["temperature"] for h in j_rounds], rtol=1e-6)
    timing = hist[-1]
    assert timing["masked_rounds"] == 0 and timing["graph_launches"] == 0
    # the loop ran up to the last round that ran a body or a check
    ys = ys_loop.numpy()
    busy = np.nonzero(ys[:, sk.YS.index("ran")] + ys[:, sk.YS.index("full_check")])[0]
    assert timing["loop_iterations"] == busy.max() + 1 <= te._n_rounds()
