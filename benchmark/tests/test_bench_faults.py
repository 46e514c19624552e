"""A run at a size a test holds, past the harness's look for a card: sound,
it comes out correct; with the timed path broken underneath, or with the
reference in bfloat16 put in the program's place (the control), it does
not."""

import dataclasses
import sys
import time

import pytest
import torch

from conftest import small_cell
from harness.cell import forbidden_modules, run_cell

CELLS = ["kafka_200k.rebalance", "kafka_200k_jbod.rebalance_ring", "kafka_200k.decommission",
         "kafka_200k.whatif"]


def _run(cell, **kw):
    c = small_cell(cell, sample=1000)
    return run_cell(c, 2**31 + 7, 0.5, False, "cpu", time.monotonic(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert {m for m in out["metrics"]} >= {"setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = _run(cell, control_dtype=torch.bfloat16)
    assert not out["correct"], out["checks"]


def _unchanged(entry):
    orig = entry.opt.optimize

    def optimize(state, *a, **k):
        res = orig(state, *a, **k)
        return dataclasses.replace(res, proposals=[], state_after=state,
                                   objective_after=res.objective_before,
                                   violations_after=res.violations_before)

    entry.opt.optimize = optimize


def _half(entry):
    orig = entry.opt.optimize

    def optimize(state, *a, **k):
        res = orig(state, *a, **k)
        return dataclasses.replace(res, proposals=list(res.proposals)[: len(res.proposals) // 2])

    entry.opt.optimize = optimize


def _altered(entry):
    orig = entry.opt.optimize

    def optimize(state, *a, **k):
        res = orig(state, *a, **k)
        props = list(res.proposals)
        p = props[0]
        other = next(b for b in range(state.shape.B) if b not in p.new_replicas)
        props[0] = dataclasses.replace(p, new_replicas=(p.new_replicas[0], other)
                                       + tuple(p.new_replicas[2:]))
        return dataclasses.replace(res, proposals=props)

    entry.opt.optimize = optimize


@pytest.mark.parametrize("cell", CELLS[:3])
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=lambda f: f.__name__[1:])
def test_broken_proposal_path_is_not_correct(cell, fault):
    out = _run(cell, wrap=fault)
    assert not out["correct"], out["checks"]


def _batch_half(entry):
    orig = entry.ev.evaluate
    entry.ev.evaluate = lambda *a, **k: orig(*a, **k)[: len(a[1]) // 2]


def _batch_altered(entry):
    orig = entry.ev.evaluate

    def evaluate(*a, **k):
        out = orig(*a, **k)
        return [dataclasses.replace(o, objective=o.objective * 1.01) if i == 1 else o
                for i, o in enumerate(out)]

    entry.ev.evaluate = evaluate


def test_unapplied_scenarios_are_not_correct(monkeypatch):
    from cruise_control_tpu_torch.analyzer import scenario_eval
    from cruise_control_tpu_torch.models.whatif import HostState

    monkeypatch.setattr(scenario_eval, "_apply",
                        lambda base, sc, cat=None, **k: (base, HostState.of(base)))
    out = _run("kafka_200k.whatif")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_batch_half, _batch_altered], ids=lambda f: f.__name__[1:])
def test_broken_batch_is_not_correct(fault):
    out = _run("kafka_200k.whatif", wrap=fault)
    assert not out["correct"], out["checks"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cruise_control_tpu_torch.fake", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cruise_control_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert forbidden_modules() == ["cruise_control_tpu", "jax"]


def test_a_run_loads_no_jax_module(tmp_path):
    import subprocess

    code = ("import sys, time; sys.path[:0] = ['tests']; import conftest;"
            "from harness.cell import run_cell, forbidden_modules;"
            "run_cell(conftest.small_cell('kafka_200k.whatif'), 3, 0.2, False, 'cpu', time.monotonic());"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cruise_control_tpu')))")
    bench = __import__("conftest").BENCH
    out = subprocess.run([sys.executable, "-c", code], cwd=bench, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_runs_on_the_card(cuda_device):
    out = run_cell(small_cell("kafka_200k.rebalance"), 5, 0.5, True, cuda_device,
                   time.monotonic())
    assert out["correct"] and out["device"]["busy_s"] > 0


def test_cut_short_search_is_not_correct():
    """A search given a sliver of its steps answers valid proposals whose
    placement the reference finds far from where the full search takes it."""
    out = _run("kafka_200k.rebalance", search=dict(steps_per_round=1, num_rounds=1))
    assert out["checks"]["objective_ratio"]["value"] > out["checks"]["objective_ratio"]["limit"]
    assert not out["correct"], out["checks"]
