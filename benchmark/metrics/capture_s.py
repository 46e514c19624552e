"""Capture (analyzer/engine.py `Engine._capture`, the scenario batch
graph's capture): the optimizer's `compile_attribution` (its engines'
build, warm-up, capture and instantiation seconds) or the evaluator's
batch capture seconds, all paid in set-up, in s."""


def read(run):
    return run.capture_s
