"""Scenario batch (analyzer/scenario_eval.py batch graph,
kernels/scenario.py): the evaluator's `last_batch["device_ms"]`, CUDA
events around the batch graph's one launch, a batch, in ms."""


def read(run):
    x = [r["device_ms"] for r in run.records if r.get("device_ms") is not None]
    return sum(x) / len(x) if x else None
