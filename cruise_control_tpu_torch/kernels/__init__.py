"""Hand-written CUDA kernels of the anneal, the streaming cycle and the
scenario batch, with their plain versions.

Each wrapper module holds the kernel's launch, the plain PyTorch version of
the same function, and a header note naming the JAX function it replaces.
A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; anything else raises.  `LAUNCHES` counts kernel
launches per wrapper (one per wrapper call that launched), so a run can show
that its path went through the kernels.  A wrapper called while a CUDA
graph is being captured counts the launch it records; the engine takes
those counts out of `LAUNCHES` at capture and adds them back per replay
(`add_launches`).
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {
    "threefry_uniform": 0,
    "move_delta": 0,
    "candidates": 0,
    "select_survivors": 0,
    "apply_moves": 0,
    "group_by_broker": 0,
    "refresh_aggregates": 0,
    "step_globals": 0,
    "round_schedule": 0,
    "scatter_loads": 0,
    "scenario_step": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_launches(per_replay: dict[str, int], replays: int) -> None:
    """Count the launches of a CUDA graph's replays: `per_replay` holds the
    wrapper launches recorded into the graph when it was captured."""
    for k, n in per_replay.items():
        LAUNCHES[k] += n * replays


def route(*tensors) -> str:
    """'cuda' when every tensor lies on a CUDA device, 'cpu' when every one
    lies on the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return "cuda"
    if kinds == {"cpu"}:
        return "cpu"
    raise ValueError(f"kernel inputs must all be on CUDA or all on the CPU, got {sorted(kinds)}")
