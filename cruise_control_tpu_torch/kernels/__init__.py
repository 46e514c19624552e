"""Hand-written CUDA kernels of the anneal, the streaming cycle and the
scenario batch, with their plain versions.

Each wrapper module holds the kernel's launch, the plain PyTorch version of
the same function, and a header note naming the JAX function it replaces.
A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; anything else raises.  `LAUNCHES` counts kernel
launches per wrapper (one per wrapper call that launched, `count`), so a
run can show that its path went through the kernels.  A wrapper called
while its thread captures a CUDA graph counts the launch it records into
the capture's own record (`capture`), not into `LAUNCHES`; the engine
adds those counts per replay (`add_launches`).  The eager warm-up before
a capture counts into a record of its thread too (`recording`), so a
capture on a pool thread beside a run adds nothing to that run's counts.
Counting is locked, so threads that run on the card at once lose no
count.  Every capture of the
package goes through `capture`, one at a time in the process: entering a
capture synchronises the whole device, which a capture in flight on
another thread forbids.  The interpreter's cyclic garbage collector is
off while a capture lasts: a collection inside it could destroy an
unreachable CUDA graph, whose reset a capturing stream forbids, and the
capture would fail.  The same lock (`graph_lock`) is held around every
build and destroy of an instantiated graph of the package's libraries
(the loop, slice, scenario and node-floor graphs) and around an engine's
release of its captured graphs: on an H100, two threads instantiating
loop graphs at once deadlocked inside the CUDA graph build once
torch.profiler had traced the process, so the package instantiates and
destroys its graphs one at a time.
"""

from __future__ import annotations

import contextlib
import gc
import threading

_LOCK = threading.Lock()
_TLS = threading.local()
_CAPTURE_LOCK = threading.RLock()

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
    # the sharded-model mode's (kernels/model_shard.py; the candidates
    # kernel's SHARD body counts as candidates_shard, the own_rows
    # kernel's hop-4 launch as own_member_rows)
    "candidates_shard": 0,
    "shard_sources": 0,
    "own_rows": 0,
    "own_member_rows": 0,
    "own_parts": 0,
    "shard_prc": 0,
}


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count(name: str, n: int = 1) -> None:
    """`n` launches of wrapper `name`: into this thread's capture record
    while it captures (`capture`), else into `LAUNCHES`."""
    rec = getattr(_TLS, "record", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + n
        return
    with _LOCK:
        LAUNCHES[name] += n


def graph_lock() -> threading.RLock:
    """The process's graph lock, re-entrant: held by every capture
    (`capture`), and around every build and destroy of an instantiated
    graph and every release of captured graphs."""
    return _CAPTURE_LOCK


@contextlib.contextmanager
def capture(graph, stream):
    """Capture `graph` (a torch.cuda.CUDAGraph) on `stream`, the only
    capture in the process while it lasts; yields the capture's launch
    record (wrapper -> launches a replay), which the launches this thread
    counts inside go into.  Other threads' work on the card goes on: the
    capture forbids unsafe calls to its own thread only (thread_local)."""
    import torch

    with _CAPTURE_LOCK:
        _TLS.record = rec = {}
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                yield rec
        finally:
            _TLS.record = None
            if collecting:
                gc.enable()


@contextlib.contextmanager
def recording():
    """Count the launches this thread makes inside the block into a record
    of its own (wrapper -> launches), yielded, and not into `LAUNCHES`:
    the eager warm-up of a capture, whose launches belong to no run."""
    prev = getattr(_TLS, "record", None)
    _TLS.record = rec = {}
    try:
        yield rec
    finally:
        _TLS.record = prev


def add_launches(per_replay: dict[str, int], replays: int) -> None:
    """Count the launches of a CUDA graph's replays: `per_replay` holds the
    wrapper launches recorded into the graph when it was captured."""
    with _LOCK:
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
