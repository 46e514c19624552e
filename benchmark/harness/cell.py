"""One run of one cell: set-up, the measured window, the traced part of
it, the reference's check, and the result line.

The window is a closed loop of one client: each request is sent when the
one before it has answered.  It runs until `seconds` have passed since
its start; the request in flight then finishes and counts.  Set-up (from
the process's start to the window's) builds the kernels (the first run
in a checkout compiles them; the seconds that takes are reported apart as
`kernel_build_s`), makes the inputs from the seed, builds the system and
sends two warm-up requests, the first of which captures every graph the
window replays.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

from harness import cells, entries
from harness import trace as trace_mod
from harness import traffic as traffic_mod

#: top-level module names that must not be loaded in a run's process:
#: JAX and the JAX package the port was made from
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cruise_control_tpu"})
#: the traced part of a traced run's window, from its start
TRACE_SECONDS = 6.0
WARMUP_REQUESTS = 2


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: cells.Cell
    dims: dict
    setup_s: float
    build_s: float          # the kernels' build, part of setup_s
    window_s: float
    records: list           # one dict a request of the window
    traced: list            # the records of the traced part
    traced_s: float         # its length, host clock
    trace: object | None    # trace.DeviceTrace of the traced part
    capture_s: float


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, *, score_dtype=None, search=None, control_dtype=None,
             wrap=None) -> dict:
    """The result of one run: `correct`, `attempted`, `failed`, the
    metrics of the run's kind (end-to-end untraced, per-layer traced), the
    device, and the numbers compared with their limits (`checks`).
    `score_dtype` runs the program in another score precision, `search`
    overrides keys of the configuration's search config, and
    `control_dtype` puts the reference in that precision in the program's
    place (all three for the control, never in the benchmark's own runs);
    `wrap(entry)` may break the entry's path underneath (the tests' faults)."""
    import torch

    cuda = device == "cuda"
    build_s = 0.0
    if cuda:
        from cruise_control_tpu_torch.kernels import _build

        t_build = time.monotonic()
        _build.build()
        build_s = time.monotonic() - t_build
    inputs = traffic_mod.build(cell.config, cell.traffic, seed)
    entry = entries.ENTRIES[inputs.entry](cell.config, inputs, device, seed,
                                          score_dtype=score_dtype, search=search)
    if wrap is not None:
        wrap(entry)
    for i in range(WARMUP_REQUESTS):
        entry.request(i, {})
    if cuda:
        torch.cuda.synchronize()
    # what set-up made stays: the collector leaves it out of its scans
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - t_start

    records, prof, trace_end, n_traced = [], None, None, 0
    if traced and cuda:
        prof = trace_mod.start()
    w0 = time.perf_counter()
    deadline = w0 + seconds
    i = WARMUP_REQUESTS
    while True:
        rec = dict(t0=time.perf_counter())
        try:
            entry.request(i, rec)
        except Exception as exc:  # a failed request is counted, and the run goes on
            rec.update(error=f"{type(exc).__name__}: {exc}", units=entry.units)
        rec["t1"] = time.perf_counter()
        records.append(rec)
        i += 1
        done = rec["t1"] >= deadline
        if prof is not None and trace_end is None and (
                done or rec["t1"] - w0 >= min(TRACE_SECONDS, seconds)):
            trace_end, n_traced = rec["t1"], len(records)
            trace_mod.stop(prof)
        if done:
            break
    window_s = records[-1]["t1"] - w0
    dev_trace = trace_mod.reduce(prof) if prof is not None else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded in the run's process: {found}")

    run = Run(cell=cell, dims=inputs.dims, setup_s=setup_s, build_s=build_s, window_s=window_s,
              records=records, traced=records[:n_traced],
              traced_s=(trace_end - w0) if trace_end else 0.0, trace=dev_trace,
              capture_s=entry.capture_s())
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = sum(1 for r in records if "error" in r or r.get("degraded"))
    missing = sum(int(r.get("missing", 0)) for r in records)
    t_check = time.monotonic()
    numbers = entry.check(control_dtype)
    check_s = time.monotonic() - t_check
    numbers["failed_requests"] = failed + missing
    # a number the cell's limits file does not name is read, not compared
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])} for k, v in numbers.items()
              if k in cell.limits}
    unlimited = {k: float(v) for k, v in numbers.items() if k not in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cells.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = dict(correct=bool(correct), attempted=len(records), failed=failed + missing,
               metrics=metrics, device=device_record(cuda, peak))
    if dev_trace is not None:
        out["device"].update(busy_s=dev_trace.busy_s, window_s=run.traced_s)
        out["breakdown"] = breakdown(dev_trace)
    out["run"] = dict(window_s=window_s, check_s=check_s, requests=len(records), build_s=build_s,
                      **unlimited, **getattr(entry, "readings", {}))
    if dev_trace is not None:
        out["run"].update(recorded_busy_s=dev_trace.recorded_busy_s,
                          candidates_sample=dev_trace.sample_in_requests(
                              "candidates_kernel", "bench.optimize"))
    out["checks"] = checks
    return out


def device_record(cuda: bool, peak: int) -> dict:
    if not cuda:
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    import torch

    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                memory_peak_bytes=int(peak))


def breakdown(t) -> dict:
    ops = sorted(((n, v[0]) for n, v in t.ops.items()), key=lambda x: -x[1])[:10]
    gaps = sorted(t.idle_gaps.items(), key=lambda x: -x[1])[:10]
    return dict(device_ops=[[n, s] for n, s in ops], idle_gaps=[[n, s] for n, s in gaps])
