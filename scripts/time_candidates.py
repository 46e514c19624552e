#!/usr/bin/env python3
"""Time the port's step kernels of one checkout on one GPU in each variant, and hold two checkouts' outputs bit for bit.

    python3 scripts/time_candidates.py DIR OUT.npz [--cdf both]
    python3 scripts/time_candidates.py --compare A.npz B.npz [...]

DIR is a checkout of the repository (for example an earlier commit
unpacked with `git archive`).  The first form builds DIR's CUDA kernels,
prints what `nvcc -Xptxas -v` says of DIR's candidates kernels (registers,
stack, spills), and runs DIR's `candidates` on the inputs of one real step
of each variant, recorded from DIR's own engine:

- default: the north star of chip_smoke.py (same spec and seed) with its
  SEARCH config at T=0, and the same inputs at T=1e-3 (the Metropolis
  draw's log decides there);
- prior: a prior-enabled config with `testing.fixtures.prior_table` (seed
  0, mix 0.5);
- bf16: score_dtype "bfloat16";
- disk_terms: BASELINE configuration 3 (chip_smoke.py's `MID_SPEC` with 4
  logdirs a broker, seed 42, its four-goal chain);
- intra: rebalance_disk on that cluster.

Each is timed with this checkout's chip_smoke.py `measure` whatever DIR is
(device time per call from torch.profiler, its own kernels, the CUDA-event
wall of back-to-back calls), and the default case also with one kind
alone (the other kinds' counts set to 0: relocations, swaps, leadership
transfers).  With `--cdf both`, the default and per-kind cases are timed
again with the broker CDF probed from global memory, as the kernel does
where it does not fit in shared memory (`CDF_SMEM_MAX` set to 0 for the
run).  The same step's `step_globals` and `apply_moves` calls are recorded
too, and each variant's are run and timed as cases of their own
(`<variant>:step_globals`, `<variant>:apply_moves`; apply_moves on a copy
of the step's carry, then back to back on one carry).  Every output field
of every case (the bundle, both payloads, the took-the-prior mask; the
globals vector; the SHA-256 of each array of the carry after one scatter)
goes into OUT.npz; one JSON line holds the times.

The second form compares the files' arrays byte for byte, case by case
and field by field, prints one JSON line, and exits 1 on any difference.
It needs a CUDA device, nvcc and nvidia-smi for the first form.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def _timing():
    """This checkout's chip_smoke.py, loaded as a module for its timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timing", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_report(root: Path) -> list[str]:
    """What ptxas says of the tree's candidates kernels: one line per
    instantiation (registers, stack frame, spill stores and loads)."""
    from cruise_control_tpu_torch.kernels import _build

    csrc = root / "cruise_control_tpu_torch" / "kernels" / "csrc"
    out = root / "cruise_control_tpu_torch" / "_build" / "candidates-ptxas.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [_build.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-I", str(csrc), "-o", str(out),
           str(csrc / "candidates.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=600)
    lines, entry = [], None
    for line in (log.stdout + log.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def record_step(cs, state, chain, cfg, prior=None):
    """DIR's engine of `cfg`, the recorded candidates call of its first
    step at T=0, and that step's step_globals and apply_moves calls (name
    -> (args, kwargs))."""
    import torch

    from cruise_control_tpu_torch.analyzer import Engine
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import apply as apply_k
    from cruise_control_tpu_torch.kernels import candidates as cand_k
    from cruise_control_tpu_torch.kernels import step_globals as glob_k

    kw = {} if prior is None else {"prior": prior}
    eng = Engine(state, chain, config=cfg, **kw)
    carry = eng.init_carry(Key.from_seed(cfg.seed))
    plan = eng.plan(carry)
    with cs.Capture([(cand_k, "candidates"), (glob_k, "step_globals"),
                     (apply_k, "apply_moves")]) as cap:
        eng.step(carry, 0.0, plan)
    torch.cuda.synchronize()
    (args, kw), = cap.calls["candidates"]
    step = {name: cap.calls[name][0] for name in ("step_globals", "apply_moves")}
    return eng, args, kw, step


def digest(a: np.ndarray) -> np.ndarray:
    """The SHA-256 of an array's dtype, shape and bytes, as u8[32]: what
    the comparison holds byte for byte in place of a carry's arrays (a
    north-star carry is ~50 MB, most of it the partition x rack counts)."""
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def run_step_kernels(cs, name: str, step: dict, arrays: dict, times: dict) -> None:
    """The step's step_globals and apply_moves calls as cases of their own:
    outputs (the globals vector; the carry after one scatter into a copy of
    the step's carry) into `arrays`, times into `times`."""
    import torch

    from cruise_control_tpu_torch.kernels import apply as apply_k
    from cruise_control_tpu_torch.kernels import step_globals as glob_k

    (sx, carry, *_), _ = step["step_globals"]
    buf = torch.empty(glob_k.size(sx.state.shape.num_topics), dtype=torch.float32,
                      device=carry.broker_load.device)
    glob_k.step_globals(sx, carry, buf)
    arrays[f"{name}:step_globals/vec"] = buf.cpu().numpy()
    rec = cs.measure(lambda: glob_k.step_globals(sx, carry, buf))
    times[f"{name}:step_globals"] = dict(ms=rec["ms"], own_kernel_ms=rec["own_kernel_ms"],
                                          call_ms=rec["call_ms"], by_kernel=rec["by_kernel"])
    (sx, carry, *rest), kw = step["apply_moves"]
    scratch = carry.clone()
    apply_k.apply_moves(sx, scratch, *rest, **kw)
    for f, v in vars(scratch).items():
        if isinstance(v, torch.Tensor):
            arrays[f"{name}:apply_moves/{f}"] = digest(v.cpu().numpy())
    rec = cs.measure(lambda: apply_k.apply_moves(sx, scratch, *rest, **kw))
    times[f"{name}:apply_moves"] = dict(ms=rec["ms"], own_kernel_ms=rec["own_kernel_ms"],
                                         call_ms=rec["call_ms"], by_kernel=rec["by_kernel"],
                                         survivors=int(rest[0].sum()) + int(rest[2].sum()))


def outputs(bundle) -> dict:
    """Every output array of a candidates call, by field name."""
    out = {}
    for k, v in bundle.items():
        if k in ("payr", "payl"):
            out.update({f"{k}.{f}": t.cpu().numpy() for f, t in v.items()})
        elif hasattr(v, "cpu"):
            out[k] = v.cpu().numpy()
    return out


def run_case(cs, cand_k, name: str, args, kw, arrays: dict, times: dict) -> None:
    """One case: its outputs into `arrays` (name/field) and its times."""
    bundle = cand_k.candidates(*args, **kw)
    arrays.update({f"{name}/{f}": a for f, a in outputs(bundle).items()})
    rec = cs.measure(lambda: cand_k.candidates(*args, **kw))
    times[name] = dict(ms=rec["ms"], own_kernel_ms=rec["own_kernel_ms"], call_ms=rec["call_ms"],
                       by_kernel=rec["by_kernel"], accepted=int(bundle["accept"].sum()),
                       n=int(bundle["delta"].shape[0]))


def per_kind(cs, cand_k, name: str, args, kw, times: dict) -> None:
    """The call with one kind alone: the other kinds' counts set to 0."""
    cp = args[0]
    for kind, keep in (("relocations", "K_r"), ("swaps", "K_s"), ("leadership", "K_l")):
        sub = dataclasses.replace(cp, **{k: (getattr(cp, k) if k == keep else 0)
                                         for k in ("K_r", "K_s", "K_l")})
        a = (sub, *args[1:])
        rec = cs.measure(lambda a=a: cand_k.candidates(*a, **kw))
        times[f"{name}:{kind}"] = dict(ms=rec["ms"], own_kernel_ms=rec["own_kernel_ms"],
                                       call_ms=rec["call_ms"], by_kernel=rec["by_kernel"],
                                       n=getattr(cp, keep))


def main(tree: str, out: str, cdf: str = "staged") -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_candidates: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(tree).resolve()
    if not (root / "cruise_control_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"time_candidates: {root} is not a checkout of the repository", file=sys.stderr)
        return 2
    cs = _timing()
    sys.path.insert(0, str(root))
    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, OptimizerConfig
    from cruise_control_tpu_torch.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER
    from cruise_control_tpu_torch.analyzer.objective import GoalChain
    from cruise_control_tpu_torch.kernels import _build
    from cruise_control_tpu_torch.kernels import candidates as cand_k
    from cruise_control_tpu_torch.testing.fixtures import (
        RandomClusterSpec,
        prior_table,
        random_cluster_fast,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()
    ptxas = ptxas_report(root)
    for line in ptxas:
        print("ptxas", line, flush=True)
    cfg = OptimizerConfig(**cs.SEARCH)
    arrays, times = {}, {}
    state = random_cluster_fast(RandomClusterSpec(**cs.NORTH_STAR_SPEC), seed=42, device="cuda")
    eng, args, kw, step = record_step(cs, state, DEFAULT_CHAIN, cfg)
    run_case(cs, cand_k, "default", args, kw, arrays, times)
    run_step_kernels(cs, "default", step, arrays, times)
    hot = torch.full((1,), 1e-3, dtype=torch.float32, device="cuda")
    run_case(cs, cand_k, "default_t", (*args[:6], hot), kw, arrays, times)
    per_kind(cs, cand_k, "default", args, kw, times)
    if cdf == "both":
        kept, cand_k.CDF_SMEM_MAX = cand_k.CDF_SMEM_MAX, 0
        run_case(cs, cand_k, "default_l1", args, kw, arrays, times)
        per_kind(cs, cand_k, "default_l1", args, kw, times)
        cand_k.CDF_SMEM_MAX = kept
    del eng, args, kw, step
    variants = (
        ("prior", dataclasses.replace(cfg, prior_enabled=True), prior_table(state.shape, 0, 0.5)),
        ("bf16", dataclasses.replace(cfg, score_dtype="bfloat16"), None),
    )
    for name, vcfg, prior in variants:
        eng, args, kw, step = record_step(cs, state, DEFAULT_CHAIN, vcfg, prior)
        run_case(cs, cand_k, name, args, kw, arrays, times)
        run_step_kernels(cs, name, step, arrays, times)
        del eng, args, kw, step
    del state
    torch.cuda.empty_cache()
    jbod = random_cluster_fast(RandomClusterSpec(**{**cs.MID_SPEC, "disks_per_broker": 4}), seed=42,
                               device="cuda")
    for name, chain, vcfg in (
        ("disk_terms", GoalChain.from_names(list(cs.CONFIG3_CHAIN)), cfg),
        ("intra", GoalChain.from_names(list(DEFAULT_INTRA_BROKER_GOAL_ORDER)),
         dataclasses.replace(cfg, intra_broker=True)),
    ):
        eng, args, kw, step = record_step(cs, jbod, chain, vcfg)
        run_case(cs, cand_k, name, args, kw, arrays, times)
        run_step_kernels(cs, name, step, arrays, times)
        del eng, args, kw, step
    np.savez(out, **arrays)
    print(json.dumps({"tree": str(root), "card": smi, "ptxas": ptxas, "times": times}), flush=True)
    return 0


def compare(paths: list[str]) -> int:
    """Byte-for-byte comparison of the dumps' arrays against the first's:
    each case of a later dump against the first's case of the same name,
    a `<case>_l1` case (the CDF probed from global memory) against
    `<case>`."""
    ref = np.load(paths[0])
    report, ok = {}, True
    for p in paths[1:]:
        other = np.load(p)
        diff, held = [], 0
        for k in other.files:
            case, field = k.split("/", 1)
            want = f"{case.removesuffix('_l1')}/{field}"
            if want not in ref.files:
                diff.append(k)
                continue
            a, b = ref[want], other[k]
            held += 1
            if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
                diff.append(k)
        missing = sorted(k for k in ref.files if k not in other.files)
        cases = sorted({k.split("/")[0] for k in other.files})
        report[p] = dict(cases=cases, arrays=held, differ=sorted(diff), missing=missing)
        ok = ok and not diff and not missing
    print(json.dumps({"compare": paths[0], "identical": ok, "against": report}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2:]))
    argv = sys.argv[1:]
    mode = "staged"
    if "--cdf" in argv:
        at = argv.index("--cdf")
        mode = argv[at + 1]
        del argv[at: at + 2]
    sys.exit(main(argv[0], argv[1], mode))
