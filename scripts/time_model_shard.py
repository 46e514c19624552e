#!/usr/bin/env python3
"""Time the sharded-model mode's ownership gathers of one checkout on one GPU, and hold two checkouts' outputs byte for byte.

    python3 scripts/time_model_shard.py [--target | --brokers N] DIR OUT.npz
    python3 scripts/time_model_shard.py --mesh [--target] DIR OUT.npz
    python3 scripts/time_model_shard.py --compare A.npz B.npz [...]

DIR is a checkout of the repository (for example an earlier commit
unpacked with `git archive`).  The first form builds DIR's CUDA kernels,
prints what `nvcc -Xptxas -v` says of DIR's model_shard.cu (registers,
stack, spills), and runs DIR's gathers at the step of chip_smoke.py's
phase 30 (a): the north star of chip_smoke.py (same spec and seed) padded
to a multiple of 4 rows, its loads rounded to integers, SEARCH's config,
the first step of the first round, emulated on one card for n = 2 and 4
shards (each shard's kernels on its own row blocks, a sum of the shard
bundles in place of the all_reduce):

- hop 1, `shard_sources` (on shard 0 again with the broker CDF probed
  from global memory, `:global_cdf`, and staged in shared memory,
  `:smem_cdf`, whatever `SOURCES_CDF_SMEM_MAX` says, where the tree has
  that gate);
- hop 2, `own_rows` of the source ids (18 words a row);
- hop 4, the members' brokers and the leadership members' rows: DIR's
  `own_member_rows` where it has one (one launch), else its two `own_rows`
  calls into the two parts of one bundle, timed as one call.

Each case is timed with this checkout's chip_smoke.py `measure` whatever
DIR is (device time per call from torch.profiler, its own kernels, the
CUDA-event wall of back-to-back calls), on shard 0 and on the last shard.
The SHA-256 of the fixture's placement columns, of the plan's CDF and
counts, of each shard's grouped index, of every shard's bundle of every
hop and of the assembled bundles goes into OUT.npz; one JSON line holds
the times, the rows each hop gathers and the rows the timed shard owns.

The second form needs four cards: it runs DIR's sharded-model mode 1x4
over NCCL on the same padded north star with integer loads (chip_smoke.py
`--mesh` (c)), one run to start and three repeated runs, and prints each
run's wall as the caller sees it, each rank's wall and a step's ms (the
slowest rank's wall over the run's steps); the SHA-256 of each run's final
placement goes into OUT.npz.

With `--target` both forms run chip_smoke.py's TARGET_SPEC (25,000
brokers, 2,000,000 partitions) in place of the north star, padded the
same way; the second form then keeps the float loads, as chip_smoke.py
`--mesh` (d) does.  `--brokers N` runs the first form on the north star
with N brokers (the CDF's length, which decides where staging it pays).

The third form compares the files' arrays byte for byte, prints one JSON
line, and exits 1 on any difference.  The first two need CUDA, nvcc and
nvidia-smi.
"""

from __future__ import annotations

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
    """What ptxas says of the tree's model_shard.cu kernels: one line per
    kernel (registers, stack frame, shared memory, spill stores and loads)."""
    from cruise_control_tpu_torch.kernels import _build

    csrc = root / "cruise_control_tpu_torch" / "kernels" / "csrc"
    out = root / "cruise_control_tpu_torch" / "_build" / "model_shard-ptxas.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [_build.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-I", str(csrc), "-o", str(out),
           str(csrc / "model_shard.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=600)
    lines, entry = [], None
    for line in (log.stdout + log.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def digest(t) -> np.ndarray:
    """The SHA-256 of a tensor's dtype, shape and bytes, as u8[32]."""
    a = t.cpu().numpy()
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


class Shards:
    """n shards of one engine's step on one card (chip_smoke.py's
    `ShardEmulation`, written against any tree's kernels module)."""

    def __init__(self, eng, carry, plan, n: int):
        import torch

        from cruise_control_tpu_torch.kernels import model_shard as ms_k
        from cruise_control_tpu_torch.kernels.group import group_placement
        from cruise_control_tpu_torch.parallel.model_shard import ShardPlan, shard_views

        s = eng.shape
        self.n = n
        self.blks = [ms_k.Block.of(s.R, s.P, j, n) for j in range(n)]
        self.views = [shard_views(eng.statics, carry, b) for b in self.blks]
        self.cols = [ms_k.row_columns(sx.state, c) for sx, c in self.views]
        groups = [group_placement(c.replica_broker, sx.state.replica_valid, s.B)
                  for sx, c in self.views]
        counts = torch.stack([gp.count for gp in groups])
        self.plans = [ShardPlan(
            broker_cdf=plan.broker_cdf, order=gp.order, start=gp.start, count=plan.count,
            count_local=gp.count, below=counts[:j].sum(0).to(torch.int32), start_global=plan.start,
            replica_cost=plan.replica_cost, lead_cost=plan.lead_cost) for j, gp in enumerate(groups)]


def hop_calls(eng, sh: Shards, cursor, ids, rows, parts) -> dict:
    """{hop: [shard j's call]}: each call returns shard j's bundle of the
    hop, from the assembled bundles of the hops before it."""
    import torch

    from cruise_control_tpu_torch.kernels import model_shard as ms_k

    cp, max_rf = eng.cand, eng.max_rf
    n_rs, pw = cp.K_r + 2 * cp.K_s, max_rf + eng.shape.num_racks
    n_l = cp.K_l
    merged = getattr(ms_k, "own_member_rows", None)

    def hop4(j):
        if merged is not None:
            return merged(parts, n_rs, max_rf, sh.cols[j], sh.blks[j])
        out = torch.empty(n_rs * max_rf + n_l * max_rf * ms_k.ROW_WORDS, dtype=torch.int32,
                          device=parts.device)
        ms_k.own_rows(parts, 1, sh.cols[j], sh.blks[j], m=max_rf, stride=pw, n=n_rs,
                      out=out[: n_rs * max_rf].view(-1, 1))
        ms_k.own_rows(parts[n_rs:], ms_k.ROW_WORDS, sh.cols[j], sh.blks[j], m=max_rf, stride=pw,
                      n=n_l, out=out[n_rs * max_rf:].view(-1, ms_k.ROW_WORDS))
        return out

    return dict(
        shard_sources=[lambda j=j: ms_k.shard_sources(cp, cursor, sh.plans[j], sh.views[j][0].gen,
                                                      sh.blks[j], True) for j in range(sh.n)],
        own_rows=[lambda j=j: ms_k.own_rows(ids, ms_k.ROW_WORDS, sh.cols[j], sh.blks[j])
                  for j in range(sh.n)],
        own_parts=[lambda j=j: ms_k.own_parts(rows.view(-1)[1:], int(ids.shape[0]), ms_k.ROW_WORDS,
                                              sh.views[j][0].part_replicas,
                                              sh.views[j][1].part_rack_count, sh.blks[j])
                   for j in range(sh.n)],
        hop4=[lambda j=j: hop4(j) for j in range(sh.n)],
    )


def _setup(tree: str, cards: int):
    """(root, this checkout's chip_smoke module, the card's nvidia-smi line)
    with DIR's package first on the path and its kernels built; None where
    the host lacks the cards or DIR is no checkout."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        print(f"time_model_shard: needs {cards} CUDA device(s)", file=sys.stderr)
        return None
    root = Path(tree).resolve()
    if not (root / "cruise_control_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"time_model_shard: {root} is not a checkout of the repository", file=sys.stderr)
        return None
    cs = _timing()
    sys.path.insert(0, str(root))
    from cruise_control_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()
    return root, cs, smi


def mesh(tree: str, out: str, spec: str) -> int:
    import time

    got = _setup(tree, 4)
    if got is None:
        return 2
    root, cs, smi = got
    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, OptimizerConfig
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.sharding import shard_multiple_shape
    from cruise_control_tpu_torch.parallel import ShardedEngine, close_rank_groups, model_mesh
    from cruise_control_tpu_torch.parallel.model_shard import loads_quantized
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    cfg = OptimizerConfig(**cs.SEARCH)
    state = random_cluster_fast(RandomClusterSpec(**getattr(cs, spec)), seed=42, device="cuda")
    st = pad_state(state, shard_multiple_shape(state.shape, 4))
    if spec == "NORTH_STAR_SPEC":
        st = loads_quantized(st, scale=1.0)
    del state
    t0 = time.monotonic()
    me = ShardedEngine(st, DEFAULT_CHAIN, mesh=model_mesh([f"cuda:{i}" for i in range(4)]),
                       config=cfg, timeout_s=900, model_shard_min_partitions=1)
    build_s = time.monotonic() - t0
    arrays, runs = {}, []
    try:
        for i in range(4):
            (final, hist, _o), wall = cs.mesh_run(me)
            steps = sum(1 for h in hist if "round" in h) * cfg.steps_per_round
            walls = me.last_info["rank_walls"]
            runs.append(dict(wall_s=wall, rank_walls=walls, steps=steps,
                             step_ms=max(walls) / steps * 1e3,
                             model_sharded=hist[-1].get("model_sharded")))
            for f in ("replica_broker", "replica_is_leader", "replica_disk"):
                arrays[f"run{i}/{f}"] = digest(getattr(final, f))
    finally:
        me.release()
        close_rank_groups()
    np.savez(out, **arrays)
    print(json.dumps({"tree": str(root), "card": smi, "mesh": "1x4", "spec": spec, "R": st.shape.R,
                      "build_s": build_s, "runs": runs}), flush=True)
    return 0


def main(tree: str, out: str, spec: str, brokers: int | None = None) -> int:
    import torch

    got = _setup(tree, 1)
    if got is None:
        return 2
    root, cs, smi = got
    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine, OptimizerConfig
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.kernels import candidates as cand_k
    from cruise_control_tpu_torch.kernels import model_shard as ms_k
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.sharding import shard_multiple_shape
    from cruise_control_tpu_torch.parallel.model_shard import loads_quantized
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    ptxas = ptxas_report(root)
    for line in ptxas:
        print("ptxas", line, flush=True)
    cfg = OptimizerConfig(**cs.SEARCH)
    shape = dict(getattr(cs, spec), **({} if brokers is None else {"num_brokers": brokers}))
    state = random_cluster_fast(RandomClusterSpec(**shape), seed=42, device="cuda")
    st = loads_quantized(pad_state(state, shard_multiple_shape(state.shape, 4)), scale=1.0)
    del state
    eng = Engine(st, DEFAULT_CHAIN, config=cfg)
    carry = eng.init_carry(Key.from_seed(cfg.seed))
    plan = eng.plan(carry)
    keys = cand_k.StepKeys.of(carry.key, intra=False, prior=False)
    cursor = cand_k.KeyCursor.of(keys, "cuda")
    arrays, times = {}, {}
    for f in ("replica_broker", "replica_partition", "replica_valid", "replica_is_leader"):
        arrays[f"state/{f}"] = digest(getattr(st, f))
    arrays["plan/broker_cdf"], arrays["plan/count"] = digest(plan.broker_cdf), digest(plan.count)
    for n in (2, 4):
        sh = Shards(eng, carry, plan, n)
        for j, sp in enumerate(sh.plans):
            for f in ("order", "start", "count_local", "below"):
                arrays[f"n{n}/j{j}/plan/{f}"] = digest(getattr(sp, f))
        bundles: dict = {}
        for hop in ("shard_sources", "own_rows", "own_parts", "hop4"):
            calls = hop_calls(eng, sh, cursor, bundles.get("shard_sources"),
                              bundles.get("own_rows"), bundles.get("own_parts"))[hop]
            parts = [fn() for fn in calls]
            for j, p in enumerate(parts):
                arrays[f"n{n}/j{j}/{hop}"] = digest(p)
            total = parts[0].clone()
            for p in parts[1:]:
                total += p
            bundles[hop] = total
            arrays[f"n{n}/assembled/{hop}"] = digest(total)
        torch.cuda.synchronize()
        calls = hop_calls(eng, sh, cursor, bundles["shard_sources"], bundles["own_rows"],
                          bundles["own_parts"])
        ids, mids = bundles["shard_sources"], bundles["own_parts"][:, :eng.max_rf]
        for j in (0, n - 1):
            blk = sh.blks[j]
            for hop in ("shard_sources", "own_rows", "hop4"):
                rec = cs.measure(calls[hop][j])
                owned = None if hop == "shard_sources" else cs.owned_rows(
                    ids if hop == "own_rows" else mids, blk)
                times[f"n{n}/j{j}/{hop}"] = dict(
                    ms=rec["ms"], own_kernel_ms=rec["own_kernel_ms"], call_ms=rec["call_ms"],
                    by_kernel=rec["by_kernel"], owned_rows=owned)
        kept = getattr(ms_k, "SOURCES_CDF_SMEM_MAX", None)
        for tag, gate in ((":global_cdf", 0), (":smem_cdf", 4 * eng.shape.B)):
            if kept is None:
                break
            ms_k.SOURCES_CDF_SMEM_MAX = gate
            try:
                got = calls["shard_sources"][0]()
                arrays[f"n{n}/j0/shard_sources{tag}"] = digest(got)
                rec = cs.measure(calls["shard_sources"][0])
                times[f"n{n}/j0/shard_sources{tag}"] = dict(
                    ms=rec["ms"], own_kernel_ms=rec["own_kernel_ms"], call_ms=rec["call_ms"],
                    by_kernel=rec["by_kernel"])
            finally:
                ms_k.SOURCES_CDF_SMEM_MAX = kept
    cp = eng.cand
    np.savez(out, **arrays)
    print(json.dumps({"tree": str(root), "card": smi, "spec": spec, "ptxas": ptxas, "R": eng.shape.R,
                      "B": eng.shape.B, "K": [cp.K_r, cp.K_s, cp.K_l],
                      "n_imp": [cp.n_imp(cp.K_r, plan), cp.n_imp(cp.K_s, plan)],
                      "slots": int(bundles["shard_sources"].shape[0]), "max_rf": eng.max_rf,
                      "times": times}), flush=True)
    return 0


def compare(paths: list[str]) -> int:
    """Byte-for-byte comparison of the dumps' arrays against the first's;
    a `:global_cdf` or `:smem_cdf` case is held against its case too."""
    ref = np.load(paths[0])
    report, ok = {}, True
    for p in paths[1:]:
        other = np.load(p)
        diff = [k for k in other.files if k not in ref.files or ref[k].tobytes() != other[k].tobytes()]
        diff += [k for k in other.files if ":" in k
                 and other[k].tobytes() != other[k.partition(":")[0]].tobytes()]
        missing = sorted(k for k in ref.files if k not in other.files)
        report[p] = dict(arrays=len(other.files), differ=sorted(diff), missing=missing)
        ok = ok and not diff and not missing
    print(json.dumps({"compare": paths[0], "identical": ok, "against": report}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--compare"]:
        sys.exit(compare(args[1:]))
    run = mesh if args[:1] == ["--mesh"] else main
    args = args[1:] if run is mesh else args
    if args[:1] == ["--target"]:
        sys.exit(run(*args[1:], "TARGET_SPEC"))
    if run is main and args[:1] == ["--brokers"]:
        sys.exit(main(*args[2:], "NORTH_STAR_SPEC", int(args[1])))
    sys.exit(run(*args, "NORTH_STAR_SPEC"))
