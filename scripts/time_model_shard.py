#!/usr/bin/env python3
"""Time the sharded-model mode's ownership gathers of one checkout on one GPU, and hold two checkouts' outputs byte for byte.

    python3 scripts/time_model_shard.py [--digest] [--target | --brokers N] DIR OUT.npz
    python3 scripts/time_model_shard.py --mesh [--target] DIR OUT.npz
    python3 scripts/time_model_shard.py --mesh --digest [--ranks N] [--target] DIR OUT.npz
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
With `--digest` it writes the digests alone (no ptxas, no timing): the
quick way to hold many fresh processes against each other.

The second form needs four cards: it runs DIR's sharded-model mode 1x4
over NCCL on the same padded north star with integer loads (chip_smoke.py
`--mesh` (c)), one run to start and three repeated runs, and prints each
run's wall as the caller sees it, each rank's wall and a step's ms (the
slowest rank's wall over the run's steps); the SHA-256 of each run's final
placement goes into OUT.npz, and the JSON line says whether the runs' placements
are identical.

The `--mesh --digest` form finds where two runs of the mode part.  It
spawns four ranks of its own over NCCL (one a card, DIR's
`ModelShardEngine` on each, as a rank group would build it) twice.  First
a probe, with NCCL_DEBUG=INFO set in its processes only (NCCL's log goes
beside OUT.npz): each rank sums one fixed float vector of the refresh's
size (a seeded partial a rank) PROBE_CALLS times through NCCL's own
all_reduce, then as many times through DIR's `all_reduce_sum`, and
counts the distinct results.  Then three runs on float loads (two of one
engine, one of a fresh engine), with every model-axis sum (its input and
output), the replicated aggregates and the shard's placement block after
each refresh, the plan's CDF and global counts, each step's four hop
bundles and survivors, and the chain's objective logged on every rank (a
digest each, a sync each: the script's cost, not the package's).  The
JSON line names the first event at which each later run parts from the
first on each rank (round, step, array, index, the two values where the
log kept them, and whether the sum's input still agreed), the events at
which the ranks of one run disagree, the probe's counts, and a control:
the single-device engine's three runs on the same cluster on cuda:0; the
final placements' digests go into OUT.npz.  `--ranks N` runs a model row
of N ranks (N cards) instead of 4; `--ranks 1` runs the mode's whole path
on one card.

With `--target` every form runs chip_smoke.py's TARGET_SPEC (25,000
brokers, 2,000,000 partitions) in place of the north star, padded the
same way; the second form then keeps the float loads, as chip_smoke.py
`--mesh` (d) does.  `--brokers N` runs the first form on the north star
with N brokers (the CDF's length, which decides where staging it pays).

The last form compares the files' arrays byte for byte, prints one JSON
line, and exits 1 on any difference.  The others need CUDA, nvcc and
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
                             model_sharded=hist[-1].get("model_sharded"),
                             float_sum_ms=me.last_info.get("float_sum_ms")))
            for f in ("replica_broker", "replica_is_leader", "replica_disk"):
                arrays[f"run{i}/{f}"] = digest(getattr(final, f))
    finally:
        me.release()
        close_rank_groups()
    np.savez(out, **arrays)
    finals = [np.concatenate([arrays[k] for k in sorted(arrays) if k.startswith(f"run{i}/")])
              for i in range(len(runs))]
    print(json.dumps({"tree": str(root), "card": smi, "mesh": "1x4", "spec": spec, "R": st.shape.R,
                      "build_s": build_s, "runs": runs,
                      "runs_identical": all(np.array_equal(f, finals[0]) for f in finals)}),
          flush=True)
    return 0


# ----------------------------------------------------------------------
# --mesh --digest: where two runs of the sharded-model mode part
# ----------------------------------------------------------------------

#: the float-sum probe's rounds (`--mesh --digest`)
PROBE_CALLS = 300


def _sha(t) -> bytes:
    a = t.detach().cpu().contiguous().numpy()
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode() + a.tobytes()).digest()


class _Recorder:
    """One rank's event log of a run: (name, round, step, digest of the
    input, digest of the output); small float and count arrays kept whole
    (`raw`, by event index) so that a difference can be read value by
    value."""

    def __init__(self):
        self.events: list = []
        self.raw: dict = {}
        self.where = "init"
        self.round = 0
        self.step = 0
        self.hop = 0

    def add(self, name: str, out, inp=None, keep: bool = False) -> None:
        if keep:
            self.raw[len(self.events)] = (None if inp is None else inp.detach().cpu().numpy().copy(),
                                          out.detach().cpu().numpy().copy())
        self.events.append((name, self.round, self.step,
                            b"" if inp is None else _sha(inp), _sha(out)))


def _instrument(eng, ms_mod, coll_mod, rec: _Recorder):
    """Wrap the engine's refresh, plan, gather_bundles, _survive_apply and
    evaluate, and the model-axis sums its modules call, to log into
    `rec` (each digest a sync: the script's own cost, not the package's)."""
    sums = coll_mod.all_reduce_sum

    def all_reduce_sum(t, group):
        inp = t.detach().clone()
        out = sums(t, group)
        if rec.where == "hops":
            name = f"hop{rec.hop}"
            rec.hop += 1
        elif rec.where == "refresh":
            name = "refresh_" + ("float" if t.is_floating_point() else "int")
        else:
            name = f"{rec.where}_sum_{t.dtype}"
        rec.add(name, out, inp, keep=rec.where != "hops" and (t.is_floating_point()
                                                              or t.numel() <= 1 << 14))
        return out

    ms_mod.all_reduce_sum = all_reduce_sum
    coll_mod.all_reduce_sum = all_reduce_sum

    def wrap(name, before, after):
        fn = getattr(eng, name)

        def call(*a, **k):
            prev = rec.where
            before(a)
            try:
                res = fn(*a, **k)
            finally:
                rec.where = prev
            after(a, res)
            return res

        setattr(eng, name, call)

    def refreshed(a, carry):
        for f in ("broker_load", "broker_potential_nw_out", "broker_leader_bytes_in", "disk_load",
                  "host_load", "broker_replica_count", "broker_leader_count", "broker_topic_count"):
            v = getattr(carry, f)
            rec.add(f"agg/{f}", v, keep=v.is_floating_point())
        for f in ("replica_broker", "replica_is_leader", "replica_disk", "part_rack_count"):
            rec.add(f"block/{f}", getattr(carry, f))
        rec.round += 1
        rec.step = 0

    def planned(a, plan):
        b = eng._shard_bufs()
        rec.add("plan/broker_cdf", plan.broker_cdf, keep=True)
        rec.add("plan/count_g", b["count_g"], keep=True)

    def hops(a):
        rec.where, rec.hop = "hops", 1

    def applied(a, res):
        rec.add("survivors", res[0])
        rec.step += 1

    wrap("refresh", lambda a: setattr(rec, "where", "refresh"), refreshed)
    wrap("plan", lambda a: setattr(rec, "where", "plan"), planned)
    wrap("gather_bundles", hops, lambda a, res: None)
    wrap("_survive_apply", lambda a: None, applied)
    wrap("evaluate", lambda a: setattr(rec, "where", "chain"),
         lambda a, res: rec.add("chain/objective", res[0].reshape(1), keep=True))


def _digest_rank(rank: int, world: int, init: str, root: str, spec: dict, config: dict,
                 out_dir: str, probe: bool, backend: str, log_dir: str) -> None:
    """One rank of the `--mesh --digest` form (module note): with `probe`
    the float-sum probe (NCCL's log into `log_dir`), else three runs of
    DIR's model shard with every event logged; a pickle a rank into
    `out_dir`."""
    import os
    import pickle

    sys.path.insert(0, root)
    cuda = backend == "nccl"
    if probe and cuda:
        os.environ.update(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT,TUNING",
                          NCCL_DEBUG_FILE=os.path.join(log_dir, "nccl_probe.%p.log"))
    import datetime

    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=900))
    from cruise_control_tpu_torch.common import collectives as coll_mod
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    out: dict = {}
    state = random_cluster_fast(RandomClusterSpec(**spec), seed=42, device=dev)
    if probe:
        # the refresh's float pack at this cluster's size, a seeded partial a rank
        words = state.shape.B * (6 + state.shape.max_disks_per_broker)
        rng = np.random.default_rng(1000 + rank)
        part = torch.from_numpy(rng.lognormal(0.0, 3.0, words).astype(np.float32)).to(dev)
        sums = coll_mod.all_reduce_sum
        for name, fn in (("all_reduce", lambda t: dist.all_reduce(t)),
                         ("all_reduce_sum", lambda t: sums(t, dist.group.WORLD))):
            seen: dict = {}
            for _ in range(PROBE_CALLS):
                t = part.clone()
                fn(t)
                d = _sha(t).hex()
                seen[d] = seen.get(d, 0) + 1
            out[name] = seen
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"probe{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        return
    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, OptimizerConfig
    from cruise_control_tpu_torch.analyzer.draws import Key
    from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS
    from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.sharding import shard_multiple_shape
    from cruise_control_tpu_torch.models.state import STATE_FIELDS, ClusterState
    from cruise_control_tpu_torch.parallel import model_shard as ms_mod

    st = pad_state(state, shard_multiple_shape(state.shape, world))
    host = ClusterState(**{f: getattr(st, f).cpu() for f in STATE_FIELDS}, shape=st.shape)
    del state, st
    out["fixture"] = [_sha(getattr(host, f)).hex() for f in STATE_FIELDS]
    cfg = OptimizerConfig(**config)
    runs = []
    for label in ("engine1_run1", "engine1_run2", "engine2_run1"):
        if label != "engine1_run2":
            eng = ms_mod.ModelShardEngine(host, DEFAULT_CHAIN, DEFAULT_CONSTRAINT, DEFAULT_OPTIONS,
                                          cfg, key=Key.from_seed(cfg.seed), shard=(rank, world),
                                          group=dist.group.WORLD, device=dev)
            rec = _Recorder()
            _instrument(eng, ms_mod, coll_mod, rec)
        rec.events, rec.raw, rec.round, rec.step, rec.where = [], {}, 0, 0, "init"
        final, hist, _ = eng._run_fused()
        runs.append(dict(label=label, events=list(rec.events), raw=dict(rec.raw),
                         final=[_sha(getattr(final, f)).hex() for f in
                                ("replica_broker", "replica_is_leader", "replica_disk")],
                         rounds=sum(1 for h in hist if "round" in h)))
    out["runs"] = runs
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _first_difference(a: dict, b: dict) -> dict | None:
    """The first event at which two runs' logs part, with its values where
    the log kept them."""
    for i, (ea, eb) in enumerate(zip(a["events"], b["events"])):
        if ea[4] == eb[4] and ea[0] == eb[0]:
            continue
        rec = dict(event=i, name=ea[0], round=ea[1], step=ea[2], name_b=eb[0],
                   same_input=bool(ea[3] == eb[3]) if ea[3] else None)
        if i in a["raw"] and i in b["raw"]:
            x, y = a["raw"][i][1].reshape(-1), b["raw"][i][1].reshape(-1)
            if x.shape == y.shape and x.dtype == y.dtype:
                # bit for bit, element by element
                xb, yb = x.view(np.uint8).reshape(x.size, -1), y.view(np.uint8).reshape(y.size, -1)
                at = np.flatnonzero((xb != yb).any(1))
                rec.update(differing=int(at.size), index=int(at[0]) if at.size else None,
                           values=[repr(x[at[0]].item()), repr(y[at[0]].item())] if at.size else None,
                           shape=list(a["raw"][i][1].shape))
        return rec
    if len(a["events"]) != len(b["events"]):
        return dict(event=min(len(a["events"]), len(b["events"])), name="(log length)",
                    lengths=[len(a["events"]), len(b["events"])])
    return None


def mesh_digest(tree: str, out: str, spec: str, world: int = 4, backend: str = "nccl",
                config: dict | None = None, spec_dict: dict | None = None) -> int:
    """`--mesh --digest`: the float-sum probe, then three runs of DIR's
    sharded-model mode 1x4 on float loads, each rank's events logged; one
    JSON line: the first event at which runs part, ranks that disagree
    within a run, the probe's distinct results."""
    import pickle
    import shutil
    import tempfile

    import torch.multiprocessing as tmp

    if backend == "nccl":
        got = _setup(tree, world)
        if got is None:
            return 2
        root, cs, smi = got
        spec_dict, config = getattr(cs, spec), cs.SEARCH
    else:
        root, smi = Path(tree).resolve(), None
        sys.path.insert(0, str(root))
    from cruise_control_tpu_torch.parallel.ranks import _free_port

    out_dir = Path(out).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="digest"))
    try:
        for probe in (True, False):
            tmp.spawn(_digest_rank, args=(world, f"tcp://127.0.0.1:{_free_port()}", str(root),
                                          spec_dict, config, str(work), probe, backend,
                                          str(out_dir)), nprocs=world)
        probes = [pickle.loads((work / f"probe{r}.pkl").read_bytes()) for r in range(world)]
        ranks = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(world)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    plain = _plain_runs(spec_dict, config, world) if backend == "nccl" else None
    probe = {}
    for name in ("all_reduce", "all_reduce_sum"):
        probe[name] = dict(distinct_per_rank=[len(p[name]) for p in probes],
                           ranks_agree=len({d for p in probes for d in p[name]}) == max(
                               len(p[name]) for p in probes),
                           calls=PROBE_CALLS)
    labels = [r["label"] for r in ranks[0]["runs"]]
    across = {}
    for k in range(1, len(labels)):
        across[f"{labels[0]}~{labels[k]}"] = [_first_difference(rk["runs"][0], rk["runs"][k])
                                              for rk in ranks]
    within = {}
    replicated = lambda n: not n.startswith("block/")  # noqa: E731
    for k, label in enumerate(labels):
        logs = [rk["runs"][k]["events"] for rk in ranks]
        bad = [i for i, evs in enumerate(zip(*logs)) if replicated(evs[0][0])
               and len({e[4] for e in evs}) > 1]
        within[label] = dict(events=len(logs[0]), ranks_disagree=len(bad),
                             first=None if not bad else dict(event=bad[0], name=logs[0][bad[0]][0],
                                                             round=logs[0][bad[0]][1],
                                                             step=logs[0][bad[0]][2]))
    finals = {label: [rk["runs"][k]["final"] for rk in ranks] for k, label in enumerate(labels)}
    arrays = {f"{label}/rank{r}/{f}": np.frombuffer(bytes.fromhex(d), np.uint8)
              for label, per in finals.items() for r, ds in enumerate(per)
              for f, d in zip(("replica_broker", "replica_is_leader", "replica_disk"), ds)}
    np.savez(out, **arrays)
    print(json.dumps({"tree": str(root), "card": smi, "mesh": f"1x{world}", "spec": spec,
                      "loads": "float", "fixture_same": len({tuple(r["fixture"]) for r in ranks}) == 1,
                      "rounds": [r["rounds"] for r in ranks[0]["runs"]],
                      "runs_identical": all(v == list(finals.values())[0] for v in finals.values()),
                      "probe": probe, "across_runs": across, "within_run": within,
                      "single_device": plain}), flush=True)
    return 0


def _plain_runs(spec: dict, config: dict, multiple: int) -> dict:
    """The control: the single-device engine on the same padded float-load
    cluster on cuda:0, two runs of one engine and one of a fresh engine,
    each final placement's digest."""
    import torch

    from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine, OptimizerConfig
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.sharding import shard_multiple_shape
    from cruise_control_tpu_torch.testing.fixtures import RandomClusterSpec, random_cluster_fast

    state = random_cluster_fast(RandomClusterSpec(**spec), seed=42, device="cuda:0")
    st = pad_state(state, shard_multiple_shape(state.shape, multiple))
    cfg = OptimizerConfig(**config)
    finals = []
    for fresh in (True, False, True):
        if fresh:
            eng = Engine(st, DEFAULT_CHAIN, config=cfg)
        final, _ = eng.run()
        finals.append(b"".join(_sha(getattr(final, f)) for f in
                               ("replica_broker", "replica_is_leader", "replica_disk")).hex())
    eng.release()
    torch.cuda.empty_cache()
    return dict(runs=["engine1_run1", "engine1_run2", "engine2_run1"], placements=finals,
                identical=len(set(finals)) == 1)


def main(tree: str, out: str, spec: str, brokers: int | None = None, timing: bool = True) -> int:
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

    ptxas = ptxas_report(root) if timing else []
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
        for j in (0, n - 1) if timing else ():
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
                if not timing:
                    continue
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
    opts, brokers, ranks = set(), None, 4
    while args and args[0].startswith("--"):
        if args[0] == "--brokers":
            brokers, args = int(args[1]), args[2:]
        elif args[0] == "--ranks":
            ranks, args = int(args[1]), args[2:]
        elif args[0] in ("--mesh", "--target", "--digest"):
            opts.add(args.pop(0))
        else:
            sys.exit(f"time_model_shard: unknown option {args[0]}")
    spec = "TARGET_SPEC" if "--target" in opts else "NORTH_STAR_SPEC"
    if "--mesh" in opts:
        if "--digest" in opts:
            sys.exit(mesh_digest(*args, spec, world=ranks))
        sys.exit(mesh(*args, spec))
    sys.exit(main(*args, spec, brokers, timing="--digest" not in opts))
