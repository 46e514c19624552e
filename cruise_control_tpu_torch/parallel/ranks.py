"""Rank groups: the port's counterpart of `jax.sharding.Mesh` and `jax.devices()`.

The JAX package drives every device of a mesh from one process.  The
PyTorch idiom is one process per device in a `ProcessGroup`, so the mesh
modes run on a *rank group*: N spawned rank processes (`torch.multiprocessing`,
spawn context), one per device, joined in one process group, NCCL on
`cuda:i` or gloo where the caller names the CPU.  The caller's process
joins no group: it sends every rank the same commands in the same order
(build or rebind an engine, run, run a schedule, release, probe) over one
pipe each, under one lock per group, so the ranks' collectives stay in
lockstep whichever thread of the caller asks, and a rank that dies cannot
take the caller with it.

A layout is a (restart, model) grid over a device list (`Layout`;
`model_mesh`, `default_mesh`, `grid_mesh` and `normalize_mesh` as the JAX
package's parallel/mesh.py:130-166 give them).  A rank group serves every
layout over its devices: each model width's row sub-groups are built once,
by every rank, with `dist.new_group` (`RankGroup.ensure_rows`).  One rank
group serves one device set in the process (`rank_group`), shared by every
engine on it, as the JAX package's optimizer shares one mesh per device set.

Bulk data crosses in shared memory: the caller sends CPU tensors in shared
memory, which the ranks map (torch.multiprocessing's reductions), and the
ranks write each chain's result placement into shared tensors the caller
allocated; only small values ride the pipes.

Failures are bounded and typed.  The caller watches every rank's process
sentinel beside its pipe, with a deadline a command: a rank that dies
raises `RankDiedError`, one that does not answer in time
`RankTimeoutError`, one whose command raised `RankCommandError`.  The group
is then torn down (every rank process killed and joined) and the next
`rank_group` call of the device set builds a new one; engines on the old
group rebuild themselves on it.

Each rank also serves a probe pipe on a thread of its own (`probe`): one
tiny op on its card, on a stream of its own, answered while the rank's
main thread may be blocked in a collective.  That is how a hung mesh run
is attributed to a card (common/device_watchdog.py `probe_devices`): the
surviving ranks answer, a stopped or wedged one does not.  The probe uses
the ranks' own CUDA contexts, so the caller makes none for it.  A command
deadline probes the ranks before it tears the group down, and the
`RankTimeoutError` carries the verdicts (`probe`).  The process groups are created with a
timeout, so a rank left in a collective whose peer died ends too.  No mesh
on the card falls back to gloo or the CPU: a CUDA device list asks for
NCCL, and a rank that cannot join raises.

The kernels are built before the spawn (`kernels/_build.py build()`), so
the ranks only load the libraries.

Reference analog: none (the reference optimizer is one Java thread).
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import logging
import os
import socket
import threading
import time
import traceback
from multiprocessing.connection import wait as _wait

log = logging.getLogger(__name__)

RESTART_AXIS = "restart"
MODEL_AXIS = "model"

#: seconds a rank group waits for its ranks to start (spawn, import, join)
START_TIMEOUT_S = 300.0
#: seconds a command waits for its answers when the caller gives none
COMMAND_TIMEOUT_S = 900.0
#: the process groups' own timeout: a collective whose peer is gone ends
PG_TIMEOUT_S = 300.0
#: the most seconds a command deadline's probe of the ranks takes
PROBE_TIMEOUT_S = 10.0


# ----------------------------------------------------------------------
# layouts
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layout:
    """A grid of devices over named axes, row-major: `devices[r * M + j]`
    is chain r's model shard j on a (restart, model) layout."""

    devices: tuple[str, ...]
    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)


def local_devices() -> list[str]:
    """Every card of this host: `cuda:0..N-1` (a CPU layout names its rank
    count: `cpu_devices`)."""
    import torch

    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def cpu_devices(n: int) -> list[str]:
    """n CPU ranks (gloo): the CPU never infers a rank count."""
    return ["cpu"] * int(n)


def _devices(devices) -> tuple[str, ...]:
    if devices is None:
        devices = local_devices()
    out = tuple(str(d) for d in devices)
    if not out:
        raise ValueError("a layout needs at least one device")
    return out


def model_mesh(devices=None) -> Layout:
    """1D candidate-sharding layout (the "sharded" parallel mode)."""
    d = _devices(devices)
    return Layout(d, (MODEL_AXIS,), (len(d),))


def default_mesh(devices=None) -> Layout:
    """1D restart-portfolio layout (one chain per device)."""
    d = _devices(devices)
    return Layout(d, (RESTART_AXIS,), (len(d),))


def grid_mesh(n_restarts: int, n_shards: int, devices=None) -> Layout:
    """2D (restart, model) layout: R chains, each candidate-sharded M ways."""
    d = _devices(devices)
    if len(d) < n_restarts * n_shards:
        raise ValueError(f"{len(d)} devices < {n_restarts}x{n_shards} grid")
    return Layout(d[: n_restarts * n_shards], (RESTART_AXIS, MODEL_AXIS), (n_restarts, n_shards))


def normalize_mesh(mesh: Layout) -> Layout:
    """Any supported layout -> the canonical 2D (restart, model) layout."""
    names = tuple(mesh.axis_names)
    if names == (RESTART_AXIS, MODEL_AXIS):
        return mesh
    if names == (MODEL_AXIS,):
        return Layout(mesh.devices, (RESTART_AXIS, MODEL_AXIS), (1, mesh.size))
    if names == (RESTART_AXIS,):
        return Layout(mesh.devices, (RESTART_AXIS, MODEL_AXIS), (mesh.size, 1))
    raise ValueError(
        f"mesh axes must be ({RESTART_AXIS!r},), ({MODEL_AXIS!r},) or "
        f"({RESTART_AXIS!r}, {MODEL_AXIS!r}); got {names}"
    )


# ----------------------------------------------------------------------
# typed failures
# ----------------------------------------------------------------------


class RankGroupError(RuntimeError):
    """A rank group failed; the group is torn down and the next call of its
    device set runs on a new one.  `rank` names the rank, when one is known;
    `devices` is the group's device list and `probe` the ranks' probe
    verdicts ({rank: None | diagnosis}) where the failure was probed."""

    def __init__(self, message: str, rank: int | None = None, *, devices=None, probe=None):
        super().__init__(message)
        self.rank = rank
        self.devices = tuple(devices) if devices is not None else None
        self.probe = probe


class RankDiedError(RankGroupError):
    """A rank process exited while the group was in use."""


class RankTimeoutError(RankGroupError):
    """A rank did not answer a command (or start) within its deadline."""


class RankCommandError(RankGroupError):
    """A rank's command raised; the message carries the rank's traceback."""


# ----------------------------------------------------------------------
# the rank process
# ----------------------------------------------------------------------


def _probe_server(conn, device: str) -> None:
    """A rank's probe thread: answer each probe with one tiny op on the
    rank's card (common/device_watchdog.py `_trivial_device_op`, on a
    stream of its own) until the pipe closes."""
    from cruise_control_tpu_torch.common.device_watchdog import _trivial_device_op

    while True:
        try:
            conn.recv()
        except (EOFError, OSError):
            return
        try:
            _trivial_device_op(device)
            reply = ("ok", None)
        except BaseException as e:  # noqa: BLE001 -- the verdict is the caller's
            reply = ("error", f"{type(e).__name__}: {e}")
        try:
            conn.send(reply)
        except (OSError, BrokenPipeError):
            return


def _rank_main(rank: int, world: int, device: str, backend: str, init_method: str,
               conn, pg_timeout_s: float, probe_conn=None) -> None:
    """A rank process: join the group, then serve commands until "exit"
    (and probes on `probe_conn`, on a thread of its own)."""
    t0 = time.monotonic()
    try:
        import torch
        import torch.distributed as dist

        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(torch.device(device))
        from cruise_control_tpu_torch.parallel.mesh import RankServer

        t_import = time.monotonic()
        kwargs = dict(backend=backend, init_method=init_method, world_size=world, rank=rank,
                      timeout=datetime.timedelta(seconds=pg_timeout_s))
        if device != "cpu":
            kwargs["device_id"] = torch.device(device)
        dist.init_process_group(**kwargs)
        server = RankServer(rank, world, device, pg_timeout_s)
        # one collective outside any capture initialises the communicator
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe)
        if device != "cpu":
            torch.cuda.synchronize()
        check = float(probe.item())
        if probe_conn is not None:
            threading.Thread(target=_probe_server, args=(probe_conn, device), daemon=True,
                             name="rank-probe").start()
        conn.send(("ready", dict(rank=rank, pid=os.getpid(), import_s=t_import - t0,
                                 join_s=time.monotonic() - t_import, world_sum=check,
                                 backend=dist.get_backend())))
    except BaseException as e:  # noqa: BLE001 -- reported to the caller, then exit
        try:
            conn.send(("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
        finally:
            os._exit(1)
    while True:
        try:
            cmd, args = conn.recv()
        except EOFError:
            break
        if cmd == "exit":
            break
        try:
            reply = server.handle(cmd, args)
            conn.send(("ok", reply))
        except BaseException as e:  # noqa: BLE001 -- the caller tears the group down
            try:
                conn.send(("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
            except BaseException:  # noqa: BLE001
                pass
    try:
        import torch.distributed as dist

        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- exiting anyway
        pass
    conn.close()
    os._exit(0)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


class RankGroup:
    """N rank processes over `devices` (one each), one process group.

    `call(cmd, args, ranks=)` sends one command to each named rank (all by
    default) and returns their answers in rank order; the group's lock
    serialises commands.  Any failure raises a `RankGroupError` and closes
    the group (`alive` False)."""

    _ids = itertools.count()

    def __init__(self, devices, *, pg_timeout_s: float = PG_TIMEOUT_S,
                 start_timeout_s: float = START_TIMEOUT_S):
        self.devices = _devices(devices)
        kinds = {d.split(":")[0] for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(f"a rank group runs on one kind of device, got {self.devices}")
        self.kind = kinds.pop()
        if self.kind == "cuda" and len(set(self.devices)) != len(self.devices):
            raise ValueError(f"one rank a card: {self.devices}")
        self.backend = "gloo" if self.kind == "cpu" else "nccl"
        self.world = len(self.devices)
        self.pg_timeout_s = float(pg_timeout_s)
        self.id = next(RankGroup._ids)
        self.lock = threading.RLock()
        self.alive = False
        self._procs: list = []
        self._conns: list = []
        self._probes: list = []
        self._probe_lock = threading.Lock()
        self._rows: set[int] = set()
        #: start-up seconds: spawn to every rank ready, and each rank's
        #: import and join seconds
        self.start_info: dict = {}
        self._start(start_timeout_s)

    # -- life ---------------------------------------------------------------

    def _start(self, timeout_s: float) -> None:
        import torch.multiprocessing as tmp

        if self.kind == "cuda":
            import torch

            if not torch.cuda.is_available() or torch.cuda.device_count() < self.world:
                raise RankGroupError(
                    f"{self.world} CUDA ranks asked, {torch.cuda.device_count()} cards visible")
            import torch.distributed as dist

            if not dist.is_nccl_available():
                raise RankGroupError("NCCL is not available: a mesh on the card runs over NCCL only")
            from cruise_control_tpu_torch.kernels import _build

            _build.build()  # the ranks only load the libraries
        ctx = tmp.get_context("spawn")
        init = f"tcp://127.0.0.1:{_free_port()}"
        t0 = time.monotonic()
        for rank, dev in enumerate(self.devices):
            parent, child = ctx.Pipe(duplex=True)
            probe_parent, probe_child = ctx.Pipe(duplex=True)
            p = ctx.Process(target=_rank_main, args=(rank, self.world, dev, self.backend, init,
                                                     child, self.pg_timeout_s, probe_child),
                            daemon=True, name=f"cc-rank-{self.id}-{rank}")
            p.start()
            child.close()
            probe_child.close()
            self._procs.append(p)
            self._conns.append(parent)
            self._probes.append(probe_parent)
        self.alive = True
        ready = self._collect(list(range(self.world)), timeout_s, "start")
        self.start_info = dict(start_s=time.monotonic() - t0, backend=self.backend,
                               ranks=self.world, devices=list(self.devices),
                               import_s=max(r["import_s"] for r in ready),
                               join_s=max(r["join_s"] for r in ready))
        if any(r["world_sum"] != float(self.world) for r in ready):
            self.close()
            raise RankGroupError(f"the group's first all_reduce gave {ready}")

    def close(self) -> None:
        """Stop every rank (an "exit" command, then a kill after a grace
        period) and join them.  Idempotent."""
        with self.lock:
            was = self.alive
            self.alive = False
            for c in self._conns:
                try:
                    if was:
                        c.send(("exit", None))
                except (OSError, BrokenPipeError, ValueError):
                    pass
            deadline = time.monotonic() + (5.0 if was else 0.0)
            for p in self._procs:
                p.join(max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join(10.0)
            for c in self._conns + self._probes:
                try:
                    c.close()
                except OSError:
                    pass
            self._procs, self._conns, self._probes = [], [], []

    def abort(self) -> None:
        """Kill every rank now, without the command lock (a caller abandoned
        at a deadline may hold it, waiting on the ranks): the group is
        closed, and the waiting command sees the ranks die and returns."""
        self.alive = False
        for p in list(self._procs):
            if p.is_alive():
                p.kill()

    def probe(self, timeout_s: float = 20.0) -> dict:
        """{rank: None | diagnosis}: each rank's probe thread runs one tiny
        op on its card; the probes go out together and share one budget.
        A rank that does not answer in time, or whose pipe is gone, is
        named with its diagnosis."""
        with self._probe_lock:
            out: dict[int, str | None] = {}
            pending = {}
            for r, c in enumerate(self._probes):
                try:
                    c.send("probe")
                    pending[c] = r
                except (OSError, BrokenPipeError, ValueError) as e:
                    out[r] = f"rank {r} ({self.devices[r]}) cannot take a probe: {e}"
            deadline = time.monotonic() + timeout_s
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                for c in _wait(list(pending), timeout=left):
                    r = pending.pop(c)
                    try:
                        status, diag = c.recv()
                    except (EOFError, OSError) as e:
                        out[r] = f"rank {r} ({self.devices[r]}) closed its probe pipe: {e!r}"
                        continue
                    out[r] = None if status == "ok" else f"rank {r} ({self.devices[r]}) probe failed: {diag}"
            for c, r in pending.items():
                out[r] = (f"rank {r} ({self.devices[r]}) unresponsive: the probe did not answer "
                          f"in {timeout_s:.1f} s")
                # a late answer must not be read as the next probe's
                try:
                    c.close()
                except OSError:
                    pass
                self._probes[r] = _ClosedPipe()
            return dict(sorted(out.items()))

    def kill_rank(self, rank: int) -> None:
        """Kill one rank process (the fault tests' and chip_smoke's device
        loss); the next command finds it dead."""
        self._procs[rank].kill()
        self._procs[rank].join(10.0)

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    # -- commands -----------------------------------------------------------

    def _fail(self, exc: RankGroupError):
        log.warning("rank group %d torn down: %s", self.id, exc)
        # no grace period: the other ranks may wait in a collective on the
        # one that failed, and would not read an "exit"
        self.abort()
        self.close()
        raise exc

    def _collect(self, ranks: list[int], timeout_s: float, what: str) -> list:
        answers: dict[int, object] = {}
        deadline = time.monotonic() + timeout_s
        by_conn = {self._conns[r]: r for r in ranks}
        by_sentinel = {self._procs[r].sentinel: r for r in range(self.world)}
        while len(answers) < len(ranks):
            left = deadline - time.monotonic()
            if left <= 0:
                missing = [r for r in ranks if r not in answers]
                # probe before the teardown: the ranks that answer are alive,
                # the silent ones are what stalled the command
                verdicts = self.probe(min(PROBE_TIMEOUT_S, max(1.0, timeout_s)))
                self._fail(RankTimeoutError(
                    f"rank(s) {missing} did not answer {what!r} within {timeout_s:.1f} s; "
                    f"probes: {verdicts}", missing[0], devices=self.devices, probe=verdicts))
            pending = [c for c, r in by_conn.items() if r not in answers]
            ready = _wait(pending + list(by_sentinel), timeout=left)
            for obj in ready:
                if obj in by_conn:
                    r = by_conn[obj]
                    try:
                        status, payload = obj.recv()
                    except (EOFError, OSError):
                        self._fail(RankDiedError(f"rank {r} closed its pipe during {what!r}", r,
                                                 devices=self.devices))
                    if status == "error":
                        self._fail(RankCommandError(f"rank {r} failed {what!r}: {payload}", r,
                                                    devices=self.devices))
                    answers[r] = payload
                else:
                    # a rank exits only on "exit": any other end is a death
                    r = by_sentinel[obj]
                    self._fail(RankDiedError(
                        f"rank {r} (pid {self._procs[r].pid}, {self.devices[r]}) exited with "
                        f"code {self._procs[r].exitcode} during {what!r}", r, devices=self.devices))
        return [answers[r] for r in ranks]

    def call(self, cmd: str, args=None, *, ranks=None, per_rank=None,
             timeout_s: float | None = None) -> list:
        """Send `cmd` to `ranks` (all when None) with `args`, or with
        `per_rank[i]` to the i-th of them; return the answers in order."""
        ranks = list(range(self.world)) if ranks is None else list(ranks)
        with self.lock:
            if not self.alive:
                raise RankGroupError(f"rank group {self.id} is closed")
            for i, r in enumerate(ranks):
                try:
                    self._conns[r].send((cmd, args if per_rank is None else per_rank[i]))
                except (OSError, BrokenPipeError) as e:
                    self._fail(RankDiedError(f"rank {r} cannot take {cmd!r}: {e}", r,
                                             devices=self.devices))
            return self._collect(ranks, COMMAND_TIMEOUT_S if timeout_s is None else timeout_s,
                                 cmd)

    def ensure_rows(self, n_model: int) -> None:
        """Every rank builds the row sub-groups of model width n_model (rows
        of n_model consecutive ranks), once per width: `dist.new_group` is
        collective over the whole world."""
        with self.lock:
            if n_model in self._rows:
                return
            self.call("rows", n_model)
            self._rows.add(n_model)


class _ClosedPipe:
    """The probe pipe of a rank whose last probe went unanswered: every
    later probe is refused at once."""

    def send(self, _):
        raise OSError("the rank's probe pipe was closed after an unanswered probe")

    def close(self) -> None:
        pass


def device_ids(devices) -> list[int]:
    """The ids a mesh failure names (common/device_watchdog.py): a card's
    index (cuda:i -> i); a CPU rank's position in the list."""
    return [int(d.split(":")[1]) if str(d).startswith("cuda:") else i
            for i, d in enumerate(devices)]


_GROUPS: dict[tuple[str, ...], RankGroup] = {}
_GROUPS_LOCK = threading.Lock()


def rank_group(devices, **kwargs) -> RankGroup:
    """The live rank group of this device set (or of a larger set that
    starts with it: a layout's ranks are the group's first ones), started
    on first use and again after a failure closed the previous one."""
    key = _devices(devices)
    with _GROUPS_LOCK:
        g = _GROUPS.get(key)
        if g is None or not g.alive:
            # a live group whose devices start with these serves them too
            g = next((h for k, h in _GROUPS.items() if h.alive and k[: len(key)] == key), None)
        if g is None:
            g = RankGroup(key, **kwargs)
            _GROUPS[key] = g
        return g


def live_group(devices) -> RankGroup | None:
    """The live rank group serving this device set (its own or a larger
    one that starts with it), None when there is none."""
    key = _devices(devices)
    with _GROUPS_LOCK:
        for k, g in _GROUPS.items():
            if g.alive and k[: len(key)] == key:
                return g
    return None


def abort_groups_with(ids) -> list[tuple[str, ...]]:
    """Kill every live rank group one of whose devices has an id in `ids`
    (`device_ids`): a group with a lost or stalled card cannot serve
    another command.  Returns their device sets."""
    bad = set(int(i) for i in ids)
    out = []
    with _GROUPS_LOCK:
        groups = [(k, g) for k, g in _GROUPS.items() if g.alive]
    for k, g in groups:
        if bad & set(device_ids(k)):
            g.abort()
            out.append(k)
    return out


def close_rank_groups() -> None:
    """Stop every rank group of the process."""
    with _GROUPS_LOCK:
        groups = list(_GROUPS.values())
        _GROUPS.clear()
    for g in groups:
        g.close()
