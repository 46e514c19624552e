"""Lease-sharded cluster ownership — the fleet HA coordination layer.

M tpu-cruise instances jointly serve one `fleet.clusters` set; a cluster
is only ever EXECUTED AGAINST by the instance currently holding its
lease.  The reference Cruise Control's core promise is that the
rebalancer never makes the cluster worse — two executors racing the same
Kafka cluster after a network partition or a stalled process breaks
exactly that, so every mutation is fenced by the lease's epoch.

Three pieces:

  * `FileLeaseStore` — the pluggable `LeaseStore` contract's file-backed
    implementation, living in the executor journal directory (the one
    piece of shared durable state a fleet already has).  Same primitives
    as the prewarm manifest merge (PR 10): an OS file lock (`flock`)
    around every read-modify-write, atomic `os.replace` publication.
    Each lease carries a monotonically increasing `epoch` — the fencing
    token — and every grant/renewal/release lands in an append-only
    audit trail (`audit.jsonl`) from which the single-holder invariant
    is mechanically checkable (`single_holder_violations`).
  * `Fence` — the per-(cluster, instance) validity token the execution
    path consults.  `check()` is TIME-BASED, not event-based: even when
    the renewal thread itself is the thing that stalled (the zombie
    scenario), a late journal append or admin mutation hits
    `now > deadline - skew_slack` and raises `FencedError` — the fence
    steps down strictly BEFORE the store would grant a takeover at
    `deadline + skew_slack`, so bounded clock skew cannot create two
    writers.
  * `LeaseManager` — one per instance: acquisition, renewal heartbeats
    on a background thread, expiry-based takeover of unowned clusters,
    and loss detection, all on an injected clock (`testing/faults.py
    clock_skew` swaps it per instance).

Safety argument (why at most one holder per cluster at any instant):
the store only re-grants a cluster once `now > deadline + skew_slack`
on the ACQUIRER's clock; the holder's fence self-revokes once
`now > deadline - skew_slack` on the HOLDER's clock.  With per-instance
clock error bounded by `skew_slack/2` each (config
`fleet.ha.skew.slack.s`), the fence is dead before the takeover is
possible, and the epoch bump fences any write that raced the handover.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time

log = logging.getLogger(__name__)


class FencedError(RuntimeError):
    """A journal append or cluster mutation carried a stale (or absent)
    lease epoch: this instance no longer owns the cluster.  The executor
    aborts its batch cleanly — the try/finally throttle guard makes the
    abort leak-free, and the NEW holder's restart reconciliation adopts
    whatever was in flight."""


@dataclasses.dataclass(frozen=True)
class Lease:
    """One cluster's ownership grant.  `epoch` is the fencing token: it
    increases monotonically across every grant, so any write stamped
    with an older epoch is provably from a deposed holder.  `deadline`
    is in the granting instance's clock (seconds); readers compare it
    against their own clock plus/minus the configured skew slack."""

    cluster_id: str
    holder_id: str
    epoch: int
    deadline: float
    #: this grant displaced another holder's expired, unreleased lease
    #: (accounting only; set by the store, which decides under its lock)
    takeover: bool = False


class LeaseStore:
    """Pluggable lease persistence contract.  Implementations must make
    `acquire` exclusive (no grant while another holder's lease is live
    within skew slack) and `epoch` monotonic per cluster."""

    def acquire(self, cluster_id: str, holder_id: str, ttl_s: float) -> Lease | None:
        raise NotImplementedError

    def renew(self, lease: Lease, ttl_s: float) -> Lease | None:
        raise NotImplementedError

    def release(self, lease: Lease) -> None:
        raise NotImplementedError

    def read(self, cluster_id: str) -> Lease | None:
        raise NotImplementedError


class FileLeaseStore(LeaseStore):
    """Lease files in a shared directory (the executor journal dir):
    one `<cluster_id>.lease.json` per cluster, every read-modify-write
    under ONE `flock`'d lock file, every publication an atomic
    `os.replace` — the exact primitives the prewarm manifest merge
    already relies on, so the durability story is the journal dir's.

    The audit trail (`audit.jsonl`, appended under the same lock) records
    every grant with the displaced lease's deadline, which makes the
    single-holder invariant checkable after the fact without trusting
    the instances themselves (`single_holder_violations`).
    """

    def __init__(self, directory: str, *, skew_slack_s: float = 2.0, clock=None):
        self.dir = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.dir, exist_ok=True)
        self.skew_slack_s = float(skew_slack_s)
        #: injected clock (seconds float) — testing/faults.py clock_skew
        #: swaps this attribute per instance
        self.clock = clock or time.time
        self._lock_path = os.path.join(self.dir, ".lock")
        self._audit_path = os.path.join(self.dir, "audit.jsonl")
        self._thread_lock = threading.Lock()
        #: once-per-store warning state for a failed/unavailable flock
        self._flock_warn = {"warned": False}

    # ------------------------------------------------------------ files

    def _lease_path(self, cluster_id: str) -> str:
        return os.path.join(self.dir, f"{cluster_id}.lease.json")

    def _read_raw(self, cluster_id: str) -> dict | None:
        try:
            with open(self._lease_path(cluster_id), encoding="utf-8") as f:
                d = json.load(f)
        except (OSError, ValueError):
            # missing file = never leased; corrupt cannot happen from our
            # own writes (atomic replace) — treat as absent
            return None
        return d if isinstance(d, dict) and "epoch" in d else None

    def _write_raw(self, cluster_id: str, d: dict) -> None:
        path = self._lease_path(cluster_id)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(d, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    #: rotate the audit trail past this size (renewal heartbeats append
    #: forever; one rotated generation is kept, so the invariant checker
    #: still sees a deep recent history without unbounded growth)
    AUDIT_MAX_BYTES = 4 * 1024 * 1024

    def _audit(self, event: str, cluster_id: str, d: dict) -> None:
        rec = dict(d, event=event, cluster=cluster_id, t=self.clock())
        with open(self._audit_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
            size = f.tell()
        if size > self.AUDIT_MAX_BYTES:
            # runs under the store lock (every _audit caller holds it)
            try:
                os.replace(self._audit_path, self._audit_path + ".1")
            except OSError:
                pass

    def _locked(self):
        """Cross-process + cross-thread exclusion around one
        read-modify-write (flock where available, like the prewarm
        manifest merge; a platform without flock degrades to
        thread-level exclusion — logged LOUDLY once, because on the
        shared mount HA targets that degradation means cross-process
        exclusion is gone)."""
        return _StoreLock(self._lock_path, self._thread_lock,
                          self._flock_warn)

    # --------------------------------------------------------- contract

    def acquire(self, cluster_id: str, holder_id: str, ttl_s: float) -> Lease | None:
        with self._locked():
            now = self.clock()
            cur = self._read_raw(cluster_id)
            live = (
                cur is not None
                and not cur.get("released")
                and now <= cur["deadline"] + self.skew_slack_s
            )
            if live and cur["holder"] != holder_id:
                return None
            # a missing/corrupt lease file must not reset the fencing
            # token: fall back to the audit trail's highest epoch
            epoch = (cur["epoch"] if cur else self._epoch_floor(cluster_id)) + 1
            takeover = bool(cur and not cur.get("released")
                            and cur["holder"] != holder_id)
            d = {"holder": holder_id, "epoch": epoch, "deadline": now + ttl_s}
            self._write_raw(cluster_id, d)
            self._audit(
                "acquired", cluster_id,
                dict(
                    d,
                    takeover=takeover,
                    slack=self.skew_slack_s,
                    prev_holder=cur["holder"] if cur else None,
                    prev_deadline=cur["deadline"] if cur else None,
                    prev_released=bool(cur.get("released")) if cur else True,
                ),
            )
            return Lease(cluster_id, holder_id, epoch, d["deadline"],
                         takeover=takeover)

    def renew(self, lease: Lease, ttl_s: float) -> Lease | None:
        with self._locked():
            cur = self._read_raw(lease.cluster_id)
            if (
                cur is None
                or cur.get("released")
                or cur["holder"] != lease.holder_id
                or cur["epoch"] != lease.epoch
            ):
                return None  # fenced: the cluster moved on without us
            d = {
                "holder": lease.holder_id,
                "epoch": lease.epoch,
                "deadline": self.clock() + ttl_s,
            }
            self._write_raw(lease.cluster_id, d)
            self._audit("renewed", lease.cluster_id, d)
            return Lease(lease.cluster_id, lease.holder_id, lease.epoch,
                         d["deadline"])

    def release(self, lease: Lease) -> None:
        with self._locked():
            cur = self._read_raw(lease.cluster_id)
            if (
                cur is None
                or cur["holder"] != lease.holder_id
                or cur["epoch"] != lease.epoch
            ):
                return  # already superseded; nothing of ours to release
            d = dict(cur, released=True)
            self._write_raw(lease.cluster_id, d)
            self._audit("released", lease.cluster_id, d)

    def read(self, cluster_id: str) -> Lease | None:
        cur = self._read_raw(cluster_id)
        if cur is None or cur.get("released"):
            return None
        return Lease(cluster_id, cur["holder"], cur["epoch"], cur["deadline"])

    # ------------------------------------------------------------ audit

    def audit_events(self) -> list[dict]:
        """Decode the audit trail — the rotated generation first, then
        the live file (torn tails tolerated, like the journal)."""
        events: list[dict] = []
        for path in (self._audit_path + ".1", self._audit_path):
            try:
                with open(path, encoding="utf-8", errors="replace") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            events.append(json.loads(line))
                        except ValueError:
                            break
            except OSError:
                continue
        return events

    def _epoch_floor(self, cluster_id: str) -> int:
        """Highest epoch the audit trail remembers for a cluster — the
        fencing floor when the lease file itself is missing/corrupt.  A
        lost lease file must not reset epochs below records already
        stamped into execution journals (replay's high-water filter
        would then drop the NEW holder's legitimate writes as zombie
        writes)."""
        floor = 0
        for e in self.audit_events():
            if e.get("cluster") == cluster_id and isinstance(e.get("epoch"), int):
                floor = max(floor, e["epoch"])
        return floor


class _StoreLock:
    """flock(lock file) + thread lock; releases both on exit.  A failed
    flock (ENOLCK on an NFS mount without lockd, unopenable lock file)
    degrades to thread-level exclusion and WARNS once per store: losing
    cross-process exclusion silently would be losing the single-holder
    guarantee silently."""

    def __init__(self, path: str, thread_lock: threading.Lock, warn_state: dict):
        self.path = path
        self.thread_lock = thread_lock
        self.warn_state = warn_state
        self._f = None

    def _warn_once(self, why: str):
        if not self.warn_state.get("warned"):
            self.warn_state["warned"] = True
            log.warning(
                "lease store %s: cross-process file lock unavailable (%s) — "
                "falling back to thread-level exclusion; multiple instances "
                "sharing this directory are NOT mutually excluded during "
                "lease read-modify-writes", self.path, why,
            )

    def __enter__(self):
        self.thread_lock.acquire()
        try:
            self._f = open(self.path, "a+")  # noqa: SIM115 — held for the flock
            try:
                import fcntl

                fcntl.flock(self._f.fileno(), fcntl.LOCK_EX)
            except Exception as e:  # noqa: BLE001 — no flock: thread-level only
                self._warn_once(repr(e))
        except OSError as e:
            self._f = None
            self._warn_once(repr(e))
        return self

    def __exit__(self, *exc):
        if self._f is not None:
            self._f.close()  # closing releases the flock
            self._f = None
        self.thread_lock.release()
        return False


def single_holder_violations(events: list[dict], *, skew_slack_s: float = 0.0) -> list[str]:
    """Check the at-most-one-holder invariant against a store's audit
    trail: per cluster, every grant that displaces a DIFFERENT unreleased
    holder must happen strictly after that holder's last granted deadline
    PLUS the skew slack (the zone where the two-sided safety argument
    still allows the old fence to be live), and epochs must be strictly
    increasing.  The slack comes from each acquire event's recorded
    `slack` (the store stamps its configured value); `skew_slack_s` is
    the fallback for trails written before the stamp existed.  Returns
    human-readable violations (empty = invariant held)."""
    out: list[str] = []
    last_epoch: dict[str, int] = {}
    for e in events:
        cid = e.get("cluster")
        if e.get("event") == "acquired":
            if cid in last_epoch and e["epoch"] <= last_epoch[cid]:
                out.append(
                    f"{cid}: epoch {e['epoch']} not above {last_epoch[cid]}"
                )
            slack = e.get("slack", skew_slack_s)
            if (
                e.get("takeover")
                and e.get("prev_deadline") is not None
                and e["t"] <= e["prev_deadline"] + slack
            ):
                out.append(
                    f"{cid}: takeover by {e['holder']} at t={e['t']:.3f} while "
                    f"{e.get('prev_holder')}'s lease ran to "
                    f"{e['prev_deadline']:.3f} (+{slack:.3f} slack)"
                )
        if "epoch" in e and cid is not None:
            last_epoch[cid] = max(last_epoch.get(cid, 0), e["epoch"])
    return out


class Fence:
    """Per-(cluster, instance) fencing token the execution path consults.

    `check()` gates every journal append and admin mutation; it is valid
    only while (a) a lease epoch is granted AND (b) the instance clock
    has not run past `deadline - skew_slack` — so a stalled renewal
    thread revokes the fence by TIME, not by code that may never run."""

    def __init__(self, cluster_id: str, manager: "LeaseManager"):
        self.cluster_id = cluster_id
        self.manager = manager
        self._lock = threading.Lock()
        self._epoch: int | None = None
        self._valid_until = float("-inf")

    @property
    def epoch(self) -> int | None:
        with self._lock:
            return self._epoch

    @property
    def held(self) -> bool:
        with self._lock:
            return (
                self._epoch is not None
                and self.manager.clock() <= self._valid_until
            )

    def check(self, op: str = "") -> int:
        """Raise FencedError unless this instance currently owns the
        cluster; returns the live epoch for stamping."""
        with self._lock:
            if self._epoch is None:
                raise FencedError(
                    f"{self.cluster_id}: no lease held"
                    + (f" (op={op})" if op else "")
                )
            if self.manager.clock() > self._valid_until:
                raise FencedError(
                    f"{self.cluster_id}: lease epoch {self._epoch} expired "
                    f"past skew slack" + (f" (op={op})" if op else "")
                )
            return self._epoch

    def _grant(self, epoch: int, deadline: float) -> None:
        with self._lock:
            self._epoch = epoch
            self._valid_until = deadline - self.manager.skew_slack_s

    def _revoke(self) -> None:
        with self._lock:
            self._epoch = None
            self._valid_until = float("-inf")


class LeaseManager:
    """One per service instance: owns this instance's view of every
    cluster's lease — acquisition, renewal heartbeats, expiry-based
    takeover, loss detection — and the fences the execution path checks.

    Callbacks (`on_acquired(cluster_id, lease, takeover)`,
    `on_lost(cluster_id, lease)`) run on the heartbeat thread AFTER the
    fence state has changed, so activation code runs fenced-in and
    step-down code runs fenced-out."""

    def __init__(
        self,
        store: LeaseStore,
        cluster_ids,
        *,
        holder_id: str,
        ttl_s: float = 30.0,
        renew_s: float = 10.0,
        skew_slack_s: float = 2.0,
        clock=None,
        sensors=None,
        on_acquired=None,
        on_lost=None,
    ):
        if skew_slack_s >= ttl_s / 2:
            raise ValueError(
                f"fleet.ha.skew.slack.s={skew_slack_s} must be below half "
                f"the ttl ({ttl_s}) — the fence window would be empty"
            )
        if renew_s >= ttl_s - skew_slack_s:
            # the fence self-revokes at deadline - slack: a heartbeat
            # slower than that window guarantees the RIGHTFUL holder's
            # fence expires between successful renewals, turning every
            # mid-batch append into a spurious fenced abort
            raise ValueError(
                f"fleet.ha.renew.s={renew_s} must be below "
                f"fleet.ha.lease.ttl.s - fleet.ha.skew.slack.s "
                f"({ttl_s} - {skew_slack_s}): the fence is only valid to "
                "deadline - slack, so renewals must land inside that window"
            )
        self.store = store
        self.holder_id = holder_id
        self.ttl_s = float(ttl_s)
        self.renew_s = float(renew_s)
        self.skew_slack_s = float(skew_slack_s)
        #: injected clock (seconds float) — clock_skew patches this
        self.clock = clock or time.time
        self.sensors = sensors
        self.on_acquired = on_acquired
        self.on_lost = on_lost
        self.fences: dict[str, Fence] = {
            cid: Fence(cid, self) for cid in cluster_ids
        }
        self._leases: dict[str, Lease] = {}
        #: last peer holder observed per cluster ((holder_id, epoch)) —
        #: refreshed by the HEARTBEAT thread so the /fleet request path
        #: never blocks on the (possibly partitioned) store
        self._peer_view: dict[str, tuple[str, int]] = {}
        #: per-cluster re-acquisition cooldown deadlines (instance clock)
        #: set by relinquish() so a flapping activation backs off
        self._cooldown_until: dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if sensors is not None:
            sensors.gauge("fleet.ha.owned-clusters",
                          lambda: len(self.owned_clusters()))

    # ------------------------------------------------------------ state

    def fence(self, cluster_id: str) -> Fence:
        return self.fences[cluster_id]

    def lease(self, cluster_id: str) -> Lease | None:
        with self._lock:
            return self._leases.get(cluster_id)

    def owns(self, cluster_id: str) -> bool:
        return self.fences[cluster_id].held

    def owned_clusters(self) -> list[str]:
        return [cid for cid, f in self.fences.items() if f.held]

    def _count(self, name: str, n: int = 1) -> None:
        if self.sensors is not None:
            self.sensors.counter(name).inc(n)

    # -------------------------------------------------------- heartbeat

    def poll_once(self) -> None:
        """One heartbeat pass: renew held leases, attempt takeover of
        unowned clusters, detect losses.  Runs on the background thread;
        tests drive it directly with injected clocks."""
        for cid, fence in self.fences.items():
            with self._lock:
                lease = self._leases.get(cid)
            if lease is not None:
                self._renew_one(cid, fence, lease)
            else:
                self._acquire_one(cid, fence)

    def _renew_one(self, cid: str, fence: Fence, lease: Lease) -> None:
        if self._stop.is_set():
            return  # shutting down: stop() owns the lease's fate now
        try:
            renewed = self.store.renew(lease, self.ttl_s)
        except Exception:  # noqa: BLE001 — store partition: keep the lease
            # until the fence window closes; the next poll retries
            self._count("fleet.ha.renewal-failures")
            if self.clock() > lease.deadline - self.skew_slack_s:
                self._lose(cid, fence, lease)
            return
        if renewed is None:
            # the store moved on without us (takeover won the race) —
            # capture who took it for the request path's ownership view
            self._count("fleet.ha.renewal-failures")
            try:
                cur = self.store.read(cid)
                if cur is not None:
                    with self._lock:
                        self._peer_view[cid] = (cur.holder_id, cur.epoch)
            except Exception:  # noqa: BLE001 — view refresh is best-effort
                pass
            self._lose(cid, fence, lease)
            return
        if self._stop.is_set():
            # stop() raced us while we were blocked in the store (its
            # join timeout elapsed and it already revoked/released):
            # re-granting the fence here would resurrect a lease a peer
            # may hold by now — hand the renewal straight back instead
            try:
                self.store.release(renewed)
            except Exception:  # noqa: BLE001 — the TTL expires it anyway
                pass
            return
        self._count("fleet.ha.renewals")
        with self._lock:
            self._leases[cid] = renewed
        fence._grant(renewed.epoch, renewed.deadline)

    def _acquire_one(self, cid: str, fence: Fence) -> None:
        if self._stop.is_set():
            return  # shutting down: must not re-acquire a released lease
        with self._lock:
            cooldown = self._cooldown_until.get(cid, 0.0)
        if self.clock() < cooldown:
            return  # backing off after a failed activation (relinquish)
        try:
            lease = self.store.acquire(cid, self.holder_id, self.ttl_s)
        except Exception:  # noqa: BLE001 — store partition: retry next poll
            self._count("fleet.ha.renewal-failures")
            return
        if lease is None:
            # someone else's live lease: refresh the cached peer view the
            # request path (/fleet ownership) reads instead of the store
            try:
                cur = self.store.read(cid)
                if cur is not None:
                    with self._lock:
                        self._peer_view[cid] = (cur.holder_id, cur.epoch)
            except Exception:  # noqa: BLE001 — view refresh is best-effort
                pass
            return
        if self._stop.is_set():
            # stop() raced us while we were blocked in the store (its
            # 5s join timeout elapsed): hand the grant straight back so
            # a peer never waits out a TTL nobody is renewing
            try:
                self.store.release(lease)
            except Exception:  # noqa: BLE001 — the TTL expires it anyway
                pass
            return
        # the store decides takeover-ness under its own lock (a racing
        # pre-read here would misclassify a release-then-grant)
        takeover = lease.takeover
        with self._lock:
            self._leases[cid] = lease
        # fence BEFORE the callback: activation (journal reconciliation,
        # resume) runs its admin calls already fenced-in
        fence._grant(lease.epoch, lease.deadline)
        self._count("fleet.ha.acquired")
        if takeover:
            self._count("fleet.ha.takeovers")
        log.info(
            "lease acquired: cluster=%s holder=%s epoch=%d%s",
            cid, self.holder_id, lease.epoch,
            " (takeover)" if takeover else "",
        )
        if self.on_acquired is not None:
            try:
                self.on_acquired(cid, lease, takeover)
            except Exception:  # noqa: BLE001 — a failed activation must not
                # wedge the heartbeat for the other clusters
                log.warning("lease activation of %s failed", cid, exc_info=True)

    def _lose(self, cid: str, fence: Fence, lease: Lease) -> None:
        # revoke FIRST: by the time step-down code runs, any concurrent
        # append/mutation already raises FencedError
        fence._revoke()
        with self._lock:
            self._leases.pop(cid, None)
        self._count("fleet.ha.lost")
        log.warning(
            "lease LOST: cluster=%s holder=%s epoch=%d — stepping down to "
            "read-only degraded mode", cid, self.holder_id, lease.epoch,
        )
        if self.on_lost is not None:
            try:
                self.on_lost(cid, lease)
            except Exception:  # noqa: BLE001
                log.warning("lease step-down of %s failed", cid, exc_info=True)

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — heartbeat must keep beating
                    log.warning("lease heartbeat pass failed", exc_info=True)
                self._stop.wait(self.renew_s)

        self._thread = threading.Thread(
            target=loop, daemon=True, name=f"lease-heartbeat-{self.holder_id}"
        )
        self._thread.start()

    def stop(self, *, release: bool = True) -> None:
        """Graceful shutdown: stop heartbeats and (by default) release
        every held lease so a peer can take over immediately instead of
        waiting out the TTL."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        with self._lock:
            leases = dict(self._leases)
            self._leases.clear()
        for cid, lease in leases.items():
            self.fences[cid]._revoke()
            if release:
                try:
                    self.store.release(lease)
                except Exception:  # noqa: BLE001 — the TTL expires it anyway
                    pass

    def kill(self) -> None:
        """Test/bench seam: die like a crashed process — heartbeats stop,
        NOTHING is released (peers must wait out the TTL), and the local
        fences revoke (a dead process runs no more code; revoking models
        exactly that for in-process harnesses)."""
        self.stop(release=False)

    def relinquish(self, cluster_id: str, *, cooldown_s: float = 0.0) -> None:
        """Voluntarily give one cluster's lease back (fence revoked
        first): a failed activation hands the cluster to whoever's
        heartbeat wins it next — possibly a healthy peer — instead of
        squatting on a lease it cannot serve.  `cooldown_s` keeps THIS
        instance from instantly re-acquiring and re-failing (flap
        backoff); peers are unaffected."""
        fence = self.fences[cluster_id]
        fence._revoke()
        with self._lock:
            lease = self._leases.pop(cluster_id, None)
            if cooldown_s > 0:
                self._cooldown_until[cluster_id] = self.clock() + cooldown_s
        if lease is not None:
            try:
                self.store.release(lease)
            except Exception:  # noqa: BLE001 — the TTL expires it anyway
                pass

    # ------------------------------------------------------------ views

    def ownership_json(self, cluster_id: str) -> dict:
        """Ownership view for /fleet.  Never touches the store: the
        request path must keep serving during a store partition (the
        degraded read-only promise), so the non-owned holder info comes
        from the heartbeat-refreshed peer view."""
        fence = self.fences[cluster_id]
        out: dict = {"owned": fence.held, "instanceId": self.holder_id}
        lease = self.lease(cluster_id)
        if fence.held and lease is not None:
            out["holderId"] = lease.holder_id
            out["epoch"] = lease.epoch
            out["deadlineInS"] = round(lease.deadline - self.clock(), 3)
        else:
            with self._lock:
                peer = self._peer_view.get(cluster_id)
            if peer is not None:
                out["holderId"], out["epoch"] = peer
        return out

    def state_json(self) -> dict:
        return {
            "instanceId": self.holder_id,
            "ttlS": self.ttl_s,
            "renewS": self.renew_s,
            "skewSlackS": self.skew_slack_s,
            "ownedClusters": self.owned_clusters(),
            "clusters": {
                cid: self.ownership_json(cid) for cid in self.fences
            },
        }
