"""REST API server — the reference's 20-endpoint servlet surface.

Reference: servlet/KafkaCruiseControlServlet.java:96-130 (doGetOrPost
dispatch), CruiseControlEndPoint.java:16-37 (endpoints: 9 GET — BOOTSTRAP,
TRAIN, LOAD, PARTITION_LOAD, PROPOSALS, STATE, KAFKA_CLUSTER_STATE,
USER_TASKS, REVIEW_BOARD; 11 POST — ADD_BROKER, REMOVE_BROKER,
FIX_OFFLINE_REPLICAS, REBALANCE, STOP_PROPOSAL_EXECUTION, PAUSE_SAMPLING,
RESUME_SAMPLING, DEMOTE_BROKER, ADMIN, REVIEW, TOPIC_CONFIGURATION),
parameter parsing (servlet/parameters/ParameterUtils.java), the async
202-with-progress pattern, and basic-auth security
(servlet/security/BasicSecurityProvider.java).

Built on the stdlib threading HTTP server — the service is control-plane
I/O; no framework dependency is warranted.

An operation whose device route failed (`DeviceDegradedError`) or met an
open breaker (`BreakerOpenError`) answers 503 with its `failureClass`;
the breaker's answer carries a Retry-After of the supervisor's probe
interval.  Any other failure answers 500, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import urllib.parse
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from cruise_control_tpu_torch.common.device_watchdog import BreakerOpenError, DeviceDegradedError
from cruise_control_tpu_torch.common.resources import RESOURCE_NAMES, Resource
from cruise_control_tpu_torch.service.facade import CruiseControl, host_array
from cruise_control_tpu_torch.service.parameters import ParameterError, build_override_maps
from cruise_control_tpu_torch.service.purgatory import Purgatory, PurgatoryFullError
from cruise_control_tpu_torch.fleet.scheduler import SchedulerOverloadError
from cruise_control_tpu_torch.service.tasks import (
    USER_TASK_ID_HEADER,
    TenantOverloadError,
    UserTaskManager,
)

from cruise_control_tpu_torch.config.endpoints import GET_ENDPOINTS, POST_ENDPOINTS


class BadRequest(ValueError):
    pass


class RawResponse:
    """A non-JSON endpoint body (the Prometheus exposition): the handler
    returns one of these and `_send` writes it verbatim under its own
    Content-Type instead of JSON-encoding it."""

    def __init__(self, body: str, content_type: str):
        self.body = body
        self.content_type = content_type


#: operation audit trail (reference OPERATION_LOGGER, executor/Executor.java:74,
#: detector/AnomalyDetector.java:56): one line per REST operation with the
#: authenticated principal and outcome.  Route to a file via standard logging
#: config (`logging.getLogger("cruisecontrol.operations")`).
OPERATION_LOGGER = logging.getLogger("cruisecontrol.operations")


class AccessLog:
    """NCSA-format access log with daily roll + day-based retention
    (reference Jetty NCSARequestLog wiring, KafkaCruiseControlApp.java:133-148,
    WebServerConfig webserver.accesslog.{enabled,path,retention.days})."""

    def __init__(self, path: str, *, retention_days: int = 7):
        import os
        import time as _time

        self.path = path
        self.retention_days = retention_days
        self._lock = threading.Lock()
        self._day: str | None = None
        self._file = None  # persistent handle; reopened only on the daily roll
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # a leftover log from a previous day (service restart) must roll
        # before today's entries append to it — seed _day from the file's
        # mtime so the first log() call observes the day change
        try:
            self._day = _time.strftime(
                "%Y-%m-%d", _time.localtime(os.path.getmtime(path))
            )
        except OSError:
            pass

    def log(self, client: str, user: str, method: str, path: str, status: int,
            size: int):
        import os
        import time as _time

        now = _time.time()
        day = _time.strftime("%Y-%m-%d", _time.localtime(now))
        stamp = _time.strftime("%d/%b/%Y:%H:%M:%S %z", _time.localtime(now))
        line = (
            f'{client} - {user or "-"} [{stamp}] "{method} {path} HTTP/1.1" '
            f"{status} {size}\n"
        )
        with self._lock:
            if self._day is not None and day != self._day:
                # roll: current file -> path.YYYY-MM-DD, prune old rolls
                if self._file is not None:
                    self._file.close()
                    self._file = None
                try:
                    os.replace(self.path, f"{self.path}.{self._day}")
                except OSError:
                    pass
                self._prune(now)
            self._day = day
            if self._file is None:
                self._file = open(self.path, "a")  # noqa: SIM115 — held open
            self._file.write(line)
            self._file.flush()

    def _prune(self, now: float):
        import glob
        import os

        cutoff = now - self.retention_days * 86_400
        for rolled in glob.glob(f"{self.path}.*"):
            try:
                if os.path.getmtime(rolled) < cutoff:
                    os.remove(rolled)
            except OSError:
                pass


def _parse_bool(params: dict, name: str, default: bool) -> bool:
    if name not in params:
        return default
    return params[name][0].lower() in ("true", "1", "yes")


def _parse_execution_overrides(params: dict, allowed_strategies=None) -> dict:
    """Per-request execution knobs (reference ParameterUtils: concurrency
    caps + replication_throttle request parameters).

    allowed_strategies: the configured replica.movement.strategies pool —
    an unknown strategy name 400s HERE, before a full proposal computation
    is wasted on a request that can never execute."""
    out = {}
    for name, cast, lo in (
        ("concurrent_partition_movements_per_broker", int, 1),
        ("concurrent_leader_movements", int, 1),
        ("replication_throttle", float, 1),
    ):
        if name in params:
            try:
                v = cast(params[name][0])
            except ValueError as e:
                raise BadRequest(f"bad {name}: {e}") from e
            if not v >= lo:  # also rejects NaN (NaN comparisons are False)
                # a zero/negative cap would stall the executor loop forever;
                # reject loudly rather than hang the user task
                raise BadRequest(f"{name} must be >= {lo}, got {v}")
            out[name] = v
    if "replica_movement_strategies" in params:
        # per-request task-ordering override (reference ParameterUtils
        # replica_movement_strategies)
        names = [
            s.strip()
            for s in params["replica_movement_strategies"][0].split(",")
            if s.strip()
        ]
        if allowed_strategies is not None:
            unknown = [n for n in names if n not in allowed_strategies]
            if unknown:
                raise BadRequest(
                    f"unknown replica movement strategies {unknown}; "
                    f"allowed: {sorted(allowed_strategies)}"
                )
        out["replica_movement_strategies"] = names
    return out


def _parse_int_list(params: dict, name: str) -> list[int]:
    if name not in params:
        raise BadRequest(f"missing parameter {name}")
    try:
        return [int(x) for x in params[name][0].split(",") if x != ""]
    except ValueError as e:
        raise BadRequest(f"bad {name}: {e}") from e


class CruiseControlApp:
    """Server wrapper (reference KafkaCruiseControlApp.java).

    With `fleet=` (a fleet.FleetManager) the one server fronts N clusters:
    every request resolves its target facade from the `cluster=` parameter
    (bound thread-locally so the existing handlers keep reading `self.cc`),
    `/metrics` renders every cluster's labeled registry, and new async
    operations pass per-tenant admission control.  Without it, behavior is
    byte-for-byte the classic single-cluster server."""

    def __init__(self, cc: CruiseControl, *, port: int | None = None,
                 host: str | None = None, fleet=None):
        from cruise_control_tpu_torch.service.security import (
            AllowAllSecurityProvider,
            BasicSecurityProvider,
            JwtRs256SecurityProvider,
            JwtSecurityProvider,
            SessionManager,
        )

        self._default_cc = cc
        self.fleet = fleet
        #: webserver/user-task keys come from the BASE config in fleet mode
        #: (per-cluster configs only override cluster-scoped concerns)
        self.config = fleet.config if fleet is not None else cc.config
        # flight recorder + exposition (facade-owned; standalone facades
        # built without the config keys fall back to the process tracer).
        # In a fleet this is the BASE (unscoped) tracer: /trace replays the
        # shared store; per-cluster scoped tracers mint the spans.
        from cruise_control_tpu_torch.common.trace import TRACER

        if fleet is not None:
            self.tracer = fleet.core.tracer
        else:
            self.tracer = getattr(self._default_cc, "tracer", None) or TRACER
        self.tenant_max_pending = (
            fleet.tenant_max_pending if fleet is not None else 0
        )

        def _cat_map(fmt: str) -> dict:
            cats = {
                "KAFKA_MONITOR": "kafka.monitor",
                "CRUISE_CONTROL_MONITOR": "cruise.control.monitor",
                "KAFKA_ADMIN": "kafka.admin",
                "CRUISE_CONTROL_ADMIN": "cruise.control.admin",
            }
            out = {}
            for cat, key_part in cats.items():
                v = self.config.get(fmt.format(key_part))
                if v is not None:
                    out[cat] = v
            return out

        self.user_tasks = UserTaskManager(
            max_active_tasks=self.config.get("max.active.user.tasks"),
            max_cached_completed=self.config.get("max.cached.completed.user.tasks"),
            completed_retention_ms=self.config.get("completed.user.task.retention.time.ms"),
            category_max_cached=_cat_map("max.cached.completed.{}.user.tasks"),
            category_retention_ms=_cat_map("completed.{}.user.task.retention.time.ms"),
        )
        self.purgatory = Purgatory(
            retention_ms=self.config.get("two.step.purgatory.retention.time.ms"),
            max_requests=self.config.get("two.step.purgatory.max.requests"),
        )
        self.two_step = self.config.get("two.step.verification.enabled")
        self.reason_required = self.config.get("request.reason.required")
        self.sessions = SessionManager(
            max_expiry_ms=self.config.get("webserver.session.maxExpiryPeriodMs")
        )
        self.session_path = self.config.get("webserver.session.path")
        # security provider selection (reference webserver.security.provider)
        jwt_cert = self.config.get("jwt.auth.certificate.location") or self.config.get(
            "jwt.authentication.certificate.location"
        )
        jwt_kwargs = dict(
            cookie_name=self.config.get("jwt.cookie.name"),
            expected_audiences=self.config.get("jwt.expected.audiences") or None,
        )
        self.auth_provider_url = self.config.get("jwt.authentication.provider.url")
        custom_security = self.config.get("webserver.security.provider")
        if not self.config.get("webserver.security.enable"):
            self.security = AllowAllSecurityProvider()
        elif custom_security is not None:
            # pluggable provider outranks the builtin selection
            # (reference webserver.security.provider)
            self.security = custom_security(self.config)
        elif jwt_cert:
            # certificate-based RS256 outranks shared-secret HS256
            self.security = JwtRs256SecurityProvider(jwt_cert, **jwt_kwargs)
        elif self.config.get("jwt.secret.key"):
            self.security = JwtSecurityProvider(
                self.config.get("jwt.secret.key"), **jwt_kwargs
            )
        else:
            # reference key name wins over the legacy alias
            self.security = BasicSecurityProvider(
                self.config.get("webserver.auth.credentials.file")
                or self.config.get("basic.auth.credentials.file")
            )
        # CORS (reference WebServerConfig webserver.http.cors.*)
        self.cors_headers: dict[str, str] = {}
        if self.config.get("webserver.http.cors.enabled"):
            self.cors_headers = {
                "Access-Control-Allow-Origin": self.config.get("webserver.http.cors.origin"),
                "Access-Control-Allow-Methods": self.config.get(
                    "webserver.http.cors.allowmethods"
                ),
                "Access-Control-Expose-Headers": self.config.get(
                    "webserver.http.cors.exposeheaders"
                ),
            }
        self.access_log = (
            AccessLog(
                self.config.get("webserver.accesslog.path"),
                retention_days=self.config.get("webserver.accesslog.retention.days"),
            )
            if self.config.get("webserver.accesslog.enabled")
            else None
        )
        # static UI (reference webserver.ui.{diskpath,urlprefix})
        self.ui_diskpath = self.config.get("webserver.ui.diskpath")
        self.ui_prefix = (self.config.get("webserver.ui.urlprefix") or "/ui").rstrip("/")
        # API routes are dispatched before the UI, so a UI prefix can never
        # shadow them — which also means a UI prefix NESTED UNDER the API
        # prefix would be silently unreachable; both misconfigurations fail
        # loudly at startup instead
        if self.ui_diskpath:
            api = self.config.get("webserver.api.urlprefix").rstrip("/")
            nested = self.ui_prefix == api or self.ui_prefix.startswith(api + "/")
            if not self.ui_prefix or nested:
                raise ValueError(
                    "webserver.ui.urlprefix must be a non-root prefix outside "
                    f"the API prefix {api!r}, got "
                    f"{self.config.get('webserver.ui.urlprefix')!r}"
                )
        # per-endpoint parameter/request override maps (reference
        # CruiseControlParametersConfig / CruiseControlRequestConfig)
        self.param_parsers, self.request_handlers = build_override_maps(self.config)
        self.prefix = self.config.get("webserver.api.urlprefix").rstrip("/")
        self.host = host or self.config.get("webserver.http.address")
        self.port = port if port is not None else self.config.get("webserver.http.port")
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # per-request context (each request runs on its own handler thread)
        self._local = threading.local()

    # ------------------------------------------------------------------
    # fleet routing
    # ------------------------------------------------------------------

    @property
    def cc(self) -> CruiseControl:
        """The facade the CURRENT request targets: the thread-locally bound
        per-cluster facade in fleet mode, else the single facade.  Bound by
        handle() on the request thread and re-bound by _async_op's wrapper
        on the user-task pool thread before the operation body runs."""
        return getattr(self._local, "cc", None) or self._default_cc

    def _resolve_cluster(self, endpoint: str, cluster: str | None):
        """-> (facade, cluster_id) for this request; raises BadRequest on
        an unknown cluster, a `cluster=` outside fleet mode, or a missing
        one on a cluster-scoped endpoint in fleet mode."""
        from cruise_control_tpu_torch.config.endpoints import FLEET_GLOBAL_ENDPOINTS

        if self.fleet is None:
            if cluster:
                raise BadRequest(
                    f"cluster={cluster!r} but this instance manages no fleet "
                    "(fleet.clusters is empty)"
                )
            return self._default_cc, ""
        if not cluster:
            if endpoint in FLEET_GLOBAL_ENDPOINTS:
                return self._default_cc, ""
            raise BadRequest(
                f"parameter 'cluster' is required for {endpoint} in fleet "
                f"mode; clusters: {self.fleet.cluster_ids()}"
            )
        try:
            return self.fleet.facade(cluster), cluster
        except KeyError as e:
            raise BadRequest(str(e.args[0])) from e

    # ------------------------------------------------------------------
    # endpoint handlers; each returns (status, payload)
    # ------------------------------------------------------------------

    def handle(self, method: str, endpoint: str, params: dict, headers) -> tuple[int, dict]:
        if method == "GET" and endpoint not in GET_ENDPOINTS:
            raise BadRequest(f"unknown GET endpoint {endpoint}")
        if method == "POST" and endpoint not in POST_ENDPOINTS:
            raise BadRequest(f"unknown POST endpoint {endpoint}")
        # fleet routing: bind the target facade for this request thread
        # BEFORE anything touches self.cc (the 202-resume path below never
        # does — the task already carries its operation)
        self._local.cc, self._local.cluster_id = self._resolve_cluster(
            endpoint, params.get("cluster", [None])[0]
        )
        if (
            method == "POST"
            and self.reason_required
            and not params.get("reason", [""])[0]
            # an approved two-step resubmit carries only review_id — its
            # reason rides the PARKED params (which passed this check when
            # the request first parked).  The exemption only applies while
            # two-step verification is ON: otherwise review_id is ignored
            # downstream and a bare review_id would bypass the reason check
            and not (self.two_step and "review_id" in params)
        ):
            # reference WebServerConfig request.reason.required: mutating
            # requests must say why (feeds the operation audit log)
            raise BadRequest("parameter 'reason' is required on POST requests")

        # resume an async task by header (reference UserTaskManager flow)
        tid = headers.get(USER_TASK_ID_HEADER)
        if tid:
            task = self.user_tasks.get(tid)
            if task is None:
                # reference UserTaskManager rejects unknown task ids rather
                # than silently re-executing the operation
                return 404, {"errorMessage": f"unknown user task id {tid}"}
            status, payload = self._task_response(task)
            if status != 202:
                # response delivered: drop any session bound to this task, or
                # a later identical request would resume the stale result
                self.sessions.release_task(tid)
            return status, payload
        # header lost: rebind via session key (reference SessionManager).
        # Binding needs a client identity (reference: the HTTP session) —
        # anonymous requests must NOT share one namespace, or client B's
        # identical POST would silently resume client A's operation.
        client = headers.get("X-Client")
        self._local.client = client or ""
        # content negotiation (the /metrics OpenMetrics flavor reads it)
        self._local.accept = str(headers.get("Accept") or "")
        self._local.session_key = (
            self.sessions.session_key(
                client, method, endpoint,
                "&".join(f"{k}={v[0]}" for k, v in sorted(params.items())),
            )
            if client
            else None
        )

        # declared-parameter validation BEFORE the purgatory: unknown names
        # and malformed values 400 now (a `dry_run` typo must not execute
        # the rebalance the caller believed was a dry run), and an invalid
        # request must not park with a 200 only to burn its one approval
        # when the resubmit finally validates
        parsed = params
        parser = self.param_parsers.get(endpoint)
        if parser is not None:
            try:
                parsed = parser.parse(params)
            except ParameterError as e:
                raise BadRequest(str(e)) from e

        # two-step verification parks POSTs in the purgatory first
        if (
            method == "POST"
            and self.two_step
            and endpoint not in ("review", "stop_proposal_execution")
        ):
            if "review_id" in params:
                rid = int(params["review_id"][0])
                info = self.purgatory.take_approved(endpoint, rid)
                params = {**{k: [str(v)] for k, v in info.params.items()}, **params}
                if parser is not None:
                    # re-parse the MERGED params: a custom request handler
                    # consumes `parsed`, which must carry the parked
                    # parameters, not just the resubmit's review_id
                    parsed = parser.parse(params)
            else:
                try:
                    info = self.purgatory.add(
                        endpoint, {k: v[0] for k, v in params.items()}
                    )
                except PurgatoryFullError as e:
                    raise BadRequest(str(e)) from e
                return 200, {"reviewId": info.review_id, "status": info.status.value}

        custom = self.request_handlers.get(endpoint)
        if custom is not None:
            # custom request classes receive the PARSED parameter dict
            # (build_override_maps contract)
            return custom(self, endpoint, parsed)
        fn = getattr(self, f"_ep_{endpoint}")
        return fn(params)

    def _task_response(self, task) -> tuple[int, dict]:
        # every shape carries the flight-recorder trace id (when tracing
        # is on): a client polling a 202 can ALREADY replay the live span
        # tree via GET /trace?id=..., and a 500's trace shows which stage
        # died
        rider = {"_traceId": task.trace_id} if task.trace_id else {}
        try:
            result = task.future.result(timeout=1.0)
            return 200, {**result, "_userTaskId": task.task_id, **rider}
        except FutureTimeout:
            return 202, {
                "progress": task.progress.to_json(),
                "_userTaskId": task.task_id,
                **rider,
            }
        except DeviceDegradedError as e:
            # the card's supervised route failed or its breaker is open:
            # the service is unavailable for device work, and no CPU
            # answer stands in for the card's (503, with the failure
            # class; an open breaker adds when the next probe may close it)
            out = {
                "errorMessage": str(e), "failureClass": e.reason,
                "_userTaskId": task.task_id, **rider,
            }
            if isinstance(e, BreakerOpenError):
                out["openedBy"] = e.failure_class.value
                sup = getattr(self.cc, "supervisor", None)
                probe_s = sup.breaker.probe_interval_s if sup is not None else 0.0
                out["_retryAfter"] = max(1, math.ceil(probe_s))
            return 503, out
        except Exception as e:  # noqa: BLE001 — operation failed
            return 500, {
                "errorMessage": str(e), "_userTaskId": task.task_id, **rider,
            }

    def _async_op(self, endpoint: str, fn) -> tuple[int, dict]:
        # fleet context: the facade resolved on the REQUEST thread rides
        # into the pool-thread wrapper, which re-binds it thread-locally so
        # handler bodies reading self.cc resolve the same cluster there
        cc = self.cc
        cluster_id = getattr(self._local, "cluster_id", "") or ""
        # flight recorder: ONE trace per submitted operation.  The id is
        # minted here (synchronously, so the UserTask carries it and the
        # very first 202 can hand it to the client); the root span opens
        # on the pool thread when the operation actually runs, and every
        # pipeline stage beneath (model build, optimize, device ops,
        # execution) parents into it via context propagation.  In fleet
        # mode the facade's CLUSTER-SCOPED tracer mints the root, so the
        # whole operation files under this cluster's trace components.
        tracer = getattr(cc, "tracer", None) or self.tracer
        trace_id = tracer.new_trace_id() if tracer.enabled else ""

        def wrapped(progress, _op=fn):
            self._local.cc = cc
            self._local.cluster_id = cluster_id
            span_attrs = {"cluster": cluster_id} if cluster_id else {}
            with tracer.span(
                f"service.{endpoint}", component="service",
                trace_id=trace_id, root=True, **span_attrs,
            ):
                out = _op(progress)
            # degraded serving must be visible in the ops audit trail, not
            # only in the payload: the analyzer's device breaker is open
            # and this answer came from the CPU greedy fallback
            if isinstance(out, dict) and out.get("degraded"):
                OPERATION_LOGGER.warning(
                    "%s served DEGRADED (CPU greedy fallback; "
                    "see /state AnalyzerState.supervisor)",
                    endpoint,
                )
            return out

        fn = wrapped

        def _submit():
            # admission control runs HERE — _submit only fires for NEW
            # work, so polling an already-running task (User-Task-ID
            # header, or the session rebind below) is never rejected.
            # Two rungs: the device scheduler's INTERACTIVE shed (severe
            # overload: 429 + drain-rate Retry-After BEFORE a task is
            # created), then the per-tenant pending cap enforced inside
            # the task manager's lock (atomic count-and-admit).
            sched = getattr(cc, "scheduler", None)
            if sched is not None:
                try:
                    sched.admit_interactive(
                        cluster_id=cluster_id,
                        default_retry_after_s=self.config.get(
                            "fleet.tenant.retry.after.s"
                        ),
                    )
                except SchedulerOverloadError:
                    cc.sensors.counter("fleet.scheduler-rejections").inc()
                    raise
            cap = (
                self.tenant_max_pending
                if self.fleet is not None and cluster_id else 0
            )
            try:
                return self.user_tasks.submit(
                    endpoint, fn, client_id=client, trace_id=trace_id,
                    cluster_id=cluster_id, cluster_max_active=cap,
                )
            except TenantOverloadError:
                cc.sensors.counter("fleet.tenant-rejections").inc()
                raise

        key = getattr(self._local, "session_key", None)
        client = getattr(self._local, "client", "") or ""
        try:
            if key is None:
                return self._task_response(_submit())
            # bind the session to the submitted task so a client that lost
            # the User-Task-ID header resumes the same operation instead of
            # re-executing it (reference servlet/SessionManager.java)
            tid = self.sessions.get_or_bind(key, lambda: _submit().task_id)
            task = self.user_tasks.get(tid)
            if task is None:  # bound task evicted; start fresh
                self.sessions.release(key)
                tid = self.sessions.get_or_bind(key, lambda: _submit().task_id)
                task = self.user_tasks.get(tid)
        except TenantOverloadError as e:
            # Retry-After from the tenant queue's measured drain rate
            # (fallback: fleet.tenant.retry.after.s) — the rider becomes
            # a real Retry-After header in _send
            ra = e.retry_after_s
            if ra is None:
                ra = self.user_tasks.retry_after_s(
                    cluster_id,
                    default_s=self.config.get("fleet.tenant.retry.after.s"),
                )
            return 429, {"errorMessage": str(e), "_retryAfter": int(round(ra))}
        except SchedulerOverloadError as e:
            return 429, {
                "errorMessage": str(e),
                "_retryAfter": int(round(e.retry_after_s)),
            }
        status, payload = self._task_response(task)
        if status != 202:  # response delivered -> close the session
            self.sessions.release(key)
        return status, payload

    # --- GET ---

    def _ep_state(self, params) -> tuple[int, dict]:
        subs = params.get("substates", [None])[0]
        return 200, self.cc.state(subs.split(",") if subs else None)

    def _ep_kafka_cluster_state(self, params) -> tuple[int, dict]:
        topo = self.cc.admin.topology()
        by_broker: dict[int, dict] = {
            b.broker_id: {"replicaCount": 0, "leaderCount": 0, "isAlive": b.alive,
                          "rack": b.rack}
            for b in topo.brokers
        }
        urp = 0
        offline = 0
        alive = topo.alive_broker_ids()
        for p in topo.partitions:
            for b in p.replicas:
                if b in by_broker:
                    by_broker[b]["replicaCount"] += 1
                if b not in alive:
                    offline += 1
            if any(b not in alive for b in p.replicas):
                urp += 1
            if p.leader in by_broker:
                by_broker[p.leader]["leaderCount"] += 1
        return 200, {
            "KafkaBrokerState": by_broker,
            "KafkaPartitionState": {
                "numTotalPartitions": len(topo.partitions),
                "numUnderReplicatedPartitions": urp,
                "numOfflineReplicas": offline,
            },
        }

    def _ep_load(self, params) -> tuple[int, dict]:
        def op(progress):
            state = self.cc._cluster_model(progress)
            from cruise_control_tpu_torch.models.aggregates import compute_aggregates

            agg = compute_aggregates(state)
            load = host_array(agg.broker_load)
            cap = host_array(state.broker_capacity)
            alive = host_array(state.broker_alive)
            bvalid = host_array(state.broker_valid)
            leaders = host_array(agg.broker_leader_count)
            replicas = host_array(agg.broker_replica_count)
            hosts = (
                self.cc.monitor.last_catalog.hosts
                if self.cc.monitor.last_catalog and self.cc.monitor.last_catalog.hosts
                else None
            )
            brokers = []
            for b in range(state.shape.B):
                if not bvalid[b]:
                    continue  # shape-bucket padding rows are not brokers
                row = {
                    "Broker": b,
                    "BrokerState": "ALIVE" if alive[b] else "DEAD",
                    "Leaders": int(leaders[b]),
                    "Replicas": int(replicas[b]),
                }
                for r in range(4):
                    name = RESOURCE_NAMES[r]
                    row[name] = round(float(load[b, r]), 3)
                    row[f"{name}Pct"] = round(
                        float(100.0 * load[b, r] / max(cap[b, r], 1e-9)), 2
                    )
                brokers.append(row)
            return {"brokers": brokers, "hosts": hosts or []}

        return self._async_op("load", op)

    def _ep_partition_load(self, params) -> tuple[int, dict]:
        resource = params.get("resource", ["DISK"])[0].upper()
        if resource not in RESOURCE_NAMES:
            raise BadRequest(f"unknown resource {resource}")
        max_entries = int(params.get("entries", ["50"])[0])

        def op(progress):
            state = self.cc._cluster_model(progress)
            catalog = self.cc.monitor.last_catalog
            r = int(Resource[resource])
            lead = host_array(state.replica_is_leader) & host_array(state.replica_valid)
            loads = host_array(state.replica_load_leader)[:, r]
            part = host_array(state.replica_partition)
            order = np.argsort(-np.where(lead, loads, -np.inf))
            records = []
            for i in order[:max_entries]:
                if not lead[i]:
                    break
                t, p = catalog.partition_key(int(part[i]))
                records.append(
                    {"topic": t, "partition": p, resource: round(float(loads[i]), 3)}
                )
            return {"records": records, "resource": resource}

        return self._async_op("partition_load", op)

    def _ep_proposals(self, params) -> tuple[int, dict]:
        ignore_cache = _parse_bool(params, "ignore_proposal_cache", False)
        allow_est = _parse_bool(params, "allow_capacity_estimation", True)

        def op(progress):
            result = self.cc.proposals(
                progress,
                ignore_cache=ignore_cache,
                allow_capacity_estimation=allow_est,
            )
            out = result.summary()
            out["estimatedExecutionTime"] = self.cc._execution_eta(result)
            out["proposals"] = [p.to_json() for p in result.proposals[:100]]
            return out

        return self._async_op("proposals", op)

    def _ep_user_tasks(self, params) -> tuple[int, dict]:
        """Reference UserTasksParameters filters
        (servlet/parameters/UserTasksParameters.java:1): user_task_ids,
        client_ids, endpoints, and types (task status names) are each a
        comma-separated allowlist; unset filters match everything."""
        tasks = self.user_tasks.all_tasks()
        # (param, task attribute, case-sensitive) — client identities are
        # opaque strings and compare exactly; ids/endpoints/statuses fold
        for pname, attr, exact in (
            ("user_task_ids", "task_id", False),
            ("client_ids", "client_id", True),
            ("endpoints", "endpoint", False),
            ("types", "status", False),
            # fleet: filter the task board down to one or more clusters
            ("clusters", "cluster_id", True),
        ):
            raw = params.get(pname, [None])[0]
            if not raw:
                continue
            wanted = {x.strip() if exact else x.strip().lower()
                      for x in raw.split(",") if x.strip()}
            tasks = [
                t for t in tasks
                if (getattr(t, attr) if exact else getattr(t, attr).lower())
                in wanted
            ]
        return 200, {"userTasks": [t.to_json() for t in tasks]}

    def _ep_review_board(self, params) -> tuple[int, dict]:
        return 200, {"requestInfo": self.purgatory.board()}

    def _ep_bootstrap(self, params) -> tuple[int, dict]:
        """Reference LoadMonitor.bootstrap:325-345 + BootstrapTask's 3 modes:
        RANGE (start+end), SINCE (start only), RECENT (neither)."""
        runner = getattr(self.cc, "task_runner", None)
        if runner is None:
            raise BadRequest("no task runner configured")
        start = params.get("start", [None])[0]
        end = params.get("end", [None])[0]
        clear = _parse_bool(params, "clearmetrics", start is None and end is None)

        def op(progress):
            if start is not None and end is not None:
                mode, n = "RANGE", runner.bootstrap_range(int(start), int(end), clear)
            elif start is not None:
                mode, n = "SINCE", runner.bootstrap_since(int(start), clear)
            else:
                mode, n = "RECENT", runner.bootstrap_recent(clear)
            return {"mode": mode, "samplesAbsorbed": n, **runner.state()}

        return self._async_op("bootstrap", op)

    def _ep_train(self, params) -> tuple[int, dict]:
        """Reference LoadMonitor.train:354 -> TrainingTask -> regression."""
        runner = getattr(self.cc, "task_runner", None)
        if runner is None:
            raise BadRequest("no task runner configured")
        import time as _time

        now = int(_time.time() * 1000)
        start = int(params.get("start", [str(now - 3_600_000)])[0])
        end = int(params.get("end", [str(now)])[0])
        return self._async_op(
            "train", lambda progress: runner.train(start, end)
        )

    def _blackbox_block(self) -> dict:
        """The black-box spool's live view (the durable twin of the
        in-memory trace store): recorder state, the trailing records
        re-read from disk, and the dispatches currently in flight."""
        from cruise_control_tpu_torch.common.blackbox import RECORDER

        return {
            "state": RECORDER.state_json(),
            "records": RECORDER.tail(),
            "inFlight": RECORDER.in_flight(),
        }

    def _ep_trace(self, params) -> tuple[int, dict]:
        """GET /trace — flight-recorder replay.  With ?id=<traceId> the
        span forest of one trace (404 when nothing of it is retained);
        without, a newest-first index of recent root traces.  With
        ?blackbox=true the response also embeds the on-disk dispatch
        spool's tail + in-flight dispatches."""
        tid = params.get("id", [None])[0]
        with_bb = _parse_bool(params, "blackbox", False)
        if tid is None:
            # the declared Param("limit", _min1_int) parser already 400'd
            # malformed/<1 values before dispatch reached this handler
            limit = int(params.get("limit", ["50"])[0])
            out = {"traces": self.tracer.recent_traces(limit)}
            if with_bb:
                out["blackbox"] = self._blackbox_block()
            return 200, out
        spans = self.tracer.trace_tree(tid)
        if not spans:
            # KeyError -> the dispatcher's 404 path: an unknown (or
            # already-evicted) trace id is "not found", not an empty tree
            raise KeyError(f"no retained spans for trace id {tid}")
        out = {"traceId": tid, "spans": spans}
        if with_bb:
            out["blackbox"] = self._blackbox_block()
        return 200, out

    def _ep_metrics(self, params) -> tuple[int, dict]:
        """GET /metrics — Prometheus text exposition of the whole sensor
        surface (common/exposition.py); text/plain, not JSON.  Fleet mode
        renders EVERY registry: the shared core's unlabeled plus each
        cluster's `{cluster=...}`-labeled one.  `?format=openmetrics` (or
        an Accept header naming application/openmetrics-text) renders the
        OpenMetrics flavor: histogram buckets carry trace-id exemplars
        linking latency outliers to their /trace replays."""
        from cruise_control_tpu_torch.common.exposition import (
            CONTENT_TYPE,
            CONTENT_TYPE_OPENMETRICS,
            prometheus_text,
        )

        openmetrics = (
            params.get("format", [""])[0].lower() == "openmetrics"
            or "application/openmetrics-text"
            in getattr(self._local, "accept", "")
        )
        registries = (
            self.fleet.registries() if self.fleet is not None else self.cc.sensors
        )
        body = prometheus_text(
            registries,
            namespace=self.config.get("metrics.prometheus.namespace"),
            openmetrics=openmetrics,
        )
        return 200, RawResponse(
            body, CONTENT_TYPE_OPENMETRICS if openmetrics else CONTENT_TYPE
        )

    def _ep_slo(self, params) -> tuple[int, dict]:
        """GET /slo — the SLO registries' live state: per-SLO fast/slow
        burn rates, compliance, and breach-episode status, evaluated
        fresh on every scrape (common/slo.py).  Fleet mode reports every
        cluster (or one, with ?cluster=); single-cluster deployments
        answer under the synthetic id "default" like /fleet."""
        cluster = params.get("cluster", [None])[0]

        def block(cc) -> dict:
            reg = cc.slo_registry
            if reg is None:
                return {"enabled": False, "slos": []}
            return {"enabled": True, **reg.state_json()}

        if self.fleet is None:
            clusters = {"default": block(self._default_cc)}
        else:
            ids = [cluster] if cluster else self.fleet.cluster_ids()
            clusters = {cid: block(self.fleet.facade(cid)) for cid in ids}
        return 200, {"numClusters": len(clusters), "clusters": clusters}

    def _ep_explain(self, params) -> tuple[int, dict]:
        """GET /explain?trace_id=|proposal= — replay one decision-ledger
        episode as a structured explanation: goal deltas, top moves,
        convergence curve, outcome + calibration when present
        (analyzer/ledger.py; cluster-scoped — each cluster owns its own
        ledger)."""
        trace_id = params.get("trace_id", [None])[0]
        proposal = params.get("proposal", [None])[0]
        try:
            out = self.cc.explain(trace_id=trace_id, decision_id=proposal)
        except ValueError as e:
            raise BadRequest(str(e)) from e
        # KeyError (unknown trace/proposal) rides to the dispatcher's 404
        return 200, out

    def _ep_ledger(self, params) -> tuple[int, dict]:
        """GET /ledger — the raw joined decision→outcome→calibration
        episode stream, newest first (the flywheel's training-corpus
        export; `cccli ledger` prints it verbatim)."""
        limit = int(params.get("limit", ["50"])[0])
        cc = self.cc
        if cc.ledger is None:
            return 200, {"enabled": False, "entries": []}
        return 200, {
            "enabled": True,
            "entries": cc.ledger_entries(limit=limit),
            "state": cc.ledger.state_json(),
        }

    def _ep_fleet(self, params) -> tuple[int, dict]:
        """GET /fleet — whole-instance rollup: per-cluster summaries + the
        shared core (engine cache, supervisor, admission control).  With
        ?score=true every cluster's current placement is also scored on
        the shared goal chain, same-bucket clusters batched through one
        device dispatch.  Single-cluster deployments answer with a
        one-entry rollup under the id "default"."""
        cluster = params.get("cluster", [None])[0]
        if self.fleet is not None:
            out = self.fleet.fleet_state(cluster)
            if _parse_bool(params, "score", False):
                out["scores"] = self.fleet.score_clusters()
            return 200, out
        # single-cluster view: same shape, one synthetic entry, so fleet
        # dashboards work unchanged against classic deployments
        from cruise_control_tpu_torch.fleet.manager import (
            ClusterContext,
            shared_core_rollup,
        )

        cc = self.cc
        return 200, {
            "numClusters": 1,
            "clusters": {"default": ClusterContext("default", cc).rollup()},
            "shared": shared_core_rollup(cc.core),
        }

    def _ep_rightsize(self, params) -> tuple[int, dict]:
        """GET /rightsize — minimum brokers satisfying all hard goals at
        current (and, with horizon_ms, forecast) load.  Read-only."""
        allow_est = _parse_bool(params, "allow_capacity_estimation", True)

        def _opt_num(name, cast, lo):
            # bounds match the declared _min1_* parsers (parameters.py):
            # a negative horizon would "forecast" backwards and a
            # sub-1 factor degenerates the search ceiling silently
            v = params.get(name, [None])[0]
            if v is None:
                return None
            try:
                v = cast(v)
            except ValueError as e:
                raise BadRequest(f"bad {name}: {e}") from e
            if not v >= lo:
                raise BadRequest(f"{name} must be >= {lo}, got {v}")
            return v

        horizon = _opt_num("horizon_ms", int, 1)
        min_brokers = _opt_num("min_brokers", int, 1)
        max_factor = _opt_num("max_broker_factor", float, 1)
        return self._async_op(
            "rightsize",
            lambda progress: self.cc.rightsize(
                progress,
                horizon_ms=horizon,
                min_brokers=min_brokers,
                max_broker_factor=max_factor,
                allow_capacity_estimation=allow_est,
            ),
        )

    # --- POST ---

    def _ep_simulate(self, params) -> tuple[int, dict]:
        """POST /simulate — batched what-if evaluation.  POST because the
        scenario payload is a JSON document (rides the form body), but the
        operation never mutates the cluster."""
        from cruise_control_tpu_torch.service.parameters import (
            ParameterError,
            _scenario_list,
        )

        raw = params.get("scenarios", [None])[0]
        if raw is None:
            raise BadRequest("missing parameter scenarios (JSON list)")
        try:
            scenarios = _scenario_list(raw)
        except ParameterError as e:
            raise BadRequest(str(e)) from e
        cap = self.cc.config.get("planner.max.scenarios")
        if len(scenarios) > cap:
            # 400 HERE: an oversized batch is a client error, not a task
            # failure surfaced as 500 after a cluster model was built
            raise BadRequest(
                f"{len(scenarios)} scenarios exceed planner.max.scenarios={cap}"
            )
        optimize = (
            _parse_bool(params, "optimize", False)
            if "optimize" in params
            else None  # None -> planner.simulate.optimize.default
        )
        allow_est = _parse_bool(params, "allow_capacity_estimation", True)
        return self._async_op(
            "simulate",
            lambda progress: self.cc.simulate(
                progress,
                scenarios,
                optimize=optimize,
                allow_capacity_estimation=allow_est,
            ),
        )

    def _ep_rebalance(self, params) -> tuple[int, dict]:
        dryrun = _parse_bool(params, "dryrun", True)
        rebalance_disk = _parse_bool(params, "rebalance_disk", False)
        allow_est = _parse_bool(params, "allow_capacity_estimation", True)
        goals = params.get("goals", [None])[0]
        dests = params.get("destination_broker_ids", [None])[0]
        excluded = params.get("excluded_topics", [None])[0]
        overrides = _parse_execution_overrides(params, self.cc.allowed_strategies)
        # reference rebalance parameters exclude recently removed/demoted
        # brokers from receiving replicas/leadership
        ex_removed = (
            sorted(self.cc.executor.removed_brokers)
            if _parse_bool(params, "exclude_recently_removed_brokers", False)
            else None
        )
        ex_demoted = (
            sorted(self.cc.executor.demoted_brokers)
            if _parse_bool(params, "exclude_recently_demoted_brokers", False)
            else None
        )

        def op(progress):
            return self.cc.rebalance(
                progress,
                dryrun=dryrun,
                goals=goals.split(",") if goals else None,
                destination_broker_ids=[int(x) for x in dests.split(",")] if dests else None,
                excluded_topics_pattern=excluded,
                excluded_brokers_for_replica_move=ex_removed,
                excluded_brokers_for_leadership=ex_demoted,
                rebalance_disk=rebalance_disk,
                allow_capacity_estimation=allow_est,
                execution_overrides=overrides,
            )

        return self._async_op("rebalance", op)

    def _ep_add_broker(self, params) -> tuple[int, dict]:
        ids = _parse_int_list(params, "brokerid")
        dryrun = _parse_bool(params, "dryrun", True)
        overrides = _parse_execution_overrides(params, self.cc.allowed_strategies)
        return self._async_op(
            "add_broker",
            lambda progress: self.cc.add_brokers(
                progress, ids, dryrun=dryrun, execution_overrides=overrides
            ),
        )

    def _ep_remove_broker(self, params) -> tuple[int, dict]:
        ids = _parse_int_list(params, "brokerid")
        dryrun = _parse_bool(params, "dryrun", True)
        overrides = _parse_execution_overrides(params, self.cc.allowed_strategies)
        return self._async_op(
            "remove_broker",
            lambda progress: self.cc.remove_brokers(
                progress, ids, dryrun=dryrun, execution_overrides=overrides
            ),
        )

    def _ep_demote_broker(self, params) -> tuple[int, dict]:
        ids = _parse_int_list(params, "brokerid")
        dryrun = _parse_bool(params, "dryrun", True)
        return self._async_op(
            "demote_broker",
            lambda progress: self.cc.demote_brokers(progress, ids, dryrun=dryrun),
        )

    def _ep_fix_offline_replicas(self, params) -> tuple[int, dict]:
        dryrun = _parse_bool(params, "dryrun", True)
        return self._async_op(
            "fix_offline_replicas",
            lambda progress: self.cc.fix_offline_replicas(progress, dryrun=dryrun),
        )

    def _ep_stop_proposal_execution(self, params) -> tuple[int, dict]:
        force = _parse_bool(params, "force_stop", False)
        return 200, self.cc.stop_proposal_execution(force=force)

    def _ep_pause_sampling(self, params) -> tuple[int, dict]:
        reason = params.get("reason", ["user request"])[0]
        self.cc.monitor.pause(reason)
        return 200, {"message": f"sampling paused: {reason}"}

    def _ep_resume_sampling(self, params) -> tuple[int, dict]:
        self.cc.monitor.resume()
        return 200, {"message": "sampling resumed"}

    def _ep_topic_configuration(self, params) -> tuple[int, dict]:
        topic = params.get("topic", [None])[0]
        if topic is None:
            raise BadRequest("missing parameter topic")
        rf = int(params.get("replication_factor", ["0"])[0])
        if rf < 1:
            raise BadRequest("replication_factor must be >= 1")
        dryrun = _parse_bool(params, "dryrun", True)
        return self._async_op(
            "topic_configuration",
            lambda progress: self.cc.update_topic_replication_factor(
                progress, {topic: rf}, dryrun=dryrun
            ),
        )

    def _ep_admin(self, params) -> tuple[int, dict]:
        """Reference AdminRequest: toggle self-healing, drop broker history,
        and change the concurrency of a RUNNING execution
        (servlet/parameters/AdminParameters.java:31-38 ->
        ChangeExecutionConcurrencyParameters, applied via
        executor/Executor.java:485-510)."""
        out: dict = {}
        from cruise_control_tpu_torch.detector import AnomalyType

        # validate the WHOLE request before applying any of it: a 400 must
        # not leave earlier side effects (e.g. a self-healing toggle)
        # silently committed
        conc = {}
        for pname, kwarg, cast in (
            ("concurrent_partition_movements_per_broker", "inter_broker", int),
            ("concurrent_intra_broker_partition_movements", "intra_broker", int),
            ("concurrent_leader_movements", "leadership", int),
            ("execution_progress_check_interval_ms", "progress_check_interval_s",
             lambda v: int(v) / 1000.0),
        ):
            raw = params.get(pname, [None])[0]
            if raw is not None:
                try:
                    conc[kwarg] = cast(raw)
                except (TypeError, ValueError) as e:
                    raise BadRequest(f"bad {pname}: {raw!r}") from e
        # mid-execution concurrency change first: the executor applies it
        # atomically under its lock (raising when no execution is live, so
        # an execution finishing mid-request 400s instead of 200ing a
        # silent no-op) — and a 400 here must precede the self-healing /
        # history side effects below
        if conc:
            from cruise_control_tpu_torch.executor.executor import NoOngoingExecutionError

            try:
                out["requestedConcurrency"] = (
                    self.cc.executor.set_requested_concurrency(**conc)
                )
            except (NoOngoingExecutionError, ValueError) as e:
                raise BadRequest(str(e)) from e
            # applied on the executor's next progress tick, so a live
            # rebalance can be throttled or unstuck
            out["ongoingExecution"] = True

        enable = params.get("enable_self_healing_for", [None])[0]
        disable = params.get("disable_self_healing_for", [None])[0]
        for arg, value in ((enable, True), (disable, False)):
            if arg:
                for name in arg.split(","):
                    self.cc.notifier.set_self_healing(AnomalyType[name.upper()], value)
        if enable or disable:
            out["selfHealingEnabled"] = [
                t.name for t, on in self.cc.notifier.self_healing_enabled().items() if on
            ]
        drop = params.get("drop_recently_removed_brokers", [None])[0]
        if drop:
            self.cc.executor.drop_removed_brokers(int(b) for b in drop.split(","))
            out["recentlyRemovedBrokers"] = sorted(self.cc.executor.removed_brokers)
        drop_dem = params.get("drop_recently_demoted_brokers", [None])[0]
        if drop_dem:
            self.cc.executor.drop_demoted_brokers(int(b) for b in drop_dem.split(","))
            out["recentlyDemotedBrokers"] = sorted(self.cc.executor.demoted_brokers)
        return 200, out

    def _ep_review(self, params) -> tuple[int, dict]:
        approve = params.get("approve", [None])[0]
        discard = params.get("discard", [None])[0]
        reason = params.get("reason", [""])[0]
        for arg, ok in ((approve, True), (discard, False)):
            if arg:
                for rid in arg.split(","):
                    self.purgatory.review(int(rid), ok, reason)
        return 200, {"requestInfo": self.purgatory.board()}

    # ------------------------------------------------------------------

    def start(self):
        # crash-safe execution: an execution journal-reconciled at
        # construction belongs in the operation audit trail — the operator
        # reading it learns the service came up mid-rebalance and is
        # resuming (the live detail rides /state ExecutorState.recovery).
        # Fleet mode reports EVERY cluster's reconciliation: each cluster
        # replayed its own namespaced journal at facade construction.
        facades = (
            [(ctx.cluster_id, ctx.cc) for ctx in self.fleet.contexts.values()]
            if self.fleet is not None
            else [("", self._default_cc)]
        )
        for cid, facade in facades:
            recovery = facade.executor.recovery_info()
            if recovery is not None:
                OPERATION_LOGGER.warning(
                    "executor%s recovered in-flight execution from journal: %s",
                    f" [cluster {cid}]" if cid else "",
                    recovery,
                )
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _dispatch(self, method: str):
                parsed = urllib.parse.urlparse(self.path)
                self._new_session_id = None
                if "X-Client" not in self.headers:
                    # browser flow: sticky client identity via a session
                    # cookie so header-less clients still get session->task
                    # rebind (reference servlet HTTP sessions; cookie Path
                    # from webserver.session.path)
                    from http.cookies import SimpleCookie

                    jar = SimpleCookie()
                    try:
                        jar.load(self.headers.get("Cookie", ""))
                    except Exception:  # noqa: BLE001 — malformed cookie header
                        jar = SimpleCookie()
                    if "CCSESSION" in jar:
                        self.headers["X-Client"] = "cookie:" + jar["CCSESSION"].value
                    else:
                        import uuid as _uuid

                        self._new_session_id = _uuid.uuid4().hex
                        self.headers["X-Client"] = "cookie:" + self._new_session_id
                # API paths are checked FIRST: no webserver.ui.urlprefix
                # value (e.g. an ancestor of the API prefix) may shadow an
                # API route
                if not parsed.path.startswith(app.prefix + "/"):
                    if (
                        method == "GET"
                        and app.ui_diskpath
                        and (
                            parsed.path == app.ui_prefix
                            or parsed.path.startswith(app.ui_prefix + "/")
                        )
                    ):
                        # the UI sits behind the same authentication as the
                        # API (reference: the security handler wraps the
                        # whole server), with the same login challenge
                        if app.security.authenticate(self.headers) is None:
                            self._auth_challenge(method)
                            return
                        self._serve_ui(parsed.path)
                        return
                    self._send(404, {"errorMessage": "unknown path"})
                    return
                endpoint = parsed.path[len(app.prefix) + 1:].strip("/").lower()
                params = urllib.parse.parse_qs(parsed.query)
                if method == "POST" and int(self.headers.get("Content-Length") or 0):
                    body = self.rfile.read(int(self.headers["Content-Length"])).decode()
                    params.update(urllib.parse.parse_qs(body))
                auth = app.security.authenticate(self.headers)
                if auth is None:
                    # denied attempts are the most security-relevant audit
                    # entries — log them too
                    OPERATION_LOGGER.info(
                        "%s %s by <unauthenticated> -> 401", method, endpoint
                    )
                    self._auth_challenge(method)
                    return
                principal, role = auth
                if not app.security.authorize(role, method, endpoint):
                    OPERATION_LOGGER.info(
                        "%s %s by %s(%s) -> 403", method, endpoint, principal, role
                    )
                    self._send(403, {
                        "errorMessage": f"role {role} of {principal} may not {method} {endpoint}"
                    })
                    return
                try:
                    status, payload = app.handle(method, endpoint, params, self.headers)
                except BadRequest as e:
                    status, payload = 400, {"errorMessage": str(e)}
                except KeyError as e:
                    status, payload = 404, {"errorMessage": f"not found: {e}"}
                except Exception as e:  # noqa: BLE001
                    status, payload = 500, {"errorMessage": repr(e)}
                OPERATION_LOGGER.info(
                    "%s %s by %s(%s) -> %d",
                    method, endpoint, principal, role, status,
                )
                self._user = principal
                self._send(status, payload)

            def _send(self, status: int, payload):
                if isinstance(payload, RawResponse):
                    body = payload.body.encode()
                    self.send_response(status)
                    self.send_header("Content-Type", payload.content_type)
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in app.cors_headers.items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                    if app.access_log:
                        app.access_log.log(
                            self.client_address[0], getattr(self, "_user", ""),
                            self.command, self.path, status, len(body),
                        )
                    return
                body = json.dumps(payload, default=_json_default).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in app.cors_headers.items():
                    self.send_header(k, v)
                if getattr(self, "_new_session_id", None):
                    self.send_header(
                        "Set-Cookie",
                        f"CCSESSION={self._new_session_id}; "
                        f"Path={app.session_path}; HttpOnly",
                    )
                tid = payload.get("_userTaskId") if isinstance(payload, dict) else None
                if tid:
                    self.send_header(USER_TASK_ID_HEADER, tid)
                ra = payload.get("_retryAfter") if isinstance(payload, dict) else None
                if ra is not None:
                    # 429 backoff hint (admission control / scheduler
                    # shed): standard header, integer seconds
                    self.send_header("Retry-After", str(int(ra)))
                self.end_headers()
                self.wfile.write(body)
                if app.access_log:
                    app.access_log.log(
                        self.client_address[0],
                        getattr(self, "_user", ""),
                        self.command,
                        self.path,
                        status,
                        len(body),
                    )

            def _auth_challenge(self, method: str):
                """401 with a WWW-Authenticate challenge, or a 302 to the
                configured auth provider (jwt.authentication.provider.url) —
                shared by the API and UI paths so a browser can always log
                in."""
                if app.auth_provider_url:
                    # reference jwt.authentication.provider.url: browsers
                    # are bounced to the token issuer with the original
                    # URL so they come back authenticated
                    loc = app.auth_provider_url.replace(
                        "{redirect}", urllib.parse.quote(self.path, safe="")
                    )
                    self.send_response(302)
                    self.send_header("Location", loc)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    if app.access_log:
                        app.access_log.log(
                            self.client_address[0], "", method, self.path, 302, 0
                        )
                    return
                body = json.dumps({"errorMessage": "authentication required"}).encode()
                self.send_response(401)
                self.send_header("WWW-Authenticate", 'Basic realm="cruise-control"')
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                if app.access_log:
                    app.access_log.log(
                        self.client_address[0], "", method, self.path,
                        401, len(body),
                    )

            def _serve_ui(self, path: str):
                """Static UI files (reference serves cruise-control-ui from
                webserver.ui.diskpath under webserver.ui.urlprefix)."""
                import mimetypes
                import os

                rel = path[len(app.ui_prefix):].lstrip("/") or "index.html"
                root = os.path.realpath(app.ui_diskpath)
                full = os.path.realpath(os.path.join(root, rel))
                # realpath containment defeats ../ traversal
                if not (full == root or full.startswith(root + os.sep)) or not os.path.isfile(full):
                    self._send(404, {"errorMessage": "not found"})
                    return
                with open(full, "rb") as f:
                    body = f.read()
                ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                # same cross-cutting headers as _send: the session cookie
                # (sticky session->task rebind starts at the UI) and CORS
                for k, v in app.cors_headers.items():
                    self.send_header(k, v)
                if getattr(self, "_new_session_id", None):
                    self.send_header(
                        "Set-Cookie",
                        f"CCSESSION={self._new_session_id}; "
                        f"Path={app.session_path}; HttpOnly",
                    )
                self.end_headers()
                self.wfile.write(body)
                if app.access_log:
                    app.access_log.log(
                        self.client_address[0], "", "GET", path, 200, len(body)
                    )

            def do_GET(self):  # noqa: N802
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802
                self._dispatch("POST")

            def do_OPTIONS(self):  # noqa: N802 — CORS preflight
                self.send_response(200 if app.cors_headers else 405)
                for k, v in app.cors_headers.items():
                    self.send_header(k, v)
                if app.cors_headers:
                    self.send_header(
                        "Access-Control-Allow-Headers",
                        "Authorization, Content-Type, " + USER_TASK_ID_HEADER,
                    )
                self.send_header("Content-Length", "0")
                self.end_headers()

        # TLS listener (reference KafkaCruiseControlApp.java:100-120 wraps the
        # Jetty connector in an SslContextFactory).  The handshake runs in
        # the PER-CONNECTION thread (finish_request), never the accept loop —
        # wrapping the listening socket would let one stalled client (open
        # TCP, no ClientHello) block every other request.
        ssl_ctx = None
        if self.config.get("webserver.ssl.enable"):
            import ssl

            cert = self.config.get("webserver.ssl.certificate.location")
            if not cert:
                raise ValueError(
                    "webserver.ssl.enable requires webserver.ssl.certificate.location"
                )
            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            # reference webserver.ssl.protocol (WebServerConfig:226):
            # "TLS" keeps the library default; TLSv1.2/TLSv1.3 pin a floor
            proto = (self.config.get("webserver.ssl.protocol") or "TLS").upper()
            floors = {
                "TLSV1.2": ssl.TLSVersion.TLSv1_2,
                "TLSV1.3": ssl.TLSVersion.TLSv1_3,
            }
            if proto in floors:
                ssl_ctx.minimum_version = floors[proto]
            elif proto != "TLS":
                raise ValueError(
                    f"unsupported webserver.ssl.protocol {proto!r}; "
                    "use TLS, TLSv1.2 or TLSv1.3"
                )
            ssl_ctx.load_cert_chain(
                certfile=cert,
                keyfile=self.config.get("webserver.ssl.key.location") or None,
                password=self.config.get("webserver.ssl.key.password") or None,
            )

        class Server(ThreadingHTTPServer):
            def finish_request(self, request, client_address):
                if ssl_ctx is not None:
                    import ssl

                    try:
                        request.settimeout(30)  # bound the handshake
                        request = ssl_ctx.wrap_socket(request, server_side=True)
                        request.settimeout(None)
                    except (ssl.SSLError, OSError):
                        try:
                            request.close()
                        except OSError:
                            pass
                        return
                    # socketserver's shutdown_request only sees the pre-wrap
                    # socket; close the wrapped one here (sends close_notify)
                    try:
                        self.RequestHandlerClass(request, client_address, self)
                    finally:
                        try:
                            request.close()
                        except OSError:
                            pass
                    return
                self.RequestHandlerClass(request, client_address, self)

        self._httpd = Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.user_tasks.shutdown()


def _json_default(o):
    import numpy as _np

    if isinstance(o, (_np.integer,)):
        return int(o)
    if isinstance(o, (_np.floating,)):
        return float(o)
    if isinstance(o, _np.ndarray):
        return o.tolist()
    return str(o)
