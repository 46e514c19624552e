"""cccli — command-line client for the REST API.

Reference: cruise-control-client/cruisecontrolclient/client/cccli.py:135-176
(one argparse subparser per endpoint), Endpoint.py (endpoint/parameter
object model), CCParameter/ (typed parameter validators), Responder.py /
Query.py (HTTP session + async 202 poll loop).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import urllib.parse
import urllib.request

from cruise_control_tpu_torch.service.tasks import USER_TASK_ID_HEADER


# ----------------------------------------------------------------------
# typed parameter validators (reference CCParameter/*)
# ----------------------------------------------------------------------


def boolean_param(value: str) -> str:
    if value.lower() not in ("true", "false"):
        raise argparse.ArgumentTypeError(f"{value!r} is not true/false")
    return value.lower()

def csv_int_param(value: str) -> str:
    if not re.fullmatch(r"\d+(,\d+)*", value):
        raise argparse.ArgumentTypeError(f"{value!r} is not a comma-separated id list")
    return value


def positive_int_param(value: str) -> str:
    if not value.isdigit() or int(value) <= 0:
        raise argparse.ArgumentTypeError(f"{value!r} is not a positive integer")
    return value


def json_param(value: str) -> str:
    """Inline JSON, or @path to read it from a file (scenario documents
    are unwieldy on a command line)."""
    if value.startswith("@"):
        try:
            with open(value[1:]) as f:
                value = f.read()
        except OSError as e:
            raise argparse.ArgumentTypeError(f"cannot read {value[1:]!r}: {e}") from e
    try:
        json.loads(value)
    except json.JSONDecodeError as e:
        raise argparse.ArgumentTypeError(f"not valid JSON: {e}") from e
    return value


# ----------------------------------------------------------------------
# endpoint model (reference Endpoint.py)
# ----------------------------------------------------------------------


ENDPOINTS: dict[str, dict] = {
    # dest -> {method, endpoint, params: {flag: (param, type)}}
    "state": {"method": "GET", "endpoint": "state",
              "params": {"--substates": ("substates", str)}},
    "kafka_cluster_state": {"method": "GET", "endpoint": "kafka_cluster_state", "params": {}},
    "load": {"method": "GET", "endpoint": "load", "params": {}},
    "partition_load": {"method": "GET", "endpoint": "partition_load",
                       "params": {"--resource": ("resource", str),
                                  "--entries": ("entries", positive_int_param)}},
    "proposals": {"method": "GET", "endpoint": "proposals",
                  "params": {"--ignore-proposal-cache": ("ignore_proposal_cache", boolean_param)}},
    "user_tasks": {"method": "GET", "endpoint": "user_tasks",
                   "params": {"--user-task-ids": ("user_task_ids", str),
                              "--client-ids": ("client_ids", str),
                              "--endpoints": ("endpoints", str),
                              "--types": ("types", str),
                              "--fetch-completed-task": ("fetch_completed_task", boolean_param)}},
    "review_board": {"method": "GET", "endpoint": "review_board", "params": {}},
    "bootstrap": {"method": "GET", "endpoint": "bootstrap", "params": {}},
    "train": {"method": "GET", "endpoint": "train", "params": {}},
    "rebalance": {"method": "POST", "endpoint": "rebalance",
                  "params": {"--dryrun": ("dryrun", boolean_param),
                             "--goals": ("goals", str),
                             "--destination-broker-ids": ("destination_broker_ids", csv_int_param),
                             "--excluded-topics": ("excluded_topics", str),
                             "--rebalance-disk": ("rebalance_disk", boolean_param),
                             "--allow-capacity-estimation": ("allow_capacity_estimation", boolean_param),
                             "--exclude-recently-removed-brokers": ("exclude_recently_removed_brokers", boolean_param),
                             "--exclude-recently-demoted-brokers": ("exclude_recently_demoted_brokers", boolean_param),
                             "--replica-movement-strategies": ("replica_movement_strategies", str),
                             "--reason": ("reason", str),
                             "--review-id": ("review_id", positive_int_param)}},
    "add_broker": {"method": "POST", "endpoint": "add_broker",
                   "params": {"--brokers": ("brokerid", csv_int_param),
                              "--dryrun": ("dryrun", boolean_param)},
                   "required": ["--brokers"]},
    "remove_broker": {"method": "POST", "endpoint": "remove_broker",
                      "params": {"--brokers": ("brokerid", csv_int_param),
                                 "--dryrun": ("dryrun", boolean_param)},
                      "required": ["--brokers"]},
    "demote_broker": {"method": "POST", "endpoint": "demote_broker",
                      "params": {"--brokers": ("brokerid", csv_int_param),
                                 "--dryrun": ("dryrun", boolean_param)},
                      "required": ["--brokers"]},
    "fix_offline_replicas": {"method": "POST", "endpoint": "fix_offline_replicas",
                             "params": {"--dryrun": ("dryrun", boolean_param)}},
    "stop_proposal_execution": {"method": "POST", "endpoint": "stop_proposal_execution",
                                "params": {"--force": ("force_stop", boolean_param)}},
    "pause_sampling": {"method": "POST", "endpoint": "pause_sampling",
                       "params": {"--reason": ("reason", str)}},
    "resume_sampling": {"method": "POST", "endpoint": "resume_sampling", "params": {}},
    "topic_configuration": {"method": "POST", "endpoint": "topic_configuration",
                            "params": {"--topic": ("topic", str),
                                       "--replication-factor": ("replication_factor", positive_int_param),
                                       "--dryrun": ("dryrun", boolean_param)},
                            "required": ["--topic", "--replication-factor"]},
    "admin": {"method": "POST", "endpoint": "admin",
              "params": {"--enable-self-healing-for": ("enable_self_healing_for", str),
                         "--disable-self-healing-for": ("disable_self_healing_for", str),
                         "--drop-recently-removed-brokers": ("drop_recently_removed_brokers", csv_int_param),
                         "--drop-recently-demoted-brokers": ("drop_recently_demoted_brokers", csv_int_param),
                         # mid-execution concurrency control (reference
                         # AdminParameters ChangeExecutionConcurrency)
                         "--concurrent-partition-movements-per-broker":
                             ("concurrent_partition_movements_per_broker", positive_int_param),
                         "--concurrent-intra-broker-partition-movements":
                             ("concurrent_intra_broker_partition_movements", positive_int_param),
                         "--concurrent-leader-movements":
                             ("concurrent_leader_movements", positive_int_param),
                         "--execution-progress-check-interval-ms":
                             ("execution_progress_check_interval_ms", positive_int_param)}},
    "review": {"method": "POST", "endpoint": "review",
               "params": {"--approve": ("approve", csv_int_param),
                          "--discard": ("discard", csv_int_param),
                          "--reason": ("reason", str)}},
    # scenario planner (read-only what-if analysis)
    "simulate": {"method": "POST", "endpoint": "simulate",
                 "params": {"--scenarios": ("scenarios", json_param),
                            "--optimize": ("optimize", boolean_param),
                            "--allow-capacity-estimation":
                                ("allow_capacity_estimation", boolean_param),
                            "--reason": ("reason", str),
                            "--review-id": ("review_id", positive_int_param)},
                 "required": ["--scenarios"]},
    "rightsize": {"method": "GET", "endpoint": "rightsize",
                  "params": {"--horizon-ms": ("horizon_ms", positive_int_param),
                             "--min-brokers": ("min_brokers", positive_int_param),
                             "--max-broker-factor": ("max_broker_factor", str),
                             "--allow-capacity-estimation":
                                 ("allow_capacity_estimation", boolean_param)}},
    # observability: flight-recorder replay + Prometheus exposition.
    # `cccli trace` lists recent root traces; `cccli trace --id <traceId>`
    # (the _traceId of any async response, or a TraceId from user_tasks)
    # replays the span tree; `cccli trace --blackbox true` additionally
    # embeds the on-disk black-box dispatch spool (tail + in-flight
    # dispatches — the durable twin of the in-memory store).  `cccli
    # metrics` prints the exposition text verbatim (NOT JSON) — pipe it
    # to promtool or grep; `--format openmetrics` adds trace-id
    # exemplars on histogram buckets.
    "trace": {"method": "GET", "endpoint": "trace",
              "params": {"--id": ("id", str),
                         "--limit": ("limit", positive_int_param),
                         "--blackbox": ("blackbox", boolean_param)}},
    "metrics": {"method": "GET", "endpoint": "metrics",
                "params": {"--format": ("format", str)}},
    # SLO registry: burn rates, compliance and breach episodes per
    # cluster (`cccli slo`; pair with the global --cluster flag to
    # filter one cluster of a fleet)
    "slo": {"method": "GET", "endpoint": "slo", "params": {}},
    # decision ledger (analyzer/ledger.py).  `cccli explain --trace-id
    # <id>` (the _traceId of any async response) or `--proposal <id>`
    # replays one decision→outcome→calibration episode as a structured
    # explanation; `cccli ledger` prints the raw joined episode stream
    # newest-first.  Both are raw-JSON passthrough and route to one
    # cluster of a fleet with the global -c/--cluster flag, exactly like
    # `trace`/`slo`.
    "explain": {"method": "GET", "endpoint": "explain",
                "params": {"--trace-id": ("trace_id", str),
                           "--proposal": ("proposal", str)}},
    "ledger": {"method": "GET", "endpoint": "ledger",
               "params": {"--limit": ("limit", positive_int_param)}},
    # fleet controller: whole-instance rollup (`cccli fleet`); pair the
    # other subcommands with the global --cluster flag to target one
    # cluster of a fleet (e.g. `cccli --cluster east rebalance`)
    "fleet": {"method": "GET", "endpoint": "fleet",
              "params": {"--score": ("score", boolean_param)}},
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cccli", description="cruise-control-tpu command line client"
    )
    p.add_argument("-a", "--socket-address", default="http://127.0.0.1:9090",
                   help="host:port of the cruise-control server")
    p.add_argument("--prefix", default="/kafkacruisecontrol")
    p.add_argument("-u", "--user", default=None, metavar="USER:PASSWORD",
                   help="basic-auth credentials (reference BasicSecurityProvider)")
    p.add_argument("--token", default=None,
                   help="JWT bearer token (reference JwtSecurityProvider)")
    p.add_argument("--insecure", action="store_true",
                   help="skip TLS certificate verification (self-signed servers)")
    p.add_argument("-c", "--cluster", default=None,
                   help="fleet cluster id the request targets (fleet "
                        "deployments; rides every endpoint as cluster=)")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--json-indent", type=int, default=2)
    sub = p.add_subparsers(dest="dest", required=True,
                           metavar="{" + ",".join(sorted(ENDPOINTS)) + "}")
    for dest, spec in ENDPOINTS.items():
        sp = sub.add_parser(dest)
        required = set(spec.get("required", ()))
        for flag, (param, typ) in spec["params"].items():
            sp.add_argument(flag, dest=param, type=typ, required=flag in required)
    return p


class Client:
    """HTTP session with the async 202 poll loop (reference Responder.py)."""

    def __init__(self, base: str, prefix: str, *, poll_interval=1.0, timeout=600.0,
                 user: str | None = None, token: str | None = None,
                 insecure: bool = False):
        if not base.startswith("http"):
            base = "http://" + base
        self.base = base.rstrip("/") + prefix
        self.poll_interval = poll_interval
        self.timeout = timeout
        self._auth: dict[str, str] = {}
        if token:
            self._auth["Authorization"] = f"Bearer {token}"
        elif user:
            import base64

            self._auth["Authorization"] = (
                "Basic " + base64.b64encode(user.encode()).decode()
            )
        self._ssl_ctx = None
        if insecure:
            import ssl

            self._ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            self._ssl_ctx.check_hostname = False
            self._ssl_ctx.verify_mode = ssl.CERT_NONE

    def request(self, method: str, endpoint: str, params: dict) -> dict:
        query = urllib.parse.urlencode({k: v for k, v in params.items() if v is not None})
        url = f"{self.base}/{endpoint}" + (f"?{query}" if query else "")
        headers: dict[str, str] = dict(self._auth)
        deadline = time.time() + self.timeout
        while True:
            req = urllib.request.Request(url, method=method, headers=headers)
            with urllib.request.urlopen(req, timeout=60, context=self._ssl_ctx) as resp:
                body = resp.read()
                ctype = resp.headers.get("Content-Type", "")
                if not ctype.startswith("application/json"):
                    # raw-text endpoint (/metrics Prometheus exposition):
                    # pass the body through verbatim
                    return body.decode()
                payload = json.loads(body)
                if resp.status != 202:
                    return payload
                tid = resp.headers.get(USER_TASK_ID_HEADER) or payload.get("_userTaskId")
                headers[USER_TASK_ID_HEADER] = tid
            if time.time() > deadline:
                raise TimeoutError(f"operation still running; resume with {tid}")
            for step in payload.get("progress", []):
                print(
                    f"  [{step['completionPercentage']:5.1f}%] {step['step']}",
                    file=sys.stderr,
                )
            time.sleep(self.poll_interval)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    spec = ENDPOINTS[args.dest]
    params = {
        param: getattr(args, param, None)
        for _, (param, _t) in spec["params"].items()
    }
    if args.cluster:
        params["cluster"] = args.cluster
    client = Client(args.socket_address, args.prefix,
                    poll_interval=args.poll_interval, timeout=args.timeout,
                    user=args.user, token=args.token, insecure=args.insecure)
    try:
        result = client.request(spec["method"], spec["endpoint"], params)
    except urllib.error.HTTPError as e:
        print(json.dumps(json.loads(e.read() or b"{}"), indent=args.json_indent))
        return 1
    if isinstance(result, str):
        print(result, end="" if result.endswith("\n") else "\n")
    else:
        print(json.dumps(result, indent=args.json_indent))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
