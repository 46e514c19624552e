"""Declared request parameters per endpoint + pluggable override maps.

Reference: config/constants/CruiseControlParametersConfig.java:1 and
CruiseControlRequestConfig.java:1 — every endpoint maps to a parameters
class (which declares and validates its query parameters) and a request
class (which executes it), BOTH overridable per endpoint through config
({endpoint}.parameters.class / {endpoint}.request.class).

Here each endpoint declares its parameter set as data; `parse` validates
types and REJECTS unknown parameters (the reference 400s unrecognized
params — silently ignoring a typo like `dry_run` executes a rebalance the
caller believed was a dry run).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable


class ParameterError(ValueError):
    pass


def _bool(s: str):
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise ParameterError(f"expected boolean, got {s!r}")


def _int(s: str):
    return int(s)


def _float(s: str):
    return float(s)


def _int_list(s: str):
    return [int(x) for x in s.split(",") if x != ""]


def _str_list(s: str):
    return [x for x in s.split(",") if x]


def _regex(s: str):
    re.compile(s)  # validation only; handlers re-compile as needed
    return s


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    parse: Callable[[str], object]
    doc: str = ""


@dataclasses.dataclass(frozen=True)
class EndpointParameters:
    """Declared parameter set for one endpoint (the reference's
    *Parameters class).  Subclass / replace via {endpoint}.parameters.class
    to accept custom parameters."""

    endpoint: str
    params: tuple

    def parse(self, raw: dict) -> dict:
        """raw: urllib parse_qs dict.  Validates every value; unknown
        parameter names are rejected."""
        by_name = {p.name: p for p in self.params}
        out = {}
        for name, values in raw.items():
            p = by_name.get(name)
            if p is None:
                raise ParameterError(
                    f"unknown parameter {name!r} for {self.endpoint} "
                    f"(accepted: {sorted(by_name)})"
                )
            try:
                out[name] = p.parse(values[0])
            except ParameterError:
                raise
            except (ValueError, TypeError) as e:
                raise ParameterError(f"bad {name}: {e}") from e
        return out


def _min1_int(s: str):
    v = int(s)
    if not v >= 1:  # also rejects NaN-shaped junk; a 0 cap stalls the executor
        raise ParameterError(f"must be >= 1, got {v}")
    return v


def _min1_float(s: str):
    v = float(s)
    if not v >= 1:
        raise ParameterError(f"must be >= 1, got {v}")
    return v


def _scenario_list(s: str):
    """JSON scenario list for /simulate — validated structurally HERE so a
    malformed scenario 400s before a cluster model is built for it."""
    import json

    from cruise_control_tpu_torch.planner.scenario import Scenario

    try:
        raw = json.loads(s)
    except json.JSONDecodeError as e:
        raise ParameterError(f"scenarios is not valid JSON: {e}") from e
    if isinstance(raw, dict):
        raw = [raw]
    if not isinstance(raw, list) or not raw:
        raise ParameterError("scenarios must be a non-empty JSON list of objects")
    try:
        return [Scenario.from_json(d) for d in raw]
    except (TypeError, ValueError, KeyError) as e:
        raise ParameterError(f"bad scenario: {e}") from e


# bounds MATCH server._parse_execution_overrides — the declared parser is
# what custom request classes consume, so the two layers must agree
_STRATEGIES = Param(
    "replica_movement_strategies", _str_list,
    "ordered strategy names from the replica.movement.strategies pool",
)
_EXECUTION = (
    Param("concurrent_partition_movements_per_broker", _min1_int),
    Param("concurrent_leader_movements", _min1_int),
    Param("replication_throttle", _min1_float),
    _STRATEGIES,
)
_DRYRUN = Param("dryrun", _bool)
_REVIEW_ID = Param("review_id", _int, "two-step verification approval id")
_REASON = Param("reason", str)
#: fleet routing: every endpoint accepts `cluster` (appended below, like
#: `reason`).  Single-cluster deployments reject any value (no fleet
#: configured); in fleet mode cluster-scoped endpoints require it and the
#: fleet-global ones (fleet/metrics/trace/user_tasks/review_board/review)
#: treat it as an optional filter
_CLUSTER = Param("cluster", str, "fleet cluster id the request targets")

#: the builtin parameter map (reference CruiseControlParametersConfig's
#: DEFAULT_* constants tree).  Every POST endpoint accepts `reason`
#: (enforced when request.reason.required is on; feeds the audit log).
_RAW_PARAMETERS: dict[str, tuple] = {
        "bootstrap": (Param("start", _int), Param("end", _int),
                      Param("clearmetrics", _bool)),
        "train": (Param("start", _int), Param("end", _int)),
        "load": (Param("allow_capacity_estimation", _bool),),
        "partition_load": (Param("resource", str), Param("entries", _int),
                           Param("allow_capacity_estimation", _bool)),
        "proposals": (Param("ignore_proposal_cache", _bool),
                      Param("allow_capacity_estimation", _bool)),
        "state": (Param("substates", _str_list),),
        "kafka_cluster_state": (),
        "user_tasks": (Param("user_task_ids", _str_list),
                       Param("client_ids", _str_list),
                       Param("endpoints", _str_list),
                       Param("types", _str_list),
                       Param("clusters", _str_list),
                       Param("fetch_completed_task", _bool)),
        "review_board": (Param("review_ids", _int_list),),
        "add_broker": (Param("brokerid", _int_list), _DRYRUN, _REVIEW_ID,
                       *_EXECUTION),
        "remove_broker": (Param("brokerid", _int_list), _DRYRUN, _REVIEW_ID,
                          *_EXECUTION),
        "fix_offline_replicas": (_DRYRUN, _REVIEW_ID, *_EXECUTION),
        "rebalance": (_DRYRUN, Param("goals", _str_list),
                      Param("destination_broker_ids", _int_list),
                      Param("excluded_topics", _regex),
                      Param("rebalance_disk", _bool),
                      Param("allow_capacity_estimation", _bool),
                      Param("exclude_recently_removed_brokers", _bool),
                      Param("exclude_recently_demoted_brokers", _bool),
                      _REVIEW_ID, *_EXECUTION),
        "stop_proposal_execution": (Param("force_stop", _bool), _REVIEW_ID),
        "pause_sampling": (_REASON, _REVIEW_ID),
        "resume_sampling": (_REASON, _REVIEW_ID),
        "demote_broker": (Param("brokerid", _int_list), _DRYRUN, _REVIEW_ID),
        "admin": (Param("enable_self_healing_for", _str_list),
                  Param("disable_self_healing_for", _str_list),
                  Param("drop_recently_removed_brokers", _int_list),
                  Param("drop_recently_demoted_brokers", _int_list),
                  # mid-execution concurrency change (reference
                  # AdminParameters.java:31-38)
                  Param("concurrent_partition_movements_per_broker", _min1_int),
                  Param("concurrent_intra_broker_partition_movements", _min1_int),
                  Param("concurrent_leader_movements", _min1_int),
                  Param("execution_progress_check_interval_ms", _min1_int),
                  _REVIEW_ID),
        "review": (Param("approve", _int_list), Param("discard", _int_list),
                   _REASON),
        "topic_configuration": (Param("topic", str),
                                Param("replication_factor", _int), _DRYRUN,
                                _REVIEW_ID),
        # --- scenario planner (read-only what-if analysis) ---
        "simulate": (Param("scenarios", _scenario_list,
                           "JSON list of scenario objects (see docs/rest-api.md)"),
                     Param("optimize", _bool,
                           "also run the full anneal per scenario (projected "
                           "post-fix view; slower)"),
                     Param("allow_capacity_estimation", _bool),
                     _REVIEW_ID),
        "rightsize": (Param("horizon_ms", _min1_int,
                            "also rightsize at the load forecast this far out"),
                      Param("min_brokers", _min1_int),
                      Param("max_broker_factor", _min1_float),
                      Param("allow_capacity_estimation", _bool)),
        # --- observability (flight recorder + Prometheus exposition) ---
        "trace": (Param("id", str,
                        "trace id to replay (from _traceId of an async "
                        "response); omit to list recent root traces"),
                  Param("limit", _min1_int,
                        "max recent traces listed without id (default 50)"),
                  Param("blackbox", _bool,
                        "also embed the black-box dispatch spool's tail + "
                        "in-flight dispatches (common/blackbox.py) — the "
                        "durable twin of the in-memory trace store")),
        "metrics": (Param("format", str,
                          "'openmetrics' renders the OpenMetrics flavor "
                          "with per-bucket trace-id exemplars (also "
                          "negotiated via the Accept header)"),),
        "slo": (),
        # --- decision ledger (analyzer/ledger.py) ---
        "explain": (Param("trace_id", str,
                          "flight-recorder trace id of the decision to "
                          "explain (the _traceId of the async response "
                          "that computed it)"),
                    Param("proposal", str,
                          "ledger decision id to explain (from GET "
                          "/ledger or a decision record)")),
        "ledger": (Param("limit", _min1_int,
                         "max joined decision→outcome→calibration "
                         "episodes returned, newest first (default 50)"),),
        # --- fleet controller (whole-instance rollup) ---
        "fleet": (Param("score", _bool,
                        "also batch-score every cluster's current placement "
                        "on the shared goal chain (same-bucket clusters ride "
                        "one device dispatch); slower"),),
}

from cruise_control_tpu_torch.config.endpoints import (  # noqa: E402
    ALL_ENDPOINTS,
    POST_ENDPOINTS,
)

def _with_cross_cutting(ep: str, params: tuple) -> tuple:
    """Append the cross-cutting params every endpoint accepts: `reason` on
    POSTs (audit trail) and `cluster` everywhere (fleet routing)."""
    if ep in POST_ENDPOINTS and not any(p.name == "reason" for p in params):
        params = (*params, _REASON)
    return (*params, _CLUSTER)


ENDPOINT_PARAMETERS: dict[str, EndpointParameters] = {
    ep: EndpointParameters(ep, _with_cross_cutting(ep, params))
    for ep, params in _RAW_PARAMETERS.items()
}


# the canonical endpoint list and this registry must agree — a new
# endpoint without declared parameters would silently skip validation

assert set(ENDPOINT_PARAMETERS) == set(ALL_ENDPOINTS), (
    set(ENDPOINT_PARAMETERS) ^ set(ALL_ENDPOINTS)
)


def build_override_maps(config) -> tuple[dict, dict]:
    """(parameter parsers, request handlers) per endpoint from config.

    {endpoint}.parameters.class (T.CLASS, resolved by the config layer)
    is called with (endpoint, builtin: EndpointParameters) and must expose
    .parse(raw) — the builtin instance is passed so overrides can extend
    rather than re-declare.  {endpoint}.request.class is called as
    (app, endpoint, parsed_params) -> (status, payload).  Unset keys keep
    the builtins.
    """
    from cruise_control_tpu_torch.config.endpoints import reference_key_name

    parsers: dict[str, object] = dict(ENDPOINT_PARAMETERS)
    handlers: dict[str, object] = {}
    for ep in ENDPOINT_PARAMETERS:
        ref = reference_key_name(ep)

        def _get(kind: str):
            # our spelling wins; the reference's dotted spelling is accepted
            v = config.get(f"{ep}.{kind}.class")
            if v is None and ref != ep:
                v = config.get(f"{ref}.{kind}.class")
            return v

        p_cls = _get("parameters")
        if p_cls:
            parsers[ep] = p_cls(ep, ENDPOINT_PARAMETERS[ep])
        r_cls = _get("request")
        if r_cls:
            handlers[ep] = r_cls
    return parsers, handlers
