"""Canonical REST endpoint names — a LEAF module.

The single source of truth consumed by the server's dispatch tables, the
parameter registry, the response-schema registry, and the config defs
({endpoint}.parameters.class / .request.class keys).  Lives in the config
layer so building a CruiseControlConfig never imports the service package
(app_config.py guards that layering: module imports here close cycles
through package __init__s).
"""

GET_ENDPOINTS = (
    "bootstrap", "train", "load", "partition_load", "proposals", "state",
    "kafka_cluster_state", "user_tasks", "review_board", "rightsize",
    "trace", "metrics", "fleet", "slo", "explain", "ledger",
)

#: endpoints that are fleet-GLOBAL: in fleet mode they answer for the
#: whole instance (rollups, shared stores) and never require `cluster=`;
#: every other endpoint is cluster-scoped and must name its cluster
FLEET_GLOBAL_ENDPOINTS = frozenset(
    {"fleet", "metrics", "trace", "user_tasks", "review_board", "review",
     "slo"}
)
POST_ENDPOINTS = (
    "add_broker", "remove_broker", "fix_offline_replicas", "rebalance",
    "stop_proposal_execution", "pause_sampling", "resume_sampling",
    "demote_broker", "admin", "review", "topic_configuration", "simulate",
)
ALL_ENDPOINTS = GET_ENDPOINTS + POST_ENDPOINTS

#: endpoint category (reference CruiseControlEndPoint.java:17-36) — drives
#: the per-category completed-user-task caches/retention
#: (config/constants/UserTaskManagerConfig.java)
ENDPOINT_TYPES = {
    "bootstrap": "CRUISE_CONTROL_ADMIN",
    "train": "CRUISE_CONTROL_ADMIN",
    "load": "KAFKA_MONITOR",
    "partition_load": "KAFKA_MONITOR",
    "proposals": "KAFKA_MONITOR",
    "state": "CRUISE_CONTROL_MONITOR",
    "add_broker": "KAFKA_ADMIN",
    "remove_broker": "KAFKA_ADMIN",
    "fix_offline_replicas": "KAFKA_ADMIN",
    "rebalance": "KAFKA_ADMIN",
    "stop_proposal_execution": "KAFKA_ADMIN",
    "pause_sampling": "CRUISE_CONTROL_ADMIN",
    "resume_sampling": "CRUISE_CONTROL_ADMIN",
    "kafka_cluster_state": "KAFKA_MONITOR",
    "demote_broker": "KAFKA_ADMIN",
    "user_tasks": "CRUISE_CONTROL_MONITOR",
    "review_board": "CRUISE_CONTROL_MONITOR",
    "admin": "CRUISE_CONTROL_ADMIN",
    "review": "CRUISE_CONTROL_ADMIN",
    "topic_configuration": "KAFKA_ADMIN",
    # planner endpoints are read-only analysis over the monitor's model
    "simulate": "KAFKA_MONITOR",
    "rightsize": "KAFKA_MONITOR",
    # observability: trace replay + Prometheus exposition (both read-only)
    "trace": "CRUISE_CONTROL_MONITOR",
    "metrics": "CRUISE_CONTROL_MONITOR",
    # fleet controller: whole-instance rollup over every managed cluster
    "fleet": "CRUISE_CONTROL_MONITOR",
    # SLO registry: burn rates + episode state (read-only)
    "slo": "CRUISE_CONTROL_MONITOR",
    # decision ledger: structured explanation of one published/executed
    # proposal, and the raw joined episode stream (both read-only;
    # cluster-scoped — each cluster owns its own ledger)
    "explain": "CRUISE_CONTROL_MONITOR",
    "ledger": "CRUISE_CONTROL_MONITOR",
}
assert set(ENDPOINT_TYPES) == set(ALL_ENDPOINTS)


def reference_key_name(endpoint: str) -> str:
    """The reference's dotted endpoint spelling for {endpoint}.parameters.class
    / .request.class keys (CruiseControlParametersConfig.java uses e.g.
    add.broker.parameters.class, stop.proposal.request.class)."""
    if endpoint == "stop_proposal_execution":
        return "stop.proposal"
    return endpoint.replace("_", ".")
