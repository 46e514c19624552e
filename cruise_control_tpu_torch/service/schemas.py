"""Declared response schemas for every REST endpoint.

Reference: servlet/response/JsonResponseField.java:1 annotates every
response class's fields and ResponseTest.java:1 asserts each response
declares its schema — API drift fails a test instead of surprising
clients.  Here the declaration is data (FIELDS per endpoint) and
`validate_response` is the single checker the schema test drives against
a LIVE service (tests/test_schemas.py).

A schema lists top-level fields: (name, types, required).  `item_schema`
validates dict items of list fields one level down.  Endpoints whose
successful body is an operation summary share OPTIMIZATION_RESULT.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    types: tuple
    required: bool = True
    item_schema: "Schema | None" = None  # for list fields holding dicts


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple
    #: False -> unknown top-level keys are schema violations
    allow_extra: bool = False

    def field_names(self):
        return {f.name for f in self.fields}


NUM = (int, float)
STR = (str,)
BOOL = (bool,)
LIST = (list,)
DICT = (dict,)

PROPOSAL_ITEM = Schema((
    Field("topicPartition", DICT),
    Field("oldLeader", NUM),
    Field("oldReplicas", LIST),
    Field("newReplicas", LIST),
))

#: shared summary of every optimization-shaped response
#: (OptimizerResult.summary() + facade additions)
OPTIMIZATION_RESULT = Schema((
    Field("numReplicaMovements", NUM),
    Field("numLeaderMovements", NUM),
    Field("dataToMoveMB", NUM),
    Field("balancednessBefore", NUM),
    Field("balancednessAfter", NUM),
    Field("objectiveBefore", NUM),
    Field("objectiveAfter", NUM),
    Field("violatedGoalsAfter", LIST),
    Field("wallSeconds", NUM),
    # true when the supervisor breaker routed this answer through the CPU
    # greedy fallback (docs/architecture.md "Degraded mode")
    Field("degraded", BOOL),
    # per-phase execution ETA derived from data-to-move over the active
    # caps/throttle (facade._execution_eta); absent on demote (leader-only)
    Field("estimatedExecutionTime", DICT, required=False),
    Field("proposals", LIST, item_schema=PROPOSAL_ITEM),
    Field("execution", DICT, required=False),
    Field("_userTaskId", STR, required=False),
))

BROKER_LOAD_ITEM = Schema((
    Field("Broker", NUM),
    Field("BrokerState", STR),
    Field("Leaders", NUM),
    Field("Replicas", NUM),
    Field("CPU", NUM), Field("CPUPct", NUM),
    Field("DISK", NUM), Field("DISKPct", NUM),
    Field("NW_IN", NUM), Field("NW_INPct", NUM),
    Field("NW_OUT", NUM), Field("NW_OUTPct", NUM),
))

#: one scenario's outcome in the /simulate response
#: (analyzer/scenario_eval.py ScenarioOutcome.to_json)
SCENARIO_OUTCOME_ITEM = Schema((
    Field("name", STR),
    Field("objective", NUM),
    Field("violatedGoals", LIST),
    Field("balancedness", NUM),
    Field("hardGoalsSatisfied", BOOL),
    Field("brokersAlive", NUM),
    # present when optimize=true: OptimizerResult.summary() + hard-goal
    # verdict for the projected post-fix cluster
    Field("fix", DICT, required=False),
))

#: one annealed candidate in the /rightsize response
RIGHTSIZE_CANDIDATE_ITEM = Schema((
    Field("brokers", NUM),
    Field("feasible", BOOL),
    Field("violatedHardGoals", LIST),
    Field("objectiveAfter", NUM),
    Field("numMoves", NUM),
))

RESPONSE_SCHEMAS: dict[str, Schema] = {
    "state": Schema((
        Field("version", NUM, required=False),  # API-version negotiation
        Field("MonitorState", DICT, required=False),
        Field("ExecutorState", DICT, required=False),
        Field("AnalyzerState", DICT, required=False),
        # streaming-controller block (controller/streaming.py), present
        # only when controller.enabled
        Field("ControllerState", DICT, required=False),
        Field("AnomalyDetectorState", DICT, required=False),
        Field("Sensors", DICT, required=False),
    )),
    "kafka_cluster_state": Schema((
        Field("KafkaBrokerState", DICT),
        Field("KafkaPartitionState", DICT),
    )),
    "load": Schema((
        Field("brokers", LIST, item_schema=BROKER_LOAD_ITEM),
        Field("hosts", LIST),
        Field("_userTaskId", STR, required=False),
    )),
    "partition_load": Schema((
        Field("records", LIST),
        Field("resource", STR),
        Field("_userTaskId", STR, required=False),
    )),
    "proposals": OPTIMIZATION_RESULT,
    "rebalance": OPTIMIZATION_RESULT,
    "add_broker": OPTIMIZATION_RESULT,
    "remove_broker": Schema(
        tuple(f for f in OPTIMIZATION_RESULT.fields if f.name != "proposals")
    ),
    "fix_offline_replicas": OPTIMIZATION_RESULT,
    "demote_broker": Schema((
        Field("numLeaderMovements", NUM),
        Field("proposals", LIST, item_schema=PROPOSAL_ITEM),
        Field("execution", DICT, required=False),
        Field("_userTaskId", STR, required=False),
    )),
    "topic_configuration": Schema((
        Field("numProposals", NUM),
        Field("proposals", LIST, item_schema=PROPOSAL_ITEM),
        Field("execution", DICT, required=False),
        Field("_userTaskId", STR, required=False),
    )),
    "user_tasks": Schema((
        Field("userTasks", LIST, item_schema=Schema((
            Field("UserTaskId", STR),
            Field("RequestURL", STR),
            Field("ClientIdentity", STR),
            Field("Status", STR),
            Field("StartMs", NUM),
            # flight-recorder trace id of the operation (empty when
            # tracing is disabled)
            Field("TraceId", STR, required=False),
            # fleet cluster the operation targeted (empty single-cluster)
            Field("Cluster", STR, required=False),
        ))),
    )),
    "review_board": Schema((Field("requestInfo", LIST),)),
    "review": Schema((Field("requestInfo", LIST),)),
    "bootstrap": Schema((
        Field("mode", STR),
        Field("samplesAbsorbed", NUM),
        Field("monitorState", STR),
        Field("bootstrapProgressPct", NUM),
        Field("trainingState", DICT),
        Field("totalSamples", NUM),
        Field("_userTaskId", STR, required=False),
    )),
    "train": Schema((
        Field("trained", BOOL),
        Field("_userTaskId", STR, required=False),
    ), allow_extra=True),  # regression state keys are the model's business
    "stop_proposal_execution": Schema((
        Field("message", STR),
        Field("force", BOOL),
    )),
    "pause_sampling": Schema((Field("message", STR),)),
    "resume_sampling": Schema((Field("message", STR),)),
    "admin": Schema((
        Field("selfHealingEnabled", LIST, required=False),
        Field("recentlyRemovedBrokers", LIST, required=False),
        Field("recentlyDemotedBrokers", LIST, required=False),
        # mid-execution concurrency change acknowledgment
        Field("requestedConcurrency", DICT, required=False),
        Field("ongoingExecution", BOOL, required=False),
    )),
    # --- scenario planner ---
    "simulate": Schema((
        Field("scenarios", LIST, item_schema=SCENARIO_OUTCOME_ITEM),
        # the unmutated cluster scored the same way, for contrast
        Field("baseline", DICT),
        # true when the device breaker routed scoring through the CPU path
        Field("degraded", BOOL),
        Field("wallSeconds", NUM),
        Field("_userTaskId", STR, required=False),
    )),
    "rightsize": Schema((
        Field("provisionStatus", STR),
        Field("currentBrokers", NUM),
        Field("minBrokers", NUM),  # null when the search ended UNDECIDED
        # UNDECIDED only: feasible count the unfinished search proved
        Field("minBrokersUpperBound", NUM),
        Field("searchedRange", LIST),
        Field("annealsRun", NUM),
        Field("undecided", BOOL),
        Field("degraded", BOOL),
        Field("preMoveViolations", DICT),
        Field("candidates", LIST, item_schema=RIGHTSIZE_CANDIDATE_ITEM),
        Field("loadScenario", DICT, required=False),
        # fitted trend scenarios at the planner.forecast.horizons.ms
        # horizons (no extra anneals; empty without enough history)
        Field("forecastOutlook", LIST),
        Field("forecast", DICT, required=False),
        Field("wallSeconds", NUM),
        Field("_userTaskId", STR, required=False),
    )),
    # --- observability ---
    # GET /trace: with ?id= the replayed span forest; without, an index of
    # recent root traces.  Exactly one of the two shapes appears.
    "trace": Schema((
        Field("traceId", STR, required=False),
        Field("spans", LIST, required=False),
        Field("traces", LIST, required=False),
        # ?blackbox=true: the on-disk dispatch spool's state/tail/
        # in-flight view (common/blackbox.py)
        Field("blackbox", DICT, required=False),
    )),
    # GET /metrics is TEXT (Prometheus exposition 0.0.4), not JSON — the
    # schema entry satisfies the full-coverage gate; the body itself is
    # validated by the exposition lint parser (common/exposition.py,
    # scripts/check.sh gate)
    "metrics": Schema((), allow_extra=True),
    # --- fleet controller ---
    # GET /fleet: whole-instance rollup — per-cluster summaries under
    # `clusters` (each carrying an `ownership` block in fleet-HA mode),
    # the shared-core view (engine cache, supervisor, admission control)
    # under `shared`, with ?score=true the batched per-cluster placement
    # scores under `scores`, and in fleet-HA mode the instance's lease
    # view (instanceId, ttl/renew/skew, ownedClusters) under `ha`
    "fleet": Schema((
        Field("numClusters", NUM),
        Field("clusters", DICT),
        Field("shared", DICT),
        Field("scores", DICT, required=False),
        Field("ha", DICT, required=False),
    )),
    # GET /slo: per-cluster SLO registry state (burn rates, compliance,
    # episode status), single-cluster deployments under "default" —
    # common/slo.py
    "slo": Schema((
        Field("numClusters", NUM),
        Field("clusters", DICT),
    )),
    # --- decision ledger (analyzer/ledger.py) ---
    # GET /explain: one ledger episode replayed as a structured
    # explanation — goal deltas, top moves, convergence curve, plus the
    # outcome and calibration records when the episode progressed that far
    "explain": Schema((
        Field("decisionId", STR),
        Field("traceId", STR),
        Field("cluster", STR),
        Field("source", STR),
        Field("workClass", STR),
        Field("computedMs", NUM),
        Field("generation", DICT, required=False),
        Field("bucket", DICT, required=False),
        Field("degraded", BOOL),
        Field("goalDeltas", LIST, item_schema=Schema((
            Field("goal", STR),
            Field("before", NUM),
            Field("after", NUM),
            Field("delta", NUM),
        ))),
        Field("objective", DICT),
        Field("balancedness", DICT),
        Field("numReplicaMovements", NUM),
        Field("numLeaderMovements", NUM),
        Field("dataToMoveMB", NUM),
        Field("topMoves", LIST),
        # engine convergence diagnostics (null when the decision was
        # computed with analyzer.diagnostics.enabled=false)
        Field("convergence", DICT, required=False),
        Field("predictedLoad", DICT, required=False),
        # execution outcome / predicted-vs-measured calibration: null
        # until the episode reaches that stage
        Field("outcome", DICT, required=False),
        Field("calibration", DICT, required=False),
    )),
    # GET /ledger: the raw joined episode stream + the store's state
    "ledger": Schema((
        Field("enabled", BOOL),
        Field("entries", LIST),
        Field("state", DICT, required=False),
    )),
}

#: non-200 body shapes (shared by every endpoint)
ASYNC_PROGRESS_SCHEMA = Schema((  # 202
    Field("progress", LIST),
    Field("_userTaskId", STR),
    Field("_traceId", STR, required=False),
))
ERROR_SCHEMA = Schema((  # 4xx/5xx
    Field("errorMessage", STR),
    Field("_userTaskId", STR, required=False),
), allow_extra=True)


def validate_response(endpoint: str, payload: dict, *, status: int = 200) -> list[str]:
    """-> list of schema violations (empty = conforming)."""
    if status == 202:
        schema = ASYNC_PROGRESS_SCHEMA
    elif status >= 400:
        schema = ERROR_SCHEMA
    else:
        schema = RESPONSE_SCHEMAS.get(endpoint)
        if schema is None:
            return [f"no declared schema for endpoint {endpoint!r}"]
    return _check(schema, payload, where=endpoint)


def _check(schema: Schema, payload, *, where: str) -> list[str]:
    problems: list[str] = []
    if not isinstance(payload, dict):
        return [f"{where}: expected object, got {type(payload).__name__}"]
    for f in schema.fields:
        if f.name not in payload:
            if f.required:
                problems.append(f"{where}: missing required field {f.name!r}")
            continue
        v = payload[f.name]
        if v is not None and not isinstance(v, f.types):
            problems.append(
                f"{where}.{f.name}: expected {'/'.join(t.__name__ for t in f.types)},"
                f" got {type(v).__name__}"
            )
            continue
        if f.item_schema is not None and isinstance(v, list):
            for i, item in enumerate(v[:5]):  # spot-check the head
                problems += _check(f.item_schema, item, where=f"{where}.{f.name}[{i}]")
    if not schema.allow_extra:
        # _userTaskId/_traceId are cross-cutting rider fields every async
        # response carries (poll resume + flight-recorder correlation)
        extra = set(payload) - schema.field_names() - {"_userTaskId", "_traceId"}
        if extra:
            problems.append(f"{where}: undeclared fields {sorted(extra)}")
    return problems
