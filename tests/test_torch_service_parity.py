"""The port's configuration, REST service and CLI against the JAX package's,
on the same inputs, on the CPU.

- Config: config/cruisecontrol.properties resolves to the same values in
  both packages, and a table of invalid values raises the same
  `ConfigException` messages; the accessors agree (`optimizer_config()`,
  `balancing_constraint()`, the goal lists, `shape_bucket_policy()`, the
  supervisor's settings); the endpoint tables, the override maps and their
  errors, and the response schemas are equal.
- Service: both packages' `build_simulated_service`, with one config and
  one seed, take one request sequence over loopback HTTP (proposals, a
  dry-run rebalance, the three broker operations as dry runs, an executed
  demotion, the read endpoints, /state, /user_tasks and /simulate).  The
  status codes and the bodies are equal once `VOLATILE` is stripped; the
  proposal lists are equal byte for byte; the executed topology is equal.
- CLI: `cccli` sends the same requests (method, path and query, headers)
  to both servers for the same argv.

The only float fields compared with a tolerance are the goal-chain
objectives (`OBJECTIVE_FIELDS`, rtol 1e-6, about eight f32 ulps): XLA
contracts the chain's multiply-adds into FMAs in its compiled programs and
the port evaluates them op by op (ROADMAP queue 3, "Recorded CPU bars"),
so an objective over the same placement may differ in its last bits.
Every other number, the balancedness scores and every proposal included,
is compared exactly.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from cruise_control_tpu.client import cccli as j_cccli
from cruise_control_tpu.config import ConfigException as JConfigException
from cruise_control_tpu.config import CruiseControlConfig as JConfig
from cruise_control_tpu.config import endpoints as j_endpoints
from cruise_control_tpu.config import load_properties
from cruise_control_tpu.service import parameters as j_parameters
from cruise_control_tpu.service import schemas as j_schemas
from cruise_control_tpu.service.main import build_simulated_service as j_build
from cruise_control_tpu_torch.client import cccli as t_cccli
from cruise_control_tpu_torch.config import ConfigException as TConfigException
from cruise_control_tpu_torch.config import CruiseControlConfig as TConfig
from cruise_control_tpu_torch.config import endpoints as t_endpoints
from cruise_control_tpu_torch.service import parameters as t_parameters
from cruise_control_tpu_torch.service import schemas as t_schemas
from cruise_control_tpu_torch.service.main import build_simulated_service as t_build

PROPERTIES = "config/cruisecontrol.properties"

#: fields stripped before two responses are compared: ids minted per
#: request or per process, wall clocks, and the per-request timers
VOLATILE = {
    "_traceId", "_userTaskId",  # the task's and the trace's ids
    "wallSeconds",  # a request's wall
    "UserTaskId", "TraceId", "ClientIdentity", "StartMs",  # /user_tasks rows
}
#: /state fields kept out of the comparison: the sensors' values (wall
#: timers, histograms of walls, ages and device-memory gauges; the sensor
#: names and kinds and every counter's count ARE compared), and what the
#: two packages count differently by design: `compileAttribution` bills XLA
#: compiles in the JAX package and CUDA-graph captures in the port, and the
#: port's supervisor adds `contextLost`
STATE_BY_DESIGN = ("compileAttribution", "contextLost")
#: goal-chain objectives, compared within OBJECTIVE_RTOL (module docstring)
OBJECTIVE_FIELDS = {"objectiveBefore", "objectiveAfter", "objective"}
OBJECTIVE_RTOL = 1e-6

SERVICE_PROPS = {
    "partition.metrics.window.ms": 1000,
    "min.samples.per.partition.metrics.window": 1,
    "num.partition.metrics.windows": 3,
    "execution.progress.check.interval.ms": 100,
    "webserver.http.port": 0,
    "tpu.num.candidates": 128,
    "tpu.leadership.candidates": 32,
    "tpu.steps.per.round": 16,
    "tpu.num.rounds": 2,
}


# ------------------------------------------------------------------ config


def _values(cfg) -> dict:
    """Resolved values; a class value by its qualified name within its
    package, so the two packages' classes compare by what they name."""
    out = {}
    for k, v in cfg.values().items():
        if isinstance(v, type):
            v = (v.__module__.split(".", 1)[-1], v.__qualname__)
        out[k] = v
    return out


def test_properties_file_resolves_to_the_same_values():
    props = load_properties(PROPERTIES)
    assert _values(JConfig(props)) == _values(TConfig(props))
    assert _values(JConfig({})) == _values(TConfig({}))


INVALID = [
    {"tpu.num.candidates": "8"},
    {"tpu.num.rounds": "zero"},
    {"default.goals": "RackAwareGoal,NoSuchGoal"},
    {"hard.goals": "Bogus"},
    {"default.goals": ""},
    {"tpu.parallel.mode": "grid:0x2"},
    {"tpu.parallel.mode": "mesh"},
    {"analyzer.precision.score.dtype": "float16"},
    {"cpu.balance.threshold": "0.5"},
    {"disk.capacity.threshold": "1.5"},
    {"tpu.supervisor.op.timeout.s": "0"},
    {"proposal.expiration.ms": "-1"},
    {"webserver.http.port": "http"},
    {"executor.notifier.class": "no.such.module.Notifier"},
    {"fleet.clusters": "east", "fleet.west.bootstrap.servers": "h:9092"},
    {"tpu.shape.bucket.growth": "1.0"},
]


@pytest.mark.parametrize("props", INVALID, ids=lambda p: ",".join(p))
def test_invalid_values_raise_the_same_messages(props):
    with pytest.raises(JConfigException) as j:
        JConfig(props)
    with pytest.raises(TConfigException) as t:
        TConfig(props)
    assert str(t.value) == str(j.value)


def test_shared_key_override_of_a_fleet_cluster_is_refused_alike():
    props = {"fleet.clusters": "east,west", "fleet.east.tpu.num.rounds": "3"}
    with pytest.raises(JConfigException) as j:
        JConfig(props).cluster_config("east")
    with pytest.raises(TConfigException) as t:
        TConfig(props).cluster_config("east")
    assert str(t.value) == str(j.value)
    props = {"fleet.clusters": "east,west", "fleet.east.num.metric.fetchers": "3"}
    assert _values(JConfig(props).cluster_config("east")) == _values(
        TConfig(props).cluster_config("east"))


def test_accessors_agree():
    props = load_properties(PROPERTIES)
    j, t = JConfig(props), TConfig(props)
    assert dataclasses.asdict(t.optimizer_config()) == dataclasses.asdict(j.optimizer_config())
    assert dataclasses.asdict(t.balancing_constraint()) == dataclasses.asdict(j.balancing_constraint())
    for key in ("default.goals", "hard.goals", "anomaly.detection.goals", "self.healing.goals",
                "intra.broker.goals"):
        assert t.get(key) == j.get(key)
    tb, jb = t.shape_bucket_policy(), j.shape_bucket_policy()
    assert (tb.enabled, tb.growth, tb.floor) == (jb.enabled, jb.growth, jb.floor)
    ts, js = t.device_supervisor(device="cpu"), j.device_supervisor()
    for attr in ("op_timeout_s", "max_retries", "retry_backoff_s", "retry_backoff_cap_s",
                 "probe_timeout_s"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    assert ts.breaker.failure_threshold == js.breaker.failure_threshold
    assert ts.breaker.probe_interval_s == js.breaker.probe_interval_s
    assert t.parallel_mode() == j.parallel_mode()
    for attr in ("compile_cache_dir", "prewarm_manifest_dir", "blackbox_dir", "ledger_dir",
                 "fleet_cluster_ids"):
        assert getattr(t, attr)() == getattr(j, attr)(), attr
    off = {"tpu.supervisor.enabled": "false"}
    assert TConfig(off).device_supervisor() is None and JConfig(off).device_supervisor() is None


def test_endpoint_parameter_and_schema_tables_are_equal():
    for name in ("GET_ENDPOINTS", "POST_ENDPOINTS", "ALL_ENDPOINTS", "FLEET_GLOBAL_ENDPOINTS",
                 "ENDPOINT_TYPES"):
        assert getattr(t_endpoints, name) == getattr(j_endpoints, name), name
    for ep in j_endpoints.ALL_ENDPOINTS:
        assert t_endpoints.reference_key_name(ep) == j_endpoints.reference_key_name(ep)

    def params(table):
        return {ep: [(p.name, p.doc, getattr(p.parse, "__name__", None)) for p in ps.params]
                for ep, ps in table.items()}

    assert params(t_parameters.ENDPOINT_PARAMETERS) == params(j_parameters.ENDPOINT_PARAMETERS)
    assert set(t_schemas.RESPONSE_SCHEMAS) == set(j_schemas.RESPONSE_SCHEMAS)
    for ep, schema in j_schemas.RESPONSE_SCHEMAS.items():
        assert dataclasses.asdict(t_schemas.RESPONSE_SCHEMAS[ep]) == dataclasses.asdict(schema), ep
    for name in ("ASYNC_PROGRESS_SCHEMA", "ERROR_SCHEMA"):
        assert dataclasses.asdict(getattr(t_schemas, name)) == dataclasses.asdict(
            getattr(j_schemas, name))


QUERIES = [
    ("proposals", {"ignore_proposal_cache": ["true"]}),
    ("proposals", {"ignore_proposal_cache": ["maybe"]}),
    ("rebalance", {"dryrun": ["false"], "goals": ["RackAwareGoal"]}),
    ("remove_broker", {"brokerid": ["1,2"], "dryrun": ["true"]}),
    ("remove_broker", {"brokerid": ["x"]}),
    ("remove_broker", {}),
    ("add_broker", {"brokerid": ["3"], "replication_throttle": ["-5"]}),
    ("user_tasks", {"user_task_ids": ["a,b"], "types": ["Active"]}),
    ("partition_load", {"resource": ["CPU"], "entries": ["7"]}),
    ("state", {"substates": ["executor,monitor"], "verbose": ["true"]}),
    ("simulate", {"scenarios": ['[{"name": "x", "removeBrokers": [0]}]']}),
    ("simulate", {"scenarios": ["not json"]}),
    ("rightsize", {"min_brokers": ["0"]}),
    ("admin", {"concurrent_partition_movements_per_broker": ["4"]}),
    ("load", {"bogus_parameter": ["1"]}),
]


def _plain(v):
    """A parsed value with each package's dataclasses (a `Scenario`) as
    (class name, fields), so the two packages' values compare."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return type(v).__name__, _plain(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _parse(module, endpoint, raw):
    try:
        return "ok", _plain(module.ENDPOINT_PARAMETERS[endpoint].parse(raw))
    except Exception as e:  # noqa: BLE001 — the error is what is compared
        return type(e).__name__, str(e)


def test_override_maps_and_parameter_errors_are_equal():
    class JParams(j_parameters.EndpointParameters):
        def __init__(self, endpoint, builtin):
            super().__init__(endpoint, builtin.params)

    class TParams(t_parameters.EndpointParameters):
        def __init__(self, endpoint, builtin):
            super().__init__(endpoint, builtin.params)

    class Handler:
        def __init__(self, app, endpoint, params):
            self.answer = (200, {})

    for kind in ({}, {"add.broker.parameters.class": "P", "rebalance.request.class": "H"}):
        j_props = {k: (JParams if v == "P" else Handler) for k, v in kind.items()}
        t_props = {k: (TParams if v == "P" else Handler) for k, v in kind.items()}
        jp, jh = j_parameters.build_override_maps(JConfig(j_props))
        tp, th = t_parameters.build_override_maps(TConfig(t_props))
        assert set(tp) == set(jp) and set(th) == set(jh)
        assert {ep: type(p).__name__ for ep, p in tp.items()} == {
            ep: type(p).__name__.replace("JParams", "TParams") for ep, p in jp.items()}
        assert th == jh
    for endpoint, raw in QUERIES:
        assert _parse(t_parameters, endpoint, raw) == _parse(j_parameters, endpoint, raw), (
            endpoint, raw)


# ------------------------------------------------------------------ service


def _call(app, method, path):
    """One request, polled to its answer; (status, body)."""
    base = f"http://127.0.0.1:{app.port}{app.prefix}"
    headers = {}
    deadline = time.monotonic() + 120
    while True:
        req = urllib.request.Request(base + path, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                status, body = r.status, json.loads(r.read())
                tid = r.headers.get("User-Task-ID")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
        if status != 202 or time.monotonic() > deadline:
            return status, body
        headers = {"User-Task-ID": tid}
        time.sleep(0.05)


SCENARIOS = [{"name": "lose-0", "removeBrokers": [0]},
             {"name": "double-T0", "topicLoadFactors": {"T0": 2.0}},
             {"name": "add-2", "addBrokers": [{"count": 2}]}]

SEQUENCE = [
    ("GET", "/proposals"),
    ("GET", "/proposals"),  # the cached answer
    ("POST", "/rebalance?dryrun=true"),
    ("POST", "/remove_broker?brokerid=1&dryrun=true"),
    ("POST", "/add_broker?brokerid=2&dryrun=true"),
    ("POST", "/demote_broker?brokerid=3&dryrun=true"),
    ("POST", "/demote_broker?brokerid=3&dryrun=false"),
    ("GET", "/load"),
    ("GET", "/partition_load?resource=NW_IN&entries=10"),
    ("GET", "/kafka_cluster_state"),
    ("GET", "/state"),
    ("GET", "/user_tasks"),
    ("POST", "/simulate?scenarios=" + urllib.parse.quote(json.dumps(SCENARIOS))),
    ("POST", "/remove_broker?brokerid=99&dryrun=true"),  # an error answer
]


def _run(build, config, **kw):
    app, fetcher, admin, sampler = build(config, seed=7, **kw)
    app.start()
    try:
        answers = [_call(app, m, p) for m, p in SEQUENCE]
        topology = sorted(
            (p.topic, p.partition, p.leader, tuple(p.replicas))
            for p in admin.topology().partitions
        )
        return answers, topology
    finally:
        app.stop()


@pytest.fixture(scope="module")
def both_services():
    j = _run(j_build, JConfig(dict(SERVICE_PROPS)))
    t = _run(t_build, TConfig(dict(SERVICE_PROPS)), device="cpu")
    return j, t


def _strip(x, path=()):
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in VOLATILE or k in STATE_BY_DESIGN:
                continue
            if path[-1:] == ("Sensors",):
                # a sensor: its kind, and a counter's count
                v = {"type": v.get("type"), **({"count": v["count"]} if v.get("type") == "counter"
                                                  else {})}
            out[k] = _strip(v, path + (k,))
        return out
    if isinstance(x, (list, tuple)):
        return [_strip(v, path) for v in x]
    return x


def _assert_equal(j, t, where):
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), (where, set(t) ^ set(j))
        for k in j:
            if k in OBJECTIVE_FIELDS and isinstance(j[k], float):
                assert t[k] == pytest.approx(j[k], rel=OBJECTIVE_RTOL), (where, k)
            else:
                _assert_equal(j[k], t[k], f"{where}/{k}")
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), where
        for i, (a, b) in enumerate(zip(j, t)):
            _assert_equal(a, b, f"{where}[{i}]")
    else:
        assert t == j and type(t) is type(j), (where, j, t)


def test_service_answers_match_the_reference(both_services):
    (j_answers, _), (t_answers, _) = both_services
    for (method, path), (js, jb), (ts, tb) in zip(SEQUENCE, j_answers, t_answers):
        where = f"{method} {path[:40]}"
        assert ts == js, where
        _assert_equal(_strip(jb), _strip(tb), where)
    # the sequence exercised what it names
    assert [s for s, _ in t_answers] == [200] * (len(SEQUENCE) - 1) + [500]
    assert t_answers[6][1]["execution"]["completed"] == t_answers[6][1]["numLeaderMovements"] > 0


def test_proposals_are_byte_for_byte(both_services):
    (j_answers, _), (t_answers, _) = both_services
    for (method, path), (_, jb), (_, tb) in zip(SEQUENCE, j_answers, t_answers):
        if "proposals" in jb:
            assert json.dumps(tb["proposals"]) == json.dumps(jb["proposals"]), path
    assert t_answers[0][1]["proposals"], "the proposal carries moves"


def test_executed_topology_is_the_reference(both_services):
    (_, j_topology), (_, t_topology) = both_services
    assert t_topology == j_topology
    # the executed demotion left no leader on broker 3
    assert not [p for p in t_topology if p[2] == 3]


# ------------------------------------------------------------------ CLI

ARGVS = [
    ["state", "--substates", "executor"],
    ["proposals", "--ignore-proposal-cache", "true"],
    ["rebalance", "--dryrun", "true", "--goals", "RackAwareGoal"],
    ["remove_broker", "--brokers", "1", "--dryrun", "true"],
    ["user_tasks"],
    ["partition_load", "--resource", "DISK", "--entries", "3"],
]


def test_cli_sends_the_same_requests(monkeypatch, capsys):
    sent = {}
    real = urllib.request.urlopen
    for name, build, cfg, cli, kw in (
        ("jax", j_build, JConfig, j_cccli, {}),
        ("torch", t_build, TConfig, t_cccli, {"device": "cpu"}),
    ):
        app, *_ = build(cfg(dict(SERVICE_PROPS)), seed=7, **kw)
        app.start()
        log = sent[name] = []

        def recording(req, *a, _log=log, **k):
            u = urllib.parse.urlsplit(req.full_url)
            headers = {h: v for h, v in req.header_items() if h.lower() != "user-task-id"}
            _log.append((req.get_method(), u.path, u.query, sorted(headers.items())))
            return real(req, *a, **k)

        monkeypatch.setattr(urllib.request, "urlopen", recording)
        try:
            for argv in ARGVS:
                rc = cli.main(["-a", f"http://127.0.0.1:{app.port}", "--poll-interval", "0.05",
                               "-u", "user:pw", *argv])
                assert rc == 0, (name, argv)
        finally:
            monkeypatch.setattr(urllib.request, "urlopen", real)
            app.stop()
        capsys.readouterr()
    # a poll repeats its request; the first of each run is what the argv sent
    firsts = {name: [r for i, r in enumerate(log) if i == 0 or r != log[i - 1]]
              for name, log in sent.items()}
    assert firsts["torch"] == firsts["jax"]
    assert len(firsts["torch"]) >= len(ARGVS)
