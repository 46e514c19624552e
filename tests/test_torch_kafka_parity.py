"""The port's Kafka wire path, fake cluster, sample store and decision
ledger against the JAX package's, on the CPU.

The same inputs go through both packages; the bar is identity, with no
tolerance, unless a key is listed below with its reason:

- every API's request and response bodies, captured from a session
  against the port's fake cluster (and the two SASL APIs, which the fake's
  listener answers itself), encode to the same bytes in both codecs, and
  decode back to equal bodies in both;
- the port's client against the JAX package's fake, and the JAX package's
  client against the port's fake, give the ClusterTopology each package's
  client gives against its own fake;
- the port's fake builds the JAX fake's placement, topics and broker table
  from the same input (its one pass over the partitions), on a JBOD
  cluster with replicas on brokers the table lacks; its broker table also
  holds each broker's loopback host, where the listener binds (the
  reference's binds 127.0.0.1), which both clients reach;
- a whole execution of the same proposals (inter-broker, leadership and
  intra-broker moves, a cluster cap of 12, a copy that takes a poll)
  through each package's Executor, KafkaClusterAdmin and fake cluster,
  with the same uuid and injected clock: the same task transitions, the
  same final fake-cluster topics and placement, the same request counts
  per API, and the journal files byte for byte;
- an execution crashed halfway and recovered over the wire by each
  package: the same final topics; the port submits no landed move again,
  where the reference's reconciliation does (the one difference by
  design, named in its test);
- the sample store's record bytes, packed and as produced into the fake's
  log;
- build_decision_record on both packages' results (the optimizers on the
  same fixture reach the same placement and proposals): equal but for
  `wallSeconds` (each run's own wall clock) and the bucket's `max_rf`
  (the port's only), and with no transfer on the port's CPU result;
- the SLO registry under the same specs, seeded event stream, probe
  verdicts and injected clock: the same tick states, summaries, SLO_BURN
  firings, error messages and exposition text;
- the decision ledger under the same decision, outcome and calibration
  sequence (a torn tail, a reopen, rotation held back by a pending
  outcome, retention; ids, clock and archive uuids injected): the live
  file and archives byte for byte, and equal replay(), pending_outcomes(),
  entries(), find() and state.
"""

import dataclasses
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("cruise_control_tpu", "cruise_control_tpu_torch")
FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)


def _pkg(name: str) -> SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        kafka=mod("kafka"), proto=mod("kafka.protocol"), client=mod("kafka.client"),
        records=mod("kafka.records"), store=mod("kafka.sample_store"), fake=mod("testing.fake_kafka"),
        sampling=mod("monitor.sampling"), proposals=mod("analyzer.proposals"), executor=mod("executor"),
        ledger=mod("analyzer.ledger"), analyzer=mod("analyzer"), fixtures=mod("testing.fixtures"),
    )


JAX, PORT = (_pkg(n) for n in PKGS)


def _spec(seed: int = 3, num_brokers: int = 8, per_topic: int = 24):
    """A JBOD cluster: broker -> rack and two logdirs; three topics of
    `per_topic` partitions, two or three replicas each, leader first."""
    rng = np.random.default_rng(seed)
    brokers = {b: {"rack": f"r{b % 3}", "logdirs": [f"/k{b}/d1", f"/k{b}/d0"]} for b in range(num_brokers)}
    topics = {}
    for t in ("alpha", "beta", "gamma"):
        parts = []
        for p in range(per_topic):
            reps = [int(b) for b in rng.choice(num_brokers, int(rng.integers(2, 4)), replace=False)]
            parts.append({"partition": p, "leader": reps[0], "replicas": reps})
        topics[t] = parts
    return brokers, topics


def _counting(cluster) -> dict:
    """Requests per API name, counted around the cluster's `handle`."""
    counts: dict = {}
    handle = cluster.handle

    def counted(node_id, api, body):
        counts[api.name] = counts.get(api.name, 0) + 1
        return handle(node_id, api, body)

    cluster.handle = counted
    return counts


def _topology_rows(topo) -> tuple:
    return (
        tuple(dataclasses.astuple(b) for b in topo.brokers),
        tuple(dataclasses.astuple(p) for p in topo.partitions),
        topo.generation,
    )


# ---------------------------------------------------------------- codec


def _captured_session() -> list:
    """(api name, request body, response body) of every request a session
    of the port's client made against the port's fake: each of the 13 APIs
    of ALL_APIS at least once."""
    brokers, topics = _spec()
    cluster = PORT.fake.FakeKafkaCluster(brokers, topics).start()
    seen = []
    handle = cluster.handle

    def capture(node_id, api, body):
        resp = handle(node_id, api, body)
        seen.append((api.name, body, resp))
        return resp

    cluster.handle = capture
    client = PORT.kafka.KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
    try:
        client.check_api_support()
        admin = PORT.kafka.KafkaClusterAdmin(client)
        admin.topology()
        admin.set_replication_throttle(5e6, {"alpha"})
        admin.clear_replication_throttle()
        admin.reassign_partitions([PORT.executor.ReassignmentSpec("alpha", 0, (7, 6), 10.0)])
        admin.in_progress_reassignments()
        admin.alter_replica_logdirs([("beta", 1, topics["beta"][1]["replicas"][0], 1)])
        admin.elect_leaders([PORT.executor.LeadershipSpec("gamma", 2, topics["gamma"][2]["replicas"][1])])
        client.create_topics([("metrics", 2, 2)])
        transport = PORT.kafka.transport.KafkaMetricsTransport(client, "metrics", flush_every=2, now_ms=lambda: 5)
        for i in range(4):
            transport.send(b"m%d" % i)
        consumer = PORT.kafka.transport.KafkaMetricsConsumer(client, "metrics")
        assert consumer.poll_records() == [b"m0", b"m1", b"m2", b"m3"]
        assert consumer.at_log_end()
    finally:
        client.close()
        cluster.stop()
    return seen


def test_every_api_encodes_to_the_same_bytes():
    seen = _captured_session()
    names = {name for name, _, _ in seen}
    assert names == {a.name for a in PORT.proto.ALL_APIS}
    sasl = [
        ("SaslHandshake", {"mechanism": "SCRAM-SHA-256"},
         {"error_code": 0, "mechanisms": ["SCRAM-SHA-256", "SCRAM-SHA-512"]}),
        ("SaslAuthenticate", {"auth_bytes": b"n,,n=user,r=fyko+d2lbbFgONRv9qkxdawL"},
         {"error_code": 0, "error_message": None, "auth_bytes": b"r=fyko,s=QSXCR+Q6sek8bf92,i=4096"}),
    ]
    for cid, (name, body, resp) in enumerate(seen + sasl):
        japi = next(a for a in JAX.proto.ALL_APIS + JAX.proto.SASL_APIS if a.name == name)
        papi = next(a for a in PORT.proto.ALL_APIS + PORT.proto.SASL_APIS if a.name == name)
        req = PORT.proto.encode_request(papi, cid, "cc", body)
        assert req == JAX.proto.encode_request(japi, cid, "cc", body), name
        out = PORT.proto.encode_response(papi, cid, resp)
        assert out == JAX.proto.encode_response(japi, cid, resp), name
        # both decode what either encoded to the same bodies
        assert PORT.proto.decode_request(req[4:])[1:] == JAX.proto.decode_request(req[4:])[1:], name
        assert PORT.proto.decode_response(papi, out[4:]) == JAX.proto.decode_response(japi, out[4:]), name


# -------------------------------------------------------- cross clients


def _topologies(client_pkg, fake_pkg) -> tuple:
    brokers, topics = _spec()
    cluster = fake_pkg.fake.FakeKafkaCluster(brokers, topics).start()
    cluster.kill_broker(5)
    client = client_pkg.kafka.KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
    try:
        provider = client_pkg.kafka.KafkaMetadataProvider(client)
        provider.refresh()
        return (_topology_rows(provider.refresh()),
                _topology_rows(client_pkg.kafka.KafkaClusterAdmin(client).topology()))
    finally:
        client.close()
        cluster.stop()


@pytest.mark.parametrize("client, fake", [("port", "jax"), ("jax", "port")])
def test_clients_and_fakes_interoperate(client, fake):
    pick = {"jax": JAX, "port": PORT}
    got = _topologies(pick[client], pick[fake])
    want = _topologies(pick[client], pick[client])
    assert got == want
    # a dead broker, the logdirs of the live ones, generation 2
    brokers = got[1][0]
    assert [b[0] for b in brokers if not b[3]] == [5]
    assert all(b[4] == (f"/k{b[0]}/d0", f"/k{b[0]}/d1") for b in brokers if b[3])
    assert got[0][2] == 2


def test_fake_cluster_builds_the_reference_placement():
    brokers, topics = _spec(seed=11, num_brokers=12, per_topic=80)
    # replicas on brokers the table lacks, and a broker with no logdirs
    del brokers[10]
    brokers[3] = {"rack": "r0"}
    topics["alpha"][4]["replicas"].append(99)
    clusters = [m.fake.FakeKafkaCluster(brokers, topics) for m in (JAX, PORT)]
    ref, port = clusters
    assert port.placement == ref.placement
    for b in ref.placement:
        for d in ref.placement[b]:
            assert list(port.placement[b][d]) == list(ref.placement[b][d])
    assert port.topics == ref.topics
    # the port's broker table also holds each broker's host (below)
    assert {b: {k: v for k, v in info.items() if k != "host"} for b, info in port.brokers.items()} == ref.brokers
    assert {info["host"] for info in port.brokers.values()} == {"127.0.0.1"}
    assert port.requests == {}


def test_brokers_on_loopback_hosts_of_their_own():
    """The port's fake binds each broker's listener on its spec's loopback
    host and reports that host in Metadata: both packages' clients reach
    every broker there, and the topology carries the hosts."""
    brokers, topics = _spec()
    for b, spec in brokers.items():
        spec["host"] = f"127.0.{b // 3}.{b % 3 + 1}"  # three brokers a host
    cluster = PORT.fake.FakeKafkaCluster(brokers, topics).start()
    try:
        assert cluster.bootstrap() == [("127.0.0.1", cluster.brokers[0]["port"])]
        for m in (JAX, PORT):
            client = m.kafka.KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
            try:
                topo = m.kafka.KafkaClusterAdmin(client).topology()
            finally:
                client.close()
            assert [(b.broker_id, b.host, b.logdirs) for b in topo.brokers] == [
                (b, brokers[b]["host"], (f"/k{b}/d0", f"/k{b}/d1")) for b in range(8)]
    finally:
        cluster.stop()


# ---------------------------------------------------------- execution


def _raw_proposals(topics, num_brokers: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    keys = [(t, p["partition"], tuple(p["replicas"])) for t, parts in topics.items() for p in parts]
    picks = rng.permutation(len(keys))[:40]
    out = []
    for k, i in enumerate(picks.tolist()):
        t, p, reps = keys[i]
        tid = ("alpha", "beta", "gamma").index(t)
        raw = dict(topic=tid, partition=p, old=reps, old_leader=reps[0], new=reps, new_leader=reps[0],
                   disk_moves=(), data=0.0, intra=0.0)
        if k < 24:
            outside = [b for b in range(num_brokers) if b not in reps]
            new = list(reps)
            new[int(rng.integers(len(reps)))] = int(rng.choice(outside))
            raw.update(new=tuple(new), new_leader=int(rng.choice(new)), data=float(rng.integers(1_000, 9_000)))
        elif k < 34:
            raw.update(new_leader=reps[1])
        else:
            raw.update(disk_moves=((reps[0], 0, 1),), intra=float(rng.integers(100, 900)))
        out.append(raw)
    return out


def _execute(m, tmp_path) -> dict:
    brokers, topics = _spec(seed=5)
    cluster = m.fake.FakeKafkaCluster(brokers, topics).start()
    cluster.auto_complete_after(2)
    cluster.intra_copy_polls = 1
    counts = _counting(cluster)
    client = m.kafka.KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
    clock = {"ms": 1_700_000_000_000}

    def now():
        clock["ms"] += 7
        return clock["ms"]

    path = tmp_path / "journal.jsonl"
    journal = m.executor.ExecutionJournal(str(path))
    ex = m.executor.Executor(m.kafka.KafkaClusterAdmin(client), topic_names={0: "alpha", 1: "beta", 2: "gamma"},
                             clock=now, journal=journal)
    transitions = []
    hook = ex._journal_task

    def observe(task, state, now_ms):
        transitions.append((task.execution_id, state.value, now_ms))
        hook(task, state, now_ms)

    ex._journal_task = observe
    proposals = [
        m.proposals.ExecutionProposal(
            partition=p["partition"], topic=p["topic"], old_leader=p["old_leader"], new_leader=p["new_leader"],
            old_replicas=p["old"], new_replicas=p["new"], disk_moves=p["disk_moves"],
            inter_broker_data_to_move=p["data"], intra_broker_data_to_move=p["intra"],
        )
        for p in _raw_proposals(topics, len(brokers), seed=9)
    ]
    options = m.executor.ExecutionOptions(max_num_cluster_movements=12, progress_check_interval_s=0.0,
                                          replication_throttle_bytes_per_s=1e6)
    try:
        res = ex.execute_proposals(proposals, options, uuid="kafka-parity")
    finally:
        journal.close()
        client.close()
        cluster.stop()
    return dict(result=dataclasses.asdict(res), transitions=transitions, topics=cluster.topics,
                placement=cluster.placement, configs=cluster.configs, requests=counts,
                journal=path.read_bytes(), own_count=getattr(cluster, "requests", None))


def test_whole_execution_over_the_wire_is_the_reference_exactly(tmp_path):
    runs = []
    for name, m in zip(PKGS, (JAX, PORT)):
        (tmp_path / name).mkdir()
        runs.append(_execute(m, tmp_path / name))
    ref, port = runs
    r = ref["result"]
    # the case exercises what it claims: moves of each kind, several ticks
    assert r["completed"] >= 40 and r["dead"] == r["aborted"] == 0 and r["ticks"] >= 3
    assert ref["requests"]["AlterReplicaLogDirs"] >= 1 and ref["requests"]["ElectLeaders"] >= 1
    assert port["result"] == r
    assert port["transitions"] == ref["transitions"]
    assert port["topics"] == ref["topics"]
    assert port["placement"] == ref["placement"]
    assert port["configs"] == ref["configs"]
    assert port["requests"] == ref["requests"]
    # the port's fake counts its requests in `handle`, as the wrapper does
    assert port["own_count"] == port["requests"]
    assert port["journal"] == ref["journal"]


def _crash_and_recover(m, tmp_path) -> dict:
    """The execution of _execute's proposals crashed on its third progress
    tick, then resumed by a fresh Executor over a fresh client and the
    journal; the landed moves submitted again, counted at the fake."""
    brokers, topics = _spec(seed=5)
    cluster = m.fake.FakeKafkaCluster(brokers, topics).start()
    cluster.auto_complete_after(1)
    again = []
    handle = cluster.handle

    def counted(node_id, api, body):
        if api.name == "AlterPartitionReassignments":
            for t in body["topics"] or []:
                for p in t["partitions"] or []:
                    cur = cluster.topics[t["name"]][p["partition_index"]]["replicas"]
                    if p["replicas"] is not None and list(p["replicas"]) == cur:
                        again.append((t["name"], p["partition_index"]))
        return handle(node_id, api, body)

    cluster.handle = counted
    names = {0: "alpha", 1: "beta", 2: "gamma"}
    proposals = [
        m.proposals.ExecutionProposal(
            partition=p["partition"], topic=p["topic"], old_leader=p["old_leader"], new_leader=p["new_leader"],
            old_replicas=p["old"], new_replicas=p["new"], inter_broker_data_to_move=p["data"],
        )
        for p in _raw_proposals(topics, len(brokers), seed=9)[:24]
    ]
    options = m.executor.ExecutionOptions(max_num_cluster_movements=6, progress_check_interval_s=0.0)
    path = str(tmp_path / "journal.jsonl")
    clients = [m.kafka.KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0) for _ in range(2)]
    faults = importlib.import_module(f"{m.kafka.__name__.split('.')[0]}.testing.faults")
    try:
        admin = m.kafka.KafkaClusterAdmin(clients[0])
        ex = m.executor.Executor(admin, topic_names=names, journal=m.executor.ExecutionJournal(path))
        with faults.process_crash(admin, on="in_progress_reassignments",
                                  schedule=faults.FaultSchedule(calls=[3])):
            with pytest.raises(faults.SimulatedProcessCrash):
                ex.execute_proposals(proposals, options, uuid="crash")
        assert cluster.reassignments  # moves parked when the process died
        journal = m.executor.ExecutionJournal(path)
        ex2 = m.executor.Executor(m.kafka.KafkaClusterAdmin(clients[1]), topic_names=names, journal=journal)
        res = ex2.resume_recovered_execution()
        journal.close()
    finally:
        for c in clients:
            c.close()
        cluster.stop()
    return dict(result=dataclasses.asdict(res), again=again, topics=cluster.topics)


def test_recovery_over_the_wire_submits_no_landed_move_again(tmp_path):
    """By design: the port's reconciliation reads the controller's
    in-progress set before the topology, so a move that lands between the
    two reads is seen landed; the reference reads the topology first and
    submits such a move again (ROADMAP queue 3).  The fake lands parked
    moves on the reconciliation's ListPartitionReassignments, the widest
    form of that window.  Both reach the same topology."""
    runs = []
    for name, m in zip(PKGS, (JAX, PORT)):
        (tmp_path / name).mkdir()
        runs.append(_crash_and_recover(m, tmp_path / name))
    ref, port = runs
    assert port["again"] == []
    assert len(ref["again"]) > 0
    assert port["result"]["dead"] == port["result"]["aborted"] == 0
    assert port["topics"] == ref["topics"]


# -------------------------------------------------------- sample store


def _samples(m) -> object:
    s = m.sampling
    return s.SamplingResult(
        partition_samples=[s.MetricSample(s.PartitionEntity(t, p), 1_000 * w + 500,
                                          np.arange(6, dtype=np.float32) * (p + 1) + t + w / 3)
                           for w in range(2) for t in range(2) for p in range(5)],
        broker_samples=[s.MetricSample(s.BrokerEntity(b), 1_500, np.full(5, b / 7, np.float32))
                        for b in range(3)],
    )


def test_sample_store_records_are_the_same_bytes():
    logs = []
    names = {0: "alpha", 1: "beta"}
    for m in (JAX, PORT):
        brokers, topics = _spec()
        cluster = m.fake.FakeKafkaCluster(brokers, topics).start()
        client = m.kafka.KafkaAdminClient(cluster.bootstrap(), timeout_s=5.0)
        try:
            store = m.store.KafkaSampleStore(client, topic_name_fn=names.__getitem__,
                                             topic_id_fn={v: k for k, v in names.items()}.__getitem__)
            packed = [store._pack(0, s.entity.topic, s.entity.partition, s.time_ms, names[s.entity.topic],
                                  s.values) for s in _samples(m).partition_samples]
            store.store(_samples(m))
            values = {
                key: [r.value for batch in batches for r in m.records.decode_batches(batch)]
                for key, batches in sorted(cluster.logs.items())
            }
            replay = [(r.partition_samples, r.broker_samples) for r in store.load()]
        finally:
            client.close()
            cluster.stop()
        rows = [[(dataclasses.astuple(s.entity), s.time_ms, s.values.tobytes()) for s in ps + bs]
                for ps, bs in replay]
        logs.append((packed, values, rows))
    assert logs[1] == logs[0]
    assert [len(r) for r in logs[0][2]] == [10, 13]
    assert sum(len(v) for v in logs[0][1].values()) == 23


# -------------------------------------------------------- decision record


def test_decision_record_is_the_reference_but_the_wall():
    from cruise_control_tpu_torch.convert import from_jax_arrays
    from cruise_control_tpu_torch.models.state import STATE_FIELDS

    js = JAX.fixtures.rack_violated_cluster()
    ts = from_jax_arrays({f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}, "cpu",
                         shape=dataclasses.asdict(js.shape))
    jr = JAX.analyzer.GoalOptimizer(config=JAX.analyzer.OptimizerConfig(**FAST)).optimize(js)
    tr = PORT.analyzer.GoalOptimizer(config=PORT.analyzer.OptimizerConfig(**FAST), device="cpu").optimize(ts)
    assert len(tr.proposals) > 0
    kw = dict(source="parity", trace_id="t-1", cluster_id="c", work_class="URGENT", config_fingerprint="f")
    before = PORT.ledger.TRANSFERS
    port_rec = PORT.ledger.build_decision_record(tr, **kw)
    assert PORT.ledger.TRANSFERS == before  # a CPU result: no transfer
    ref_rec = JAX.ledger.build_decision_record(jr, **kw)
    assert port_rec.pop("wallSeconds") >= 0 and ref_rec.pop("wallSeconds") >= 0
    # by design: the port's bucket also names max_rf, since its engines are
    # captured once per (shape, max_rf)
    assert port_rec["bucket"].pop("max_rf") == 2
    assert port_rec == ref_rec
    assert json.dumps(port_rec, sort_keys=True) == json.dumps(ref_rec, sort_keys=True)
    assert port_rec["moves"] and port_rec["goals"]["violationsAfter"]


# ----------------------------------------------------------- SLO registry


def _slo_stream(seed: int = 11, steps: int = 240):
    """A seeded stream of (clock step, event-fed records, probe verdict):
    two sustained breaches, each followed by a recovery, over background
    noise; probe verdicts cover good, bad, no data and a broken probe."""
    rng = np.random.default_rng(seed)
    stream = []
    for i in range(steps):
        breach = 40 <= i < 90 or 150 <= i < 200
        bad_p = 0.6 if breach else 0.02
        records = [("publish", bool(rng.random() >= bad_p), int(rng.integers(1, 4)))
                   for _ in range(int(rng.integers(0, 4)))]
        records.append(("unconfigured", False, 1))  # a producer without an SLO
        probe = ("raise", None, True, False)[int(rng.choice(4, p=(0.05, 0.1, 0.35, 0.5) if breach
                                                               else (0.05, 0.1, 0.8, 0.05)))]
        stream.append((float(rng.uniform(1.0, 9.0)), records, probe))
    return stream


def _drive_slo(name: str, stream) -> dict:
    slo = importlib.import_module(f"{name}.common.slo")
    sensors_mod = importlib.import_module(f"{name}.common.sensors")
    expo = importlib.import_module(f"{name}.common.exposition")
    clock = [1000.0]
    fired: list = []
    sensors = sensors_mod.SensorRegistry()
    reg = slo.SloRegistry(fast_window_s=60.0, slow_window_s=600.0, burn_threshold=2.0,
                          clock=lambda: clock[0], anomaly_sink=fired.append, sensors=sensors,
                          cluster_id="c1")
    verdict = [None]

    def probe():
        if verdict[0] == "raise":
            raise ZeroDivisionError("probe down")
        return verdict[0]

    reg.register(slo.SloSpec(name="publish", description="publish latency", objective=0.9,
                             target="p99 < 1 s"))
    reg.register(slo.SloSpec(name="freshness", description="proposal age", objective=0.9,
                             probe=probe))
    reg.register(slo.SloSpec(name="idle", description="never fed", objective=0.99))
    errors = []
    for bad in (lambda: reg.register(slo.SloSpec(name="idle", description="d", objective=0.5)),
                lambda: slo.SloSpec(name="x", description="d", objective=1.0),
                lambda: slo.SloRegistry(fast_window_s=60.0, slow_window_s=30.0),
                lambda: slo.SloRegistry(burn_threshold=0.5)):
        with pytest.raises(ValueError) as e:
            bad()
        errors.append(str(e.value))
    ticks, summaries, texts = [], [], []
    for i, (dt, records, probe_verdict) in enumerate(stream):
        clock[0] += dt
        for slo_name, good, n in records:
            reg.record(slo_name, good, n)
        verdict[0] = probe_verdict
        ticks.append(reg.tick())
        if i % 20 == 19:
            summaries.append(reg.summary_json())
            texts.append(expo.prometheus_text(sensors))
    anomalies = [(type(a).__name__, a.anomaly_type.name, a.slo, a.cluster_id, a.objective,
                  a.fast_burn_rate, a.slow_burn_rate, a.episode, a.fixable, a.description())
                 for a in fired]
    return dict(errors=errors, ticks=ticks, summaries=summaries, texts=texts,
                anomalies=anomalies, state=reg.state_json(), names=reg.names())


def test_slo_registry_matches_the_reference():
    """Both packages' SloRegistry under the same specs, event stream,
    probe verdicts and injected clock: the same tick states (burn rates,
    compliance, alerting, episodes), summaries, SLO_BURN firings, error
    messages and exposition text, exactly."""
    stream = _slo_stream()
    ref, port = (_drive_slo(n, stream) for n in PKGS)
    assert port["errors"] == ref["errors"]
    assert port["ticks"] == ref["ticks"]
    assert port["summaries"] == ref["summaries"]
    assert port["anomalies"] == ref["anomalies"]
    assert port["texts"] == ref["texts"]
    assert port["state"] == ref["state"] and port["names"] == ref["names"]
    # the stream exercises what it should: at least two episodes of an
    # event-fed and of a probe-fed SLO, each alert once, and a recovery
    episodes = {}
    for a in ref["anomalies"]:
        episodes.setdefault(a[2], []).append(a[7])
    assert sorted(episodes) == ["freshness", "publish"]
    assert all(e == list(range(1, len(e) + 1)) and len(e) >= 2 for e in episodes.values())
    assert not any(s["alerting"] for s in ref["ticks"][-1])
    assert "cruisecontrol_slo_burn_rate" in ref["texts"][-1]


# --------------------------------------------------------- decision ledger


def _drive_ledger(name: str, root, monkeypatch, summary) -> dict:
    """One sequence of decisions, outcomes and calibrations through a
    package's DecisionLedger, with a torn tail, a reopen, rotation held
    back by a pending outcome and retention: its file bytes and reads."""
    led_mod = importlib.import_module(f"{name}.analyzer.ledger")
    uuids = iter(range(1, 100))
    monkeypatch.setattr(led_mod.uuid_mod, "uuid4",
                        lambda: SimpleNamespace(hex=f"{next(uuids):08x}" * 4))
    ms = iter(range(1_700_000_000_000, 1_700_000_000_000 + 10_000, 7))
    clock = lambda: next(ms)  # noqa: E731
    path = root / name / "decision-ledger.jsonl"
    led = led_mod.DecisionLedger(str(path), rotate_records=2, retention_count=1, clock=clock)
    measured = {k: {f: v * 1.01 + 0.003 for f, v in row.items()} for k, row in summary.items()}
    reads = []
    d1 = led.record_decision({"source": "parity", "trace_id": "t-1", "goals": {"a": [0.5, 0.0]},
                              "predictedLoad": summary})
    led.begin_outcome(d1)
    d2 = led.record_decision({"id": "given-id", "source": "parity", "trace_id": "t-2", "moves": []})
    led.begin_outcome(d2)
    reads.append(sorted(led.pending_outcomes()))
    d3 = led.record_decision({"source": "parity", "trace_id": "t-3"})  # rotation held back
    led.record_outcome(d1, {"completed": 3, "dead": 0, "wallSeconds": 1.25})
    led.record_calibration(d1, {"measuredLoad": measured,
                                **led_mod.load_summary_error(summary, measured)})
    led.close()
    with open(path, "ab") as f:
        f.write(b'{"t": "outco')  # torn mid-record
    led = led_mod.DecisionLedger(str(path), rotate_records=2, retention_count=1, clock=clock)
    led.begin_outcome(d2)
    led.record_outcome(d2, {"completed": 0, "aborted": True})
    d4 = led.record_decision({"source": "parity", "trace_id": "t-4"})  # rotates, prunes none
    led.begin_outcome(d4)
    d5 = led.record_decision({"source": "parity", "trace_id": "t-5"})
    led.record_outcome(d4, {"completed": 1})
    d6 = led.record_decision({"source": "parity", "trace_id": "t-6"})  # rotates and prunes
    led.record_calibration(d6, {"maxAbsAvgError": 0.0})
    reads.append(sorted(led.pending_outcomes()))
    live = path.read_bytes()
    archives = sorted((p.name, p.read_bytes()) for p in path.parent.iterdir() if p.name.endswith(".done"))
    state = led.state_json()
    state.pop("path")
    out = dict(ids=[d1, d2, d3, d4, d5, d6], live=live, archives=archives, reads=reads,
               replay=led.replay(), entries=led.entries(limit=10),
               find=[led.find(decision_id=d1), led.find(trace_id="t-5"), led.find(trace_id="nope")],
               state=state)
    led.close()
    return out


def test_decision_ledger_matches_the_reference(tmp_path, monkeypatch):
    """The same decision, outcome and calibration sequence through both
    packages' DecisionLedger (the ids, the clock and the archive names'
    uuids injected): the live file and every archive byte for byte, and
    equal replay(), pending_outcomes(), entries(), find() and state."""
    stats = SimpleNamespace(**{f: np.linspace(0.5, 2.0 + i, 4).astype(np.float32)
                               for i, f in enumerate(("avg", "max", "min", "std"))})
    summary = JAX.ledger.load_summary(stats)
    assert PORT.ledger.load_summary(stats) == summary
    ref, port = (_drive_ledger(n, tmp_path, monkeypatch, summary) for n in PKGS)
    assert port["live"] == ref["live"]
    assert port["archives"] == ref["archives"]
    for key in ("ids", "reads", "replay", "entries", "find", "state"):
        assert port[key] == ref[key], key
    # the sequence exercises what it should: a rotation held back by a
    # pending outcome, then two rotations and one archive pruned
    assert ref["reads"] == [sorted([ref["ids"][0], "given-id"]), []]
    assert len(ref["archives"]) == 1 and ref["state"]["archives"] == 1
    assert [r["t"] for r in ref["replay"]].count("decision") == 3
    assert ref["find"][2] is None
