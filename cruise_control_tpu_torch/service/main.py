"""Service bootstrap — assemble and start a full Cruise Control instance.

Reference: KafkaCruiseControlMain.java:26-40 (parse props file -> start app)
and KafkaCruiseControlApp.java:36-66.  `build_service` wires the stack for
any MetadataProvider/ClusterAdmin pair: real Kafka adapters in production,
the simulated backend in tests/demos (`build_simulated_service`).

Every builder takes `device=`, resolved once (`device.resolve_device`):
the current CUDA device when None, raising without one; the CPU only when
the caller names it.  That one device goes to the monitor (models are
built there), the optimizer, the scenario evaluator, the rightsizer and
the detectors.  `main` runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import sys

from cruise_control_tpu_torch.config.app_config import CruiseControlConfig, load_properties
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.monitor import (
    FixedCapacityResolver,
    KAFKA_METRIC_DEF,
    LoadMonitor,
    MetricFetcherManager,
    WindowedMetricSampleAggregator,
)
from cruise_control_tpu_torch.monitor.capacity import (
    BrokerCapacityConfigResolver,
    FileCapacityResolver,
)
from cruise_control_tpu_torch.service.facade import CruiseControl
from cruise_control_tpu_torch.service.server import CruiseControlApp


def _build_cluster_stack(
    config: CruiseControlConfig,
    metadata,
    admin,
    sampler,
    *,
    sensors,
    capacity_resolver: BrokerCapacityConfigResolver | None = None,
    sample_store=None,
    partitions_fn=None,
    core=None,
    cluster_id: str | None = None,
    fence=None,
    device,
):
    """Wire ONE cluster's monitoring + facade stack: capacity resolver,
    aggregators, fetcher, monitor, task runner, and the CruiseControl
    facade.  `core`/`cluster_id` are the fleet seam — a shared
    AnalyzerCore makes this facade one tenant of a fleet; None keeps the
    classic self-contained build.  `fence` (fleet HA) is the cluster's
    lease fence — the journal stamps it and recovery defers to lease
    acquisition.  `device` (resolved) is where the monitor builds models
    and the facade runs.  Returns (cc, fetcher, task_runner)."""
    if capacity_resolver is None:
        resolver_cls = config.get("broker.capacity.config.resolver.class")
        path = config.get("capacity.config.file")
        if resolver_cls is not None:
            # pluggable resolver (reference broker.capacity.config.resolver.class)
            capacity_resolver = resolver_cls(config)
        else:
            capacity_resolver = (
                FileCapacityResolver(path)
                if path
                else FixedCapacityResolver([100.0, 1e5, 1e5, 1e6])
            )
    partition_agg = WindowedMetricSampleAggregator(
        num_windows=config.get("num.partition.metrics.windows"),
        window_ms=config.get("partition.metrics.window.ms"),
        min_samples_per_window=config.get("min.samples.per.partition.metrics.window"),
        metric_def=KAFKA_METRIC_DEF,
    )
    broker_agg = WindowedMetricSampleAggregator(
        num_windows=config.get("num.broker.metrics.windows"),
        window_ms=config.get("broker.metrics.window.ms"),
        min_samples_per_window=config.get("min.samples.per.broker.metrics.window"),
        metric_def=KAFKA_METRIC_DEF,
    )
    assignor_cls = config.get("metric.sampler.partition.assignor.class")
    fetcher = MetricFetcherManager(
        sampler,
        partition_agg,
        broker_agg,
        sample_store=sample_store,
        sampling_interval_ms=config.get("metric.sampling.interval.ms"),
        num_fetchers=config.get("num.metric.fetchers"),
        assignor=assignor_cls() if assignor_cls is not None else None,
        sensors=sensors,
    )
    from cruise_control_tpu_torch.monitor.cpu_model import LinearRegressionModelParameters
    from cruise_control_tpu_torch.monitor.sampling import PartitionEntity
    from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner

    import re

    excluded_rx = re.compile(config.get("monitor.excluded.topics.pattern"))

    def topic_filter(name: str) -> bool:
        return not excluded_rx.match(str(name))

    # one knob governs every layer: samplers that support a topic filter
    # (CruiseControlMetricsReporterSampler) get the CONFIGURED pattern, not
    # their built-in default — otherwise the model and the sample stream
    # silently diverge on what "excluded" means
    if hasattr(sampler, "topic_filter"):
        sampler.topic_filter = topic_filter
    # reference sampling.allow.cpu.capacity.estimation: samplers that can
    # skip CPU attribution for CPU-less brokers get the configured flag
    if hasattr(sampler, "allow_cpu_estimation"):
        sampler.allow_cpu_estimation = config.get(
            "sampling.allow.cpu.capacity.estimation"
        )

    regression = LinearRegressionModelParameters(
        cpu_util_bucket_size=config.get("linear.regression.model.cpu.util.bucket.size"),
        required_samples_per_bucket=config.get(
            "linear.regression.model.required.samples.per.bucket"
        ),
        min_num_cpu_util_buckets=config.get(
            "linear.regression.model.min.num.cpu.util.buckets"
        ),
    )
    monitor = LoadMonitor(
        metadata, capacity_resolver, partition_agg,
        regression=regression, topic_filter=topic_filter,
        bucket_policy=config.shape_bucket_policy(),
        max_allowed_extrapolations=config.get(
            "max.allowed.extrapolations.per.partition"
        ),
        cpu_weights=(
            config.get("leader.network.inbound.weight.for.cpu.util"),
            config.get("leader.network.outbound.weight.for.cpu.util"),
            config.get("follower.network.inbound.weight.for.cpu.util"),
        ),
        device=device,
    )

    if partitions_fn is None:
        if hasattr(sampler, "all_partition_entities"):
            partitions_fn = sampler.all_partition_entities
        else:
            # derive entities from metadata, with the same first-appearance
            # topic-id mapping LoadMonitor._build_state uses (and the same
            # internal-topic exclusion)
            def partitions_fn():
                topo = metadata.topology()
                tids: dict = {}
                return [
                    PartitionEntity(tids.setdefault(p.topic, len(tids)), p.partition)
                    for p in topo.partitions
                    if topic_filter(p.topic)
                ]

    task_runner = LoadMonitorTaskRunner(
        monitor,
        fetcher,
        partitions_fn,
        window_ms=config.get("partition.metrics.window.ms"),
        regression=regression,
        auto_train=config.get("use.linear.regression.model"),
    )
    cc = CruiseControl(
        config, monitor, admin, sensors=sensors, core=core,
        cluster_id=cluster_id, fence=fence, device=device,
    )
    cc.task_runner = task_runner
    # warm restart: replay the sample store off the startup path (reference
    # SampleLoadingTask runs async; skip.loading.samples disables it)
    if sample_store is not None and not config.get("skip.loading.samples"):
        import threading

        threading.Thread(
            target=task_runner.load_samples,
            daemon=True,
            name=f"sample-loading{'-' + cluster_id if cluster_id else ''}",
        ).start()
    return cc, fetcher, task_runner


def build_service(
    config: CruiseControlConfig,
    metadata,
    admin,
    sampler,
    *,
    capacity_resolver: BrokerCapacityConfigResolver | None = None,
    sample_store=None,
    partitions_fn=None,
    device=None,
) -> tuple[CruiseControlApp, MetricFetcherManager]:
    from cruise_control_tpu_torch.common.sensors import SensorRegistry

    device = resolve_device(device)
    _enable_build_cache_report(config)
    # ONE registry shared by the fetcher and the facade stack — the monitor
    # health gauges must surface in /state?substates=sensors
    sensors = SensorRegistry()
    cc, fetcher, _task_runner = _build_cluster_stack(
        config, metadata, admin, sampler,
        sensors=sensors,
        capacity_resolver=capacity_resolver,
        sample_store=sample_store,
        partitions_fn=partitions_fn,
        device=device,
    )
    app = CruiseControlApp(cc)
    return app, fetcher


def _enable_build_cache_report(config: CruiseControlConfig) -> None:
    """Take the boot inventory of the kernel build cache, which the first
    proposal pass reports against (common/compilation_cache.py): this
    package's only compiled artifact on disk.  An empty compile-cache
    setting turns the report off, as it turns the JAX package's cache
    off."""
    from cruise_control_tpu_torch.common.compilation_cache import enable_persistent_cache

    if config.compile_cache_dir():
        enable_persistent_cache()


def build_fleet_service(
    config: CruiseControlConfig,
    backends: dict,
    *,
    sample_stores: dict | None = None,
    ha_clock=None,
    device=None,
) -> tuple[CruiseControlApp, "FleetManager"]:
    """ONE service instance over N Kafka clusters (fleet/manager.py).

    `backends`: {cluster_id: (metadata_provider, cluster_admin, sampler)}
    covering every id in `fleet.clusters`.  Builds ONE shared AnalyzerCore
    (optimizer + compiled-engine cache + device supervisor + scenario
    evaluator + tracer) and, per cluster, its own monitor/fetcher/executor
    stack from `config.cluster_config(id)` (base config + fleet.<id>.*
    overrides), a cluster-labeled SensorRegistry, and a journal under
    <executor.journal.dir>/<id>/.  Returns (app, fleet_manager).

    With `fleet.ha.enabled` (fleet/leases.py): a FileLeaseStore in
    <executor.journal.dir>/_leases shards ownership across the M
    instances pointed at the same journal dir — each cluster's admin is
    wrapped in a FencedClusterAdmin and its journal fenced on the lease
    epoch, and contexts only start once this instance holds the lease.
    `ha_clock` injects the instance clock (tests/benches).  `device`: the
    one device of the shared core and every cluster's monitor."""
    from cruise_control_tpu_torch.common.sensors import SensorRegistry
    from cruise_control_tpu_torch.fleet.manager import ClusterContext, FleetManager
    from cruise_control_tpu_torch.service.facade import AnalyzerCore

    ids = config.fleet_cluster_ids()
    if not ids:
        raise ValueError("build_fleet_service needs a non-empty fleet.clusters")
    missing = [cid for cid in ids if cid not in backends]
    if missing:
        raise ValueError(f"no backend supplied for fleet clusters {missing}")
    device = resolve_device(device)
    _enable_build_cache_report(config)
    shared_sensors = SensorRegistry()
    lease_manager = None
    if config.get("fleet.ha.enabled"):
        lease_manager = _build_lease_manager(
            config, ids, sensors=shared_sensors, clock=ha_clock
        )
    core = AnalyzerCore(config, sensors=shared_sensors, device=device)
    contexts: dict[str, ClusterContext] = {}
    for cid in ids:
        metadata, admin, sampler = backends[cid]
        fence = None
        if lease_manager is not None:
            from cruise_control_tpu_torch.executor.admin import FencedClusterAdmin

            fence = lease_manager.fence(cid)
            # every cluster mutation this instance ever issues rides the
            # fenced wrapper — a lost lease turns the whole admin surface
            # read-only at the SPI boundary
            admin = FencedClusterAdmin(admin, fence)
        cc, fetcher, task_runner = _build_cluster_stack(
            config.cluster_config(cid), metadata, admin, sampler,
            sensors=SensorRegistry(base_labels={"cluster": cid}),
            sample_store=(sample_stores or {}).get(cid),
            core=core,
            cluster_id=cid,
            fence=fence,
            device=device,
        )
        contexts[cid] = ClusterContext(
            cid, cc, fetcher=fetcher, task_runner=task_runner
        )
    fleet = FleetManager(
        core, contexts, sensors=shared_sensors, config=config,
        lease_manager=lease_manager,
    )
    app = CruiseControlApp(contexts[ids[0]].cc, fleet=fleet)
    return app, fleet


def _build_lease_manager(config, cluster_ids, *, sensors, clock=None):
    """FileLeaseStore + LeaseManager from the fleet.ha.* keys; the store
    lives in <executor.journal.dir>/_leases (the journal dir IS the
    fleet's shared durable state — requiring it keeps the HA story on
    one mount)."""
    import os
    import socket

    from cruise_control_tpu_torch.fleet.leases import FileLeaseStore, LeaseManager

    journal_dir = config.get("executor.journal.dir")
    if not journal_dir:
        raise ValueError(
            "fleet.ha.enabled requires executor.journal.dir: the lease "
            "store lives in <journal.dir>/_leases and a takeover replays "
            "the dead holder's journal from the same mount"
        )
    instance_id = config.get("fleet.ha.instance.id") or (
        f"{socket.gethostname()}-{os.getpid()}"
    )
    skew = config.get("fleet.ha.skew.slack.s")
    store = FileLeaseStore(
        os.path.join(os.path.expanduser(journal_dir), "_leases"),
        skew_slack_s=skew,
        clock=clock,
    )
    return LeaseManager(
        store,
        cluster_ids,
        holder_id=instance_id,
        ttl_s=config.get("fleet.ha.lease.ttl.s"),
        renew_s=config.get("fleet.ha.renew.s"),
        skew_slack_s=skew,
        clock=clock,
        sensors=sensors,
    )


def parse_bootstrap_servers(bootstrap_servers: str) -> list[tuple[str, int]]:
    """Parse a Kafka bootstrap list ("h1:9092,h2") into (host, port) seeds.

    Supports bracketed IPv6 ("[::1]:9092", "[::1]") and bare IPv6 literals
    without a port ("::1") — rpartition(':') alone would split those wrong.
    """
    seeds = []
    for hp in bootstrap_servers.split(","):
        hp = hp.strip()
        if not hp:
            continue
        if hp.startswith("["):  # bracketed IPv6: [::1] or [::1]:9092
            addr, sep, rest = hp[1:].partition("]")
            if not sep or (rest and not rest.startswith(":")):
                raise ValueError(f"malformed bootstrap server {hp!r}")
            host, port = addr, (rest[1:] or "9092")
        elif hp.count(":") > 1:  # bare IPv6 literal, no port
            import ipaddress

            try:  # reject comma typos like "h1:9092:h2:9093" fast
                ipaddress.ip_address(hp)
            except ValueError:
                raise ValueError(f"malformed bootstrap server {hp!r}") from None
            host, port = hp, "9092"
        else:
            host, sep, port = hp.rpartition(":")
            if not sep:  # bare hostname: Kafka's default port shorthand
                host, port = hp, "9092"
        if not port.isdigit():
            raise ValueError(f"malformed bootstrap server {hp!r}")
        seeds.append((host or "127.0.0.1", int(port)))
    if not seeds:
        raise ValueError(f"no bootstrap servers in {bootstrap_servers!r}")
    return seeds


def sasl_credentials_from_config(config: CruiseControlConfig):
    """SaslCredentials from sasl.* keys (None when SASL is off) — EVERY
    client a deployment opens (admin, metrics consumer) must authenticate
    the same way (sasl.password.file wins over sasl.password)."""
    if not config.get("sasl.mechanism"):
        return None
    from cruise_control_tpu_torch.kafka.sasl import SaslCredentials

    password = config.get("sasl.password")
    pw_file = config.get("sasl.password.file")
    if pw_file:
        with open(pw_file) as f:
            password = f.read().strip()
    if not config.get("sasl.username") or password is None:
        raise ValueError(
            "sasl.mechanism set but sasl.username/sasl.password missing"
        )
    return SaslCredentials(
        username=config.get("sasl.username"),
        password=password,
        mechanism=config.get("sasl.mechanism"),
    )


def build_kafka_service(
    config: CruiseControlConfig,
    bootstrap_servers: str,
    sampler,
    *,
    client_id: str = "cruise-control-tpu",
    sample_store=None,
    device=None,
):
    """Service against a LIVE Kafka cluster over the wire-protocol adapters
    (kafka/admin.py): metadata + reassignments + elections + logdir moves +
    throttles all ride the binary protocol — no JVM, no ZooKeeper
    (reference KafkaCruiseControlMain + the ZK/Scala bridge it starts).

    `sampler` supplies partition/broker load samples (MetricSampler SPI,
    monitor/sampling.py).  The stock choice is
    CruiseControlMetricsReporterSampler fed by a transport that consumes
    the reporter topic (reporter/reporter.py Transport SPI).
    """
    device = resolve_device(device)
    from cruise_control_tpu_torch.kafka import (
        KafkaAdminClient,
        KafkaClusterAdmin,
        KafkaMetadataProvider,
    )

    sasl = sasl_credentials_from_config(config)
    client = KafkaAdminClient(
        parse_bootstrap_servers(bootstrap_servers), client_id=client_id, sasl=sasl
    )
    # fail fast with the full list of unsupported APIs rather than on the
    # first mid-operation decode error against an old broker
    client.check_api_support()
    metadata = KafkaMetadataProvider(client)
    admin = KafkaClusterAdmin(client)
    app, fetcher = build_service(
        config, metadata, admin, sampler, sample_store=sample_store, device=device
    )
    return app, fetcher, admin, client


def build_simulated_service(
    config: CruiseControlConfig | None = None,
    *,
    num_brokers: int = 6,
    topics: dict[str, int] | None = None,
    seed: int = 0,
    sampled_windows: int = 3,
    device=None,
):
    """Full in-process service against the simulated cluster (the embedded
    harness analog, reference CruiseControlIntegrationTestHarness)."""
    device = resolve_device(device)
    from cruise_control_tpu_torch.executor.admin import SimulatedClusterAdmin
    from cruise_control_tpu_torch.monitor.topology import StaticMetadataProvider
    from cruise_control_tpu_torch.testing.synthetic import (
        SyntheticWorkloadSampler,
        synthetic_topology,
    )

    config = config or CruiseControlConfig(
        {
            "partition.metrics.window.ms": 1000,
            "min.samples.per.partition.metrics.window": 1,
            "num.partition.metrics.windows": max(3, sampled_windows),
            "execution.progress.check.interval.ms": 100,
            "webserver.http.port": 0,  # ephemeral
            "tpu.num.candidates": 128,
            "tpu.leadership.candidates": 32,
            "tpu.steps.per.round": 16,
            "tpu.num.rounds": 2,
        }
    )
    topo = synthetic_topology(num_brokers=num_brokers, topics=topics or {"T0": 12, "T1": 12},
                              seed=seed)
    metadata = StaticMetadataProvider(topo)
    admin = SimulatedClusterAdmin(metadata, link_rate_bytes_per_s=1e12)
    sampler = SyntheticWorkloadSampler(topo, seed=seed)
    app, fetcher = build_service(config, metadata, admin, sampler, device=device)
    window_ms = config.get("partition.metrics.window.ms")
    parts = sampler.all_partition_entities()
    for w in range(sampled_windows + 1):
        fetcher.fetch_once(parts, w * window_ms, (w + 1) * window_ms - 1)
    return app, fetcher, admin, sampler


def build_simulated_fleet(
    props: dict | None = None,
    *,
    clusters: dict[str, dict] | None = None,
    seed: int = 0,
    sampled_windows: int = 3,
    backends: dict | None = None,
    ha_clock=None,
    device=None,
):
    """Full in-process FLEET over N simulated clusters — the embedded
    harness for fleet tests and `bench.py --fleet-smoke`/`--ha-smoke`.

    `clusters`: {cluster_id: synthetic_topology kwargs}; the default is 3
    clusters, two of which share a bucketed model shape (so they must
    share one compiled engine through the fleet's AnalyzerCore).
    `backends`: pre-built {cluster_id: (metadata, admin, sampler)} —
    fleet-HA harnesses pass the SAME backends to two instances so both
    "see" one set of simulated Kafka clusters."""
    device = resolve_device(device)
    from cruise_control_tpu_torch.executor.admin import SimulatedClusterAdmin
    from cruise_control_tpu_torch.monitor.topology import StaticMetadataProvider
    from cruise_control_tpu_torch.testing.synthetic import (
        SyntheticWorkloadSampler,
        synthetic_topology,
    )

    clusters = clusters or {
        # east/west: identical geometry -> identical shape bucket -> ONE
        # compiled engine serves both
        "east": dict(num_brokers=6, topics={"T0": 12, "T1": 12}),
        "west": dict(num_brokers=6, topics={"T0": 12, "T1": 12}),
        # south: a different bucket, its own engine
        "south": dict(num_brokers=12, topics={"T0": 48, "T1": 48}),
    }
    base = {
        "fleet.clusters": ",".join(clusters),
        "partition.metrics.window.ms": 1000,
        "min.samples.per.partition.metrics.window": 1,
        "num.partition.metrics.windows": max(3, sampled_windows),
        "execution.progress.check.interval.ms": 100,
        "webserver.http.port": 0,  # ephemeral
        "tpu.num.candidates": 128,
        "tpu.leadership.candidates": 32,
        "tpu.steps.per.round": 16,
        "tpu.num.rounds": 2,
    }
    base.update(props or {})
    config = CruiseControlConfig(base)
    if backends is None:
        backends = {}
        for i, (cid, spec) in enumerate(clusters.items()):
            topo = synthetic_topology(seed=seed + i, **spec)
            metadata = StaticMetadataProvider(topo)
            admin = SimulatedClusterAdmin(metadata, link_rate_bytes_per_s=1e12)
            sampler = SyntheticWorkloadSampler(topo, seed=seed + i)
            backends[cid] = (metadata, admin, sampler)
    app, fleet = build_fleet_service(config, backends, ha_clock=ha_clock, device=device)
    window_ms = config.get("partition.metrics.window.ms")
    for cid, ctx in fleet.contexts.items():
        parts = backends[cid][2].all_partition_entities()
        for w in range(sampled_windows + 1):
            ctx.fetcher.fetch_once(parts, w * window_ms, (w + 1) * window_ms - 1)
    return app, fleet


def _kafka_cluster_backend(ccfg: CruiseControlConfig, bootstrap: str):
    """(metadata, admin, sampler) + clients for one LIVE Kafka cluster of a
    fleet, wired exactly like the single-cluster main() path."""
    from cruise_control_tpu_torch.kafka import (
        KafkaAdminClient,
        KafkaClusterAdmin,
        KafkaMetadataProvider,
    )
    from cruise_control_tpu_torch.kafka.transport import KafkaMetricsConsumer
    from cruise_control_tpu_torch.monitor.reporter_sampler import (
        CruiseControlMetricsReporterSampler,
    )

    sasl = sasl_credentials_from_config(ccfg)
    client = KafkaAdminClient(parse_bootstrap_servers(bootstrap), sasl=sasl)
    client.check_api_support()
    metadata = KafkaMetadataProvider(client)
    admin = KafkaClusterAdmin(client)
    serde = None
    if ccfg.get("cruise.control.metrics.serde.format") == "reference":
        from cruise_control_tpu_torch.reporter.metrics import ReferenceMetricSerde

        serde = ReferenceMetricSerde
    consumer_client = KafkaAdminClient(
        parse_bootstrap_servers(bootstrap), sasl=sasl
    )
    sampler = CruiseControlMetricsReporterSampler(
        KafkaMetricsConsumer(
            consumer_client, ccfg.get("cruise.control.metrics.topic"), serde=serde
        ),
        metadata.topology,
    )
    return (metadata, admin, sampler), [client, consumer_client]


def main(argv=None):  # pragma: no cover — manual entry point
    """Operator entry (reference KafkaCruiseControlMain.java:26-40):
    `python -m cruise_control_tpu_torch.service.main config/cruisecontrol.properties`.

    With `bootstrap.servers` set, runs against the live Kafka cluster over
    the wire-protocol adapters, consuming the metrics-reporter topic in
    the configured serde format; without it, boots the simulated demo
    cluster.  It runs on the card; `--device cpu` runs it on the CPU."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m cruise_control_tpu_torch.service.main")
    ap.add_argument("properties", nargs="?", help="cruisecontrol.properties")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the current CUDA device)")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    props = load_properties(args.properties) if args.properties else {}
    config = CruiseControlConfig(props)
    device = resolve_device(args.device)
    if config.fleet_cluster_ids():
        # fleet mode: ONE instance over every cluster in fleet.clusters;
        # each cluster's bootstrap.servers comes from its
        # fleet.<id>.bootstrap.servers override (or the base key)
        backends = {}
        clients = []
        for cid in config.fleet_cluster_ids():
            ccfg = config.cluster_config(cid)
            cluster_bootstrap = ccfg.values().get("bootstrap.servers")
            if not cluster_bootstrap:
                raise SystemExit(
                    f"fleet cluster {cid!r} has no bootstrap.servers "
                    f"(set fleet.{cid}.bootstrap.servers)"
                )
            backends[cid], cluster_clients = _kafka_cluster_backend(
                ccfg, cluster_bootstrap
            )
            clients.extend(cluster_clients)
        app, fleet = build_fleet_service(config, backends, device=device)
        fleet.start_up(precompute=True)
        for ctx in fleet.contexts.values():
            ctx.fetcher.start(
                lambda fn=ctx.task_runner.partitions_fn: fn()
            )
        app.start()
        print(
            f"cruise-control-tpu fleet ({len(fleet.contexts)} clusters) "
            f"listening on {app.host}:{app.port}{app.prefix}"
        )
        try:
            import time

            while True:
                time.sleep(60)
        except KeyboardInterrupt:
            fleet.shutdown()
            app.stop()
            for client in clients:
                client.close()
        return
    bootstrap = props.get("bootstrap.servers")
    if bootstrap:
        from cruise_control_tpu_torch.kafka import KafkaAdminClient
        from cruise_control_tpu_torch.kafka.transport import KafkaMetricsConsumer
        from cruise_control_tpu_torch.monitor.reporter_sampler import (
            CruiseControlMetricsReporterSampler,
        )

        serde = None
        if config.get("cruise.control.metrics.serde.format") == "reference":
            from cruise_control_tpu_torch.reporter.metrics import ReferenceMetricSerde

            serde = ReferenceMetricSerde
        # one extra client for the metrics data plane (fetch volume must
        # not contend with admin calls) — authenticated like the admin
        # client; topology comes from the SERVICE's own metadata provider
        # (monitor.metadata), not a third connection pool
        consumer_client = KafkaAdminClient(
            parse_bootstrap_servers(bootstrap),
            sasl=sasl_credentials_from_config(config),
        )
        monitor_meta: list = []
        sampler = CruiseControlMetricsReporterSampler(
            KafkaMetricsConsumer(
                consumer_client,
                config.get("cruise.control.metrics.topic"),
                serde=serde,
            ),
            lambda: monitor_meta[0].topology(),
        )
        app, fetcher, _admin, _client = build_kafka_service(
            config, bootstrap, sampler, device=device
        )
        monitor_meta.append(app.cc.monitor.metadata)
        partitions_fn = app.cc.task_runner.partitions_fn
    else:
        app, fetcher, _admin, sim_sampler = build_simulated_service(config, device=device)
        partitions_fn = sim_sampler.all_partition_entities
    app.cc.start_up(precompute=True)
    fetcher.start(lambda: partitions_fn())
    app.start()
    print(f"cruise-control-tpu listening on {app.host}:{app.port}{app.prefix}")
    try:
        import time

        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        app.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
