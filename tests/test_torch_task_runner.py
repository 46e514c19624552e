"""The port's load-monitor task runner on the CPU.

tests/test_task_runner.py's tests of the runner's methods, pointed at the
port: the bootstrap modes (RANGE, SINCE, RECENT), the exclusive busy
states, training and the follower-CPU estimator's switch to the trained
regression, and the broker window's own span in /train's range.  The JAX
tests build the whole simulated service; these were ported before the
service, so `_stack` wires the monitor the way the JAX package's
service/main.py `_build_cluster_stack` does (aggregators, fetcher,
regression, monitor, runner, with that config's defaults) and feeds it
as `build_simulated_service` does.  The HTTP test
(`test_bootstrap_and_train_endpoints`) runs at the end over the port's
simulated service.

Then the runner's auto-train loop (its thread stopped in a `finally`),
and the trained regression and the bootstrapped aggregation against the
JAX package's runner on the same stack, bit for bit.
"""

import re
import time
from types import SimpleNamespace

import numpy as np
import pytest

from cruise_control_tpu_torch.monitor.load_monitor import MonitorState
from cruise_control_tpu_torch.config import CruiseControlConfig
from cruise_control_tpu_torch.service.main import build_simulated_service

# the JAX package's config defaults (config/app_config.py) for the keys the
# stack reads, with tests/test_task_runner.py's overrides
DEFAULTS = {
    "num.partition.metrics.windows": 5,
    "partition.metrics.window.ms": 1000,
    "min.samples.per.partition.metrics.window": 1,
    "num.broker.metrics.windows": 20,
    "broker.metrics.window.ms": 1000,
    "min.samples.per.broker.metrics.window": 1,
    "metric.sampling.interval.ms": 120_000,
    "num.metric.fetchers": 1,
    "monitor.excluded.topics.pattern": r"^__(KafkaCruiseControl|CruiseControlMetrics).*",
    "linear.regression.model.cpu.util.bucket.size": 5,
    "linear.regression.model.required.samples.per.bucket": 100,
    "linear.regression.model.min.num.cpu.util.buckets": 5,
    "max.allowed.extrapolations.per.partition": 5,
    "cpu.weights": (0.7, 0.15, 0.15),
}


def _modules(pkg: str):
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        monitor=mod("monitor"), cpu_model=mod("monitor.cpu_model"),
        task_runner=mod("monitor.task_runner"), synthetic=mod("testing.synthetic"),
        state=mod("models.state"),
    )


def _stack(pkg="cruise_control_tpu_torch", seed=11, sampled_windows=3, **extra):
    """One cluster's monitoring stack, wired as the JAX package's
    `_build_cluster_stack` wires it, over the simulated 6-broker cluster of
    `build_simulated_service`, with `sampled_windows + 1` windows fetched."""
    m = _modules(pkg)
    c = {**DEFAULTS, **extra}
    topo = m.synthetic.synthetic_topology(num_brokers=6, topics={"T0": 12, "T1": 12}, seed=seed)
    metadata = m.monitor.StaticMetadataProvider(topo)
    sampler = m.synthetic.SyntheticWorkloadSampler(topo, seed=seed)
    agg = lambda kind: m.monitor.WindowedMetricSampleAggregator(  # noqa: E731
        num_windows=c[f"num.{kind}.metrics.windows"], window_ms=c[f"{kind}.metrics.window.ms"],
        min_samples_per_window=c[f"min.samples.per.{kind}.metrics.window"],
        metric_def=m.monitor.KAFKA_METRIC_DEF)
    partition_agg, broker_agg = agg("partition"), agg("broker")
    fetcher = m.monitor.MetricFetcherManager(
        sampler, partition_agg, broker_agg, sampling_interval_ms=c["metric.sampling.interval.ms"],
        num_fetchers=c["num.metric.fetchers"])
    excluded = re.compile(c["monitor.excluded.topics.pattern"])
    regression = m.cpu_model.LinearRegressionModelParameters(
        cpu_util_bucket_size=c["linear.regression.model.cpu.util.bucket.size"],
        required_samples_per_bucket=c["linear.regression.model.required.samples.per.bucket"],
        min_num_cpu_util_buckets=c["linear.regression.model.min.num.cpu.util.buckets"])
    kw = dict(device="cpu") if pkg == "cruise_control_tpu_torch" else {}
    monitor = m.monitor.LoadMonitor(
        metadata, m.monitor.FixedCapacityResolver([100.0, 1e5, 1e5, 1e6]), partition_agg,
        regression=regression, topic_filter=lambda name: not excluded.match(str(name)),
        bucket_policy=m.state.ShapeBucketPolicy(),
        max_allowed_extrapolations=c["max.allowed.extrapolations.per.partition"],
        cpu_weights=c["cpu.weights"], **kw)
    runner = m.task_runner.LoadMonitorTaskRunner(
        monitor, fetcher, sampler.all_partition_entities, window_ms=c["partition.metrics.window.ms"],
        regression=regression, auto_train=extra.get("auto_train", False))
    window_ms = c["partition.metrics.window.ms"]
    parts = sampler.all_partition_entities()
    for w in range(sampled_windows + 1):
        fetcher.fetch_once(parts, w * window_ms, (w + 1) * window_ms - 1)
    return SimpleNamespace(monitor=monitor, fetcher=fetcher, runner=runner, sampler=sampler)


# --------------------------------------------- tests/test_task_runner.py, ported


def test_bootstrap_range_fills_windows():
    s = _stack()
    before = s.fetcher.total_samples
    n = s.runner.bootstrap_range(0, 3000, clear_metrics=False)
    assert n > 0
    assert s.fetcher.total_samples == before + n
    assert s.monitor.state not in (MonitorState.BOOTSTRAPPING,)
    assert s.runner.state()["bootstrapProgressPct"] == 100.0


def test_bootstrap_clear_metrics_resets_aggregator():
    s = _stack()
    agg_before = s.monitor.partition_aggregator
    s.runner.bootstrap_range(0, 2000, clear_metrics=True)
    assert s.monitor.partition_aggregator is not agg_before
    assert s.fetcher.partition_aggregator is s.monitor.partition_aggregator


def test_bootstrap_recent_and_since():
    s = _stack()
    assert s.runner.bootstrap_recent() > 0
    now = int(time.time() * 1000)
    assert s.runner.bootstrap_since(now - 2000) > 0


def test_busy_state_is_exclusive():
    s = _stack()
    s.runner._enter(MonitorState.BOOTSTRAPPING)
    try:
        with pytest.raises(RuntimeError):
            s.runner.train(0, 1000)
        with pytest.raises(RuntimeError):
            s.runner.load_samples()
    finally:
        s.runner._exit()
    s.runner.train(0, int(time.time() * 1000))


def test_training_flips_cpu_estimator():
    s = _stack()
    s.runner.regression.min_samples_to_train = 10
    parts = s.sampler.all_partition_entities()
    for w in range(4, 10):
        s.fetcher.fetch_once(parts, w * 1000, (w + 1) * 1000 - 1)
    out = s.runner.train(0, int(time.time() * 1000))
    assert out["trained"] is True
    coef = np.asarray(s.runner.regression.coefficients)
    assert coef[2] == pytest.approx(1e-4, rel=0.25)
    assert s.monitor.regression is s.runner.regression
    assert s.monitor.regression.trained
    loads = np.tile(np.array([[1.0, 100.0, 120.0, 500.0]], np.float32), (3, 1))
    est = s.runner.regression.follower_cpu_array(loads)
    assert est == pytest.approx(coef[2] * 100.0, rel=1e-5)


def test_train_without_enough_samples_reports_untrained():
    s = _stack()
    s.runner.regression.min_samples_to_train = 10_000
    out = s.runner.train(0, int(time.time() * 1000))
    assert out["trained"] is False
    assert s.monitor.regression.trained is False


def test_train_respects_requested_range_with_distinct_broker_window():
    s = _stack(seed=13, **{"broker.metrics.window.ms": 500})
    s.runner.regression.min_samples_to_train = 1
    assert s.runner.train(10_000_000, 20_000_000)["numSamples"] == 0
    assert s.runner.train(0, 1_000_000)["numSamples"] > 0


# --------------------------------------------- the loop, and parity


def test_auto_train_loop_trains_and_stops():
    """With auto_train the runner's own thread harvests broker windows and
    trains once the coverage gate passes; stop() ends it (and the
    fetcher's) within the test."""
    s = _stack(auto_train=True)
    reg = s.runner.regression
    reg.min_samples_to_train, reg.required_samples_per_bucket, reg.min_num_cpu_util_buckets = 5, 1, 1
    parts = s.sampler.all_partition_entities()
    for w in range(4, 10):
        s.fetcher.fetch_once(parts, w * 1000, (w + 1) * 1000 - 1)
    s.runner.start(interval_s=0.02)
    try:
        deadline = time.monotonic() + 20
        while not reg.trained and time.monotonic() < deadline:
            time.sleep(0.02)
        assert reg.trained
        assert s.runner._auto_thread is not None and s.runner._auto_thread.is_alive()
    finally:
        s.runner.stop()
    assert s.runner._auto_thread is None
    assert s.fetcher._thread is None or not s.fetcher._thread.is_alive()


def test_runner_matches_jax():
    """Both packages' runners on the same stack: a RANGE bootstrap with
    cleared metrics gives the same aggregation, and training the same
    regression state, bit for bit."""
    t, j = _stack(), _stack("cruise_control_tpu")
    for s in (t, j):
        s.runner.regression.min_samples_to_train = 10
        parts = s.sampler.all_partition_entities()
        for w in range(4, 10):
            s.fetcher.fetch_once(parts, w * 1000, (w + 1) * 1000 - 1)
    assert t.runner.train(0, 10_000) == j.runner.train(0, 10_000)
    np.testing.assert_array_equal(t.runner.regression.coefficients, j.runner.regression.coefficients)
    assert t.runner.bootstrap_range(0, 5000, clear_metrics=True) == \
        j.runner.bootstrap_range(0, 5000, clear_metrics=True)
    ra, rb = t.monitor.partition_aggregator.aggregate(), j.monitor.partition_aggregator.aggregate()
    for f in ("window_indices", "values", "window_valid", "extrapolation", "entity_valid"):
        x, y = getattr(ra, f), getattr(rb, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert t.runner.state() == j.runner.state()


# ------------------------- over HTTP through the service (tests/test_task_runner.py :19, :109)


def _fresh_service(seed=11, **extra):
    config = CruiseControlConfig(
        {
            "partition.metrics.window.ms": 1000,
            "min.samples.per.partition.metrics.window": 1,
            "broker.metrics.window.ms": 1000,
            "execution.progress.check.interval.ms": 100,
            "webserver.http.port": 0,
            **extra,
        }
    )
    return build_simulated_service(config, seed=seed, device="cpu")


def test_bootstrap_and_train_endpoints():
    import json
    import urllib.request

    app, fetcher, admin, sampler = _fresh_service()
    app.cc.task_runner.regression.min_samples_to_train = 5
    app.start()
    try:
        def poll(endpoint, **params):
            q = "&".join(f"{k}={v}" for k, v in params.items())
            url = f"http://{app.host}:{app.port}{app.prefix}/{endpoint}" + (
                f"?{q}" if q else ""
            )
            req = urllib.request.Request(url, method="GET")
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = json.loads(resp.read())
                tid = resp.headers.get("User-Task-ID")
                status = resp.status
            deadline = time.time() + 30
            while status == 202 and time.time() < deadline:
                time.sleep(0.2)
                req = urllib.request.Request(
                    url, method="GET", headers={"User-Task-ID": tid}
                )
                with urllib.request.urlopen(req, timeout=30) as resp:
                    payload = json.loads(resp.read())
                    status = resp.status
            return status, payload

        status, payload = poll("bootstrap", start="0", end="3000")
        assert status == 200
        assert payload["mode"] == "RANGE" and payload["samplesAbsorbed"] > 0
        status, payload = poll("bootstrap", start="0")
        assert status == 200 and payload["mode"] == "SINCE"
        status, payload = poll("train")
        assert status == 200
        assert payload["trained"] is True
        # /state surfaces the training state
        status, payload = poll("state", substates="monitor")
        assert payload["MonitorState"]["trainingState"]["trained"] is True
    finally:
        app.stop()
