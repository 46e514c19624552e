"""Prometheus text exposition for the SensorRegistry (+ a lint parser).

The JAX package's common/exposition.py, standard library only.

`GET /metrics` renders the whole sensor catalog in the Prometheus text
format (version 0.0.4) so the service is scrapeable by any standard
collector instead of only via the `/state` JSON blob:

  * Counter   -> `counter`, sample `<name>_total` (monotonic)
  * Gauge     -> `gauge`
  * Timer     -> `summary` in SECONDS: `<name>_seconds{quantile=...}` over
                 the bounded sample window + `_sum`/`_count` (totals exact,
                 quantiles windowed — same caveat as the JSON snapshot)
  * Meter     -> `<name>_total` counter + `<name>_rate_per_hour` gauge
  * Histogram -> `histogram`: cumulative `_bucket{le=...}` + `_sum`/`_count`
  * Collector -> `gauge` with one labeled sample per (labels, value) entry

Sensor names are dotted-kebab (`analyzer.engine-cache-hits`); Prometheus
names must match `[a-zA-Z_:][a-zA-Z0-9_:]*`, so `metric_name` sanitizes
every non-conforming rune to `_` under a configurable namespace prefix
(`metrics.prometheus.namespace`).  Sanitization can collide two catalog
names onto one metric family — `prometheus_text` raises rather than emit a
duplicate family, because a silently merged counter lies to every alert
built on it.

`parse_exposition` is the deliberately small strict parser behind the
scripts/check.sh lint gate and the tests: TYPE-before-samples, one TYPE
per family, counter naming + non-negativity, label syntax/escaping, and
histogram bucket monotonicity (with the `+Inf` bucket == `_count`).

OpenMetrics flavor (`prometheus_text(..., openmetrics=True)` — served
when `GET /metrics` is asked for `application/openmetrics-text` or
`?format=openmetrics`): the same family structure plus EXEMPLARS on
histogram `_bucket` samples (` # {trace_id="..."} <value> <ts>`) and the
terminating `# EOF` line.  Exemplars are how a latency panel's p99
outlier links straight to its `/trace` replay — each Histogram sensor
keeps the latest exemplar per bucket (common/sensors.py).  The lint
parser accepts and validates the exemplar syntax on `_bucket`/`_total`
samples and rejects it anywhere else.
"""

from __future__ import annotations

import math
import re

from cruise_control_tpu_torch.common.sensors import (
    Collector,
    Counter,
    Gauge,
    Histogram,
    Meter,
    SensorRegistry,
    Timer,
)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_NAME_OK = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")


def metric_name(name: str, *, namespace: str = "cruisecontrol") -> str:
    """Sanitize a sensor catalog name into a Prometheus metric name."""
    base = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    out = f"{namespace}_{base}" if namespace else base
    if not _NAME_OK.match(out):
        # a namespace starting with a digit, or an empty namespace with a
        # digit-leading sensor name
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
    return format(float(v), ".10g")


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: dict) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        if not _LABEL_NAME_OK.match(str(k)):
            raise ValueError(f"invalid Prometheus label name {k!r}")
        parts.append(f'{k}="{_escape_label(labels[k])}"')
    return "{" + ",".join(parts) + "}"


def prometheus_text(
    registry, *, namespace: str = "cruisecontrol", openmetrics: bool = False
) -> str:
    """Render one registry — or a sequence of them — in the exposition
    format; ends with a newline.

    Multi-registry rendering is the fleet controller's `/metrics` path:
    each cluster owns a registry whose `base_labels` (e.g.
    `{cluster: "east"}`) are stamped onto every sample, and the shared
    core's registry rides unlabeled beside them.  All samples of one
    family are emitted as one group (the format requires it) regardless
    of which registry contributed them, with ONE TYPE line per family.

    `openmetrics=True` additionally renders each Histogram bucket's
    latest exemplar (` # {trace_id=...} value ts`) and terminates the
    body with `# EOF`; the default 0.0.4 text stays byte-identical to
    before exemplars existed (scrapers that never asked for OpenMetrics
    must never see its syntax)."""
    registries = (
        [registry] if isinstance(registry, SensorRegistry) else list(registry)
    )
    #: family -> {"sensor": source name, "type": ptype, "lines": [...]}
    families: dict[str, dict] = {}
    order: list[str] = []

    def family(sensor_name: str, suffix: str, ptype: str) -> tuple[str, list]:
        fam = metric_name(sensor_name, namespace=namespace) + suffix
        info = families.get(fam)
        if info is None:
            info = families[fam] = {
                "sensor": sensor_name, "type": ptype, "lines": [],
            }
            order.append(fam)
        elif info["sensor"] != sensor_name:
            raise ValueError(
                f"sensor names {info['sensor']!r} and {sensor_name!r} "
                f"sanitize to the same Prometheus family {fam!r}; rename one"
            )
        return fam, info["lines"]

    for reg in registries:
        base = dict(getattr(reg, "base_labels", None) or {})
        blk = _labels(base)
        for name, sensor in reg.items():
            if isinstance(sensor, Counter):
                fam, out = family(name, "_total", "counter")
                out.append(f"{fam}{blk} {_fmt(sensor.count)}")
            elif isinstance(sensor, Gauge):
                fam, out = family(name, "", "gauge")
                out.append(f"{fam}{blk} {_fmt(sensor.value)}")
            elif isinstance(sensor, Timer):
                fam, out = family(name, "_seconds", "summary")
                for q, v in sorted(sensor.quantiles().items()):
                    out.append(
                        f"{fam}{_labels({**base, 'quantile': _fmt(q)})} {_fmt(v)}"
                    )
                out.append(f"{fam}_sum{blk} {_fmt(sensor.total_seconds())}")
                out.append(f"{fam}_count{blk} {_fmt(sensor.count)}")
            elif isinstance(sensor, Meter):
                fam, out = family(name, "_total", "counter")
                out.append(f"{fam}{blk} {_fmt(sensor.count)}")
                rfam, rout = family(name + ".rate-per-hour", "", "gauge")
                rout.append(f"{rfam}{blk} {_fmt(sensor.rate_per_hour())}")
            elif isinstance(sensor, Histogram):
                fam, out = family(name, "", "histogram")
                cum, total, n = sensor.cumulative()
                exemplars = (
                    {b: (v, lab, ts) for b, v, lab, ts in sensor.exemplars()}
                    if openmetrics
                    else {}
                )
                for bound, c in cum:
                    le = "+Inf" if bound == float("inf") else _fmt(bound)
                    line = f"{fam}_bucket{_labels({**base, 'le': le})} {_fmt(c)}"
                    ex = exemplars.get(bound)
                    if ex is not None:
                        v, lab, ts = ex
                        line += (
                            f" # {_labels(lab) or '{}'} {_fmt(v)} {_fmt(ts)}"
                        )
                    out.append(line)
                out.append(f"{fam}_sum{blk} {_fmt(total)}")
                out.append(f"{fam}_count{blk} {_fmt(n)}")
            elif isinstance(sensor, Collector):
                fam, out = family(name, "", "gauge")
                for labels, v in sensor.values():
                    # base labels win a key clash: the registry's scope is
                    # authoritative over what a callback claims
                    out.append(f"{fam}{_labels({**labels, **base})} {_fmt(v)}")
            # unknown sensor types are skipped: the exposition only
            # promises the documented catalog
    lines: list[str] = []
    for fam in order:
        info = families[fam]
        lines.append(f"# HELP {fam} sensor {info['sensor']}")
        lines.append(f"# TYPE {fam} {info['type']}")
        lines.extend(info["lines"])
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# minimal strict parser (the exposition lint gate)
# ----------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*?)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?"
    # OpenMetrics exemplar: ` # {labels} value [timestamp]` — rendered
    # only on histogram buckets; linted wherever it appears
    r"(?:\s+#\s+\{(?P<exlabels>.*?)\}\s+(?P<exvalue>[^\s]+)"
    r"(?:\s+(?P<exts>[^\s]+))?)?$"
)
_LABEL_RE = re.compile(
    r'\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"(?P<value>(?:[^"\\]|\\["\\n])*)"\s*(?:,|$)'
)
_SUMMARY_HISTOGRAM_SUFFIXES = ("_sum", "_count", "_bucket")


class ExpositionError(ValueError):
    """A lint violation in a /metrics body, with the offending line."""


def _parse_labels(raw: str) -> dict:
    labels: dict[str, str] = {}
    pos = 0
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            raise ExpositionError(f"malformed label block {raw!r}")
        name = m.group("name")
        if name in labels:
            raise ExpositionError(f"duplicate label {name!r} in {raw!r}")
        labels[name] = (
            m.group("value")
            .replace("\\n", "\n")
            .replace('\\"', '"')
            .replace("\\\\", "\\")
        )
        pos = m.end()
    return labels


def parse_exposition(text: str) -> dict[str, dict]:
    """Parse + lint an exposition body.

    Returns {family: {"type": str, "samples": [(name, labels, value)]}}.
    Raises ExpositionError on: samples without a preceding TYPE, repeated
    TYPE lines, bad sample/label syntax, unparseable values, counters not
    ending in `_total` or going negative, and histograms whose cumulative
    buckets decrease or whose `+Inf` bucket disagrees with `_count`.
    """
    families: dict[str, dict] = {}

    def family_of(sample_name: str) -> str | None:
        if sample_name in families:
            return sample_name
        for suffix in _SUMMARY_HISTOGRAM_SUFFIXES:
            if sample_name.endswith(suffix):
                base = sample_name[: -len(suffix)]
                if base in families and families[base]["type"] in (
                    "summary", "histogram",
                ):
                    return base
        return None

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ExpositionError(f"line {lineno}: malformed TYPE line {line!r}")
            _, _, fam, ptype = parts
            if ptype not in ("counter", "gauge", "summary", "histogram", "untyped"):
                raise ExpositionError(f"line {lineno}: unknown type {ptype!r}")
            if fam in families:
                raise ExpositionError(f"line {lineno}: duplicate TYPE for {fam!r}")
            if ptype == "counter" and not fam.endswith("_total"):
                raise ExpositionError(
                    f"line {lineno}: counter family {fam!r} must end in _total"
                )
            families[fam] = {"type": ptype, "samples": []}
            continue
        if line.startswith("#"):
            continue  # HELP / comments
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ExpositionError(f"line {lineno}: malformed sample line {line!r}")
        name = m.group("name")
        fam = family_of(name)
        if fam is None:
            raise ExpositionError(
                f"line {lineno}: sample {name!r} has no preceding TYPE line"
            )
        labels = _parse_labels(m.group("labels")) if m.group("labels") else {}
        raw_v = m.group("value")
        try:
            value = float(raw_v)
        except ValueError as e:
            raise ExpositionError(
                f"line {lineno}: unparseable value {raw_v!r}"
            ) from e
        if families[fam]["type"] == "counter" and name == fam and value < 0:
            raise ExpositionError(
                f"line {lineno}: counter {fam!r} is negative ({value})"
            )
        if m.group("exvalue") is not None:
            # exemplar lint: allowed only where OpenMetrics allows them
            # (histogram buckets, counters), with valid label syntax and
            # a parseable value
            if not (name.endswith("_bucket") or name.endswith("_total")):
                raise ExpositionError(
                    f"line {lineno}: exemplar on non-bucket/counter "
                    f"sample {name!r}"
                )
            if m.group("exlabels"):
                _parse_labels(m.group("exlabels"))
            try:
                float(m.group("exvalue"))
            except ValueError as e:
                raise ExpositionError(
                    f"line {lineno}: unparseable exemplar value "
                    f"{m.group('exvalue')!r}"
                ) from e
        families[fam]["samples"].append((name, labels, value))

    # histogram structural lint: buckets cumulative + +Inf == _count.
    # Grouped by the non-`le` label set: a labeled exposition (the fleet's
    # per-cluster series) interleaves independent bucket ladders in one
    # family, and each ladder must hold the invariants on its own.
    for fam, info in families.items():
        if info["type"] != "histogram":
            continue
        ladders: dict[tuple, list] = {}
        for name, labels, v in info["samples"]:
            if name != fam + "_bucket":
                continue
            key = tuple(sorted((k, x) for k, x in labels.items() if k != "le"))
            ladders.setdefault(key, []).append((labels.get("le"), v))
        if not ladders:
            raise ExpositionError(f"histogram {fam!r} emitted no buckets")
        counts_by_key = {
            tuple(sorted(labels.items())): v
            for name, labels, v in info["samples"]
            if name == fam + "_count"
        }
        for key, buckets in ladders.items():
            if buckets[-1][0] != "+Inf":
                raise ExpositionError(
                    f"histogram {fam!r}{dict(key)} missing the +Inf bucket"
                )
            prev = -1.0
            for le, v in buckets:
                if v < prev:
                    raise ExpositionError(
                        f"histogram {fam!r}{dict(key)} bucket le={le} "
                        f"decreases ({v} < {prev})"
                    )
                prev = v
            count = counts_by_key.get(key)
            if count is not None and count != buckets[-1][1]:
                raise ExpositionError(
                    f"histogram {fam!r}{dict(key)}: +Inf bucket "
                    f"{buckets[-1][1]} != _count {count}"
                )
    return families
