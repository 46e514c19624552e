"""Typed configuration kernel.

Reference: cruise-control-core common/config/ConfigDef.java (a copy of
Kafka's typed ConfigDef: chained define() with type/default/validator/
importance/doc), AbstractConfig, CruiseControlConfigurable (configure
callback on instantiated plugins).
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
from typing import Any, Callable


class ConfigType(enum.Enum):
    BOOLEAN = "boolean"
    INT = "int"
    LONG = "long"
    DOUBLE = "double"
    STRING = "string"
    LIST = "list"  # comma-separated string -> list[str]
    CLASS = "class"  # dotted path -> class object


class Importance(enum.Enum):
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


class ConfigException(ValueError):
    pass


NO_DEFAULT = object()


@dataclasses.dataclass
class ConfigKey:
    name: str
    type: ConfigType
    default: Any
    importance: Importance
    doc: str
    validator: Callable[[str, Any], None] | None = None
    group: str = ""

    @property
    def has_default(self) -> bool:
        return self.default is not NO_DEFAULT


def in_range(lo=None, hi=None):
    """Reference ConfigDef.Range.between / atLeast."""

    def check(name, v):
        if lo is not None and v < lo:
            raise ConfigException(f"{name}={v} below minimum {lo}")
        if hi is not None and v > hi:
            raise ConfigException(f"{name}={v} above maximum {hi}")

    return check


def in_values(*allowed):
    """Reference ConfigDef.ValidString.in."""

    def check(name, v):
        if v not in allowed:
            raise ConfigException(f"{name}={v!r} not in {allowed}")

    return check


class ConfigDef:
    def __init__(self):
        self._keys: dict[str, ConfigKey] = {}

    def define(
        self,
        name: str,
        type: ConfigType,
        default: Any = NO_DEFAULT,
        importance: Importance = Importance.MEDIUM,
        doc: str = "",
        validator: Callable[[str, Any], None] | None = None,
        group: str = "",
    ) -> "ConfigDef":
        if name in self._keys:
            raise ConfigException(f"config {name} already defined")
        self._keys[name] = ConfigKey(name, type, default, importance, doc, validator, group)
        return self

    def merge(self, other: "ConfigDef") -> "ConfigDef":
        for k in other._keys.values():
            if k.name in self._keys:
                raise ConfigException(f"config {k.name} defined in two groups")
            self._keys[k.name] = k
        return self

    def keys(self) -> dict[str, ConfigKey]:
        return dict(self._keys)

    def parse(self, props: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        unknown = set(props) - set(self._keys)
        # unknown keys are tolerated (reference logs them) but kept raw
        for name, key in self._keys.items():
            if name in props:
                value = _coerce(name, props[name], key.type)
            elif key.has_default:
                value = _coerce(name, key.default, key.type) if key.default is not None else None
            else:
                raise ConfigException(f"missing required config {name}")
            if key.validator is not None and value is not None:
                key.validator(name, value)
            out[name] = value
        for name in unknown:
            out[name] = props[name]
        return out

    def doc_table(self) -> list[dict]:
        """Configuration reference documentation rows."""
        return [
            {
                "name": k.name,
                "type": k.type.value,
                "default": None if not k.has_default else k.default,
                "importance": k.importance.value,
                "group": k.group,
                "doc": k.doc,
            }
            for k in sorted(self._keys.values(), key=lambda k: (k.group, k.name))
        ]


def _coerce(name: str, value: Any, t: ConfigType) -> Any:
    try:
        if t == ConfigType.BOOLEAN:
            if isinstance(value, bool):
                return value
            return str(value).strip().lower() in ("true", "1", "yes")
        if t in (ConfigType.INT, ConfigType.LONG):
            return int(value)
        if t == ConfigType.DOUBLE:
            return float(value)
        if t == ConfigType.STRING:
            return None if value is None else str(value)
        if t == ConfigType.LIST:
            if isinstance(value, (list, tuple)):
                return [str(v) for v in value]
            if value is None or value == "":
                return []
            return [s.strip() for s in str(value).split(",") if s.strip()]
        if t == ConfigType.CLASS:
            if value is None or isinstance(value, type):
                return value
            mod, _, cls = str(value).rpartition(".")
            return getattr(importlib.import_module(mod), cls)
    except ConfigException:
        raise
    except Exception as e:  # noqa: BLE001
        raise ConfigException(f"cannot parse {name}={value!r} as {t.value}: {e}") from e
    raise ConfigException(f"unknown config type {t}")


class AbstractConfig:
    """Reference common/config/AbstractConfig.java + getConfiguredInstance
    (config/KafkaCruiseControlConfig.java:63-104): plugins are instantiated
    from CLASS configs and, if they expose `configure(config)`, called back
    with the full config."""

    def __init__(self, definition: ConfigDef, props: dict[str, Any]):
        self.definition = definition
        self._values = definition.parse(props)

    def get(self, name: str) -> Any:
        if name not in self._values:
            raise ConfigException(f"unknown config {name}")
        return self._values[name]

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def get_configured_instance(self, name: str, expected_type: type | None = None, **kwargs):
        cls = self.get(name)
        if cls is None:
            return None
        obj = cls(**kwargs)
        if expected_type is not None and not isinstance(obj, expected_type):
            raise ConfigException(f"{name}={cls} is not a {expected_type}")
        configure = getattr(obj, "configure", None)
        if callable(configure):
            configure(self)
        return obj

    def values(self) -> dict[str, Any]:
        return dict(self._values)
