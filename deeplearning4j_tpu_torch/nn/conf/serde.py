"""The ``"@type"`` registries of the JAX package's JSON config schema.

Counterpart of ``deeplearning4j_tpu/nn/conf/serde.py``. Two registries:

* layer classes register under the JAX package's registry names
  (``"Dense"``, ``"Convolution"``, ``"GravesLSTM"``, ``"TransformerBlock"``,
  ...) with :func:`register_layer`, so a JAX ``conf.to_json()`` reads here
  unchanged: every layer type the JAX package registers is registered here,
  and a name that is not registered raises;
* any dataclass registers with :func:`register_config` (a custom config, as
  in the JAX package), and :func:`to_dict` / :func:`from_dict` (and their
  JSON and YAML forms) round-trip it through ``"@type"`` exactly as the JAX
  functions do. The port's configuration classes, which write their own
  schema, serialize through their ``to_dict``, and the two network
  configurations read back through :func:`register_reader`.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Callable, Dict, Optional

LAYER_TYPES: Dict[str, type] = {}
_REGISTRY: Dict[str, type] = {}
_READERS: Dict[str, Callable[[dict], Any]] = {}
TYPE_KEY = "@type"


def register_layer(name: str):
    """Class decorator: register a layer module under its ``"@type"`` name."""
    def deco(cls):
        cls.TYPE = name
        LAYER_TYPES[name] = cls
        return cls
    return deco


def layer_class(name: str) -> type:
    from . import layers  # noqa: F401  (registers the layer modules)
    try:
        return LAYER_TYPES[name]
    except KeyError:
        raise ValueError(f"unknown layer @type {name!r}; this port reads "
                         f"{sorted(LAYER_TYPES)}") from None


def register_config(name: Optional[str] = None):
    """Class decorator registering a dataclass config under ``name``
    (default: the class name)."""
    def wrap(cls):
        key = name or cls.__name__
        if key in _REGISTRY and _REGISTRY[key] is not cls:
            raise ValueError(f"Config type '{key}' already registered to "
                             f"{_REGISTRY[key]}")
        _REGISTRY[key] = cls
        cls._config_type_name = key
        return cls
    return wrap


def register_reader(name: str, reader: Callable[[dict], Any]) -> None:
    """``from_dict`` hands a dict whose ``"@type"`` is ``name`` to
    ``reader`` (a configuration class that reads its own schema)."""
    _READERS[name] = reader


def registered_name(cls: type) -> str:
    return getattr(cls, "_config_type_name", cls.__name__)


def lookup(name: str) -> type:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown config type '{name}'. Registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def to_dict(obj: Any) -> Any:
    """A registered dataclass (or a plain value) as JSON-native data, its
    ``"@type"`` stamped; an object that writes its own schema (the port's
    configurations) as its ``to_dict()``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if registered_name(type(obj)) not in _REGISTRY \
                and callable(getattr(obj, "to_dict", None)):
            return obj.to_dict()
        d = {TYPE_KEY: registered_name(type(obj))}
        for f in dataclasses.fields(obj):
            if not f.metadata.get("serde", True):
                continue
            d[f.name] = to_dict(getattr(obj, f.name))
        return d
    raise TypeError(f"Cannot serialize {type(obj)} to config JSON")


def from_dict(data: Any) -> Any:
    """Inverse of :func:`to_dict`: dispatch on ``"@type"``."""
    if isinstance(data, list):
        return [from_dict(v) for v in data]
    if isinstance(data, dict):
        if TYPE_KEY in data:
            if data[TYPE_KEY] in _READERS and data[TYPE_KEY] not in _REGISTRY:
                return _READERS[data[TYPE_KEY]](data)
            cls = lookup(data[TYPE_KEY])
            field_names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: from_dict(v) for k, v in data.items()
                      if k != TYPE_KEY and k in field_names}
            return cls(**kwargs)
        return {k: from_dict(v) for k, v in data.items()}
    return data


def to_json(obj: Any, indent: int = 2) -> str:
    return json.dumps(to_dict(obj), indent=indent)


def from_json(s: str) -> Any:
    return from_dict(json.loads(s))


def to_yaml(obj: Any) -> str:
    """YAML of :func:`to_dict`; PyYAML is imported at call time."""
    import yaml

    return yaml.safe_dump(to_dict(obj), sort_keys=False)


def from_yaml(s: str) -> Any:
    import yaml

    return from_dict(yaml.safe_load(s))
