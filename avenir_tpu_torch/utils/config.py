"""Flat ``.properties`` configuration.

The reference's layered config system (SURVEY.md §5 "Config / flag system")
loads a flat properties file wholesale into the Hadoop ``Configuration``
(chombo ``Utility.setConfiguration(conf, "avenir")``,
BayesianDistribution.java:68) and every job reads ~120 distinct keys with
typed getters and defaults (chombo ``ConfigUtility``). ``JobConfig``
re-provides that: same file format, same key names, typed accessors.
A copy of ``avenir_tpu/utils/config.py``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Mapping, Optional


def parse_properties(text: str) -> Dict[str, str]:
    """Parse java-style ``key=value`` properties; ``#``/``!`` comment lines.

    Later assignments win (the reference's knn.properties assigns
    ``num.reducer`` twice; java.util.Properties keeps the last one).
    """
    props: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("!"):
            continue
        for sep in ("=", ":"):
            if sep in line:
                key, _, value = line.partition(sep)
                props[key.strip()] = value.strip()
                break
    return props


class JobConfig:
    """Typed view over flat string properties, with defaults."""

    def __init__(self, props: Optional[Mapping[str, Any]] = None):
        self._props: Dict[str, str] = {
            str(k): str(v) for k, v in (props or {}).items()
        }

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_file(path: str) -> "JobConfig":
        with open(path, "r") as fh:
            text = fh.read()
        if path.endswith(".json"):
            return JobConfig(json.loads(text))
        return JobConfig(parse_properties(text))

    @staticmethod
    def from_string(text: str) -> "JobConfig":
        return JobConfig(parse_properties(text))

    # -- mutation ------------------------------------------------------------
    def set(self, key: str, value: Any) -> "JobConfig":
        self._props[key] = str(value)
        return self

    def update(self, other: Mapping[str, Any]) -> "JobConfig":
        for k, v in other.items():
            self.set(k, v)
        return self

    # -- typed getters (chombo ConfigUtility surface) ------------------------
    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._props.get(key, default)

    def get_required(self, key: str) -> str:
        if key not in self._props:
            raise KeyError(f"missing required configuration key: {key}")
        return self._props[key]

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        value = self._props.get(key)
        return int(value) if value is not None else default

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        value = self._props.get(key)
        return float(value) if value is not None else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        value = self._props.get(key)
        if value is None:
            return default
        return value.lower() in ("true", "yes", "1", "on")

    def get_list(self, key: str, default: Optional[List[str]] = None,
                 delim: str = ",") -> Optional[List[str]]:
        value = self._props.get(key)
        if value is None:
            return default
        return [item.strip() for item in value.split(delim) if item.strip()]

    def get_int_list(self, key: str, default: Optional[List[int]] = None,
                     delim: str = ",") -> Optional[List[int]]:
        items = self.get_list(key, None, delim)
        return [int(i) for i in items] if items is not None else default

    def get_float_list(self, key: str, default: Optional[List[float]] = None,
                       delim: str = ",") -> Optional[List[float]]:
        items = self.get_list(key, None, delim)
        return [float(i) for i in items] if items is not None else default

    # -- misc ----------------------------------------------------------------
    def keys(self) -> Iterable[str]:
        return self._props.keys()

    def as_dict(self) -> Dict[str, str]:
        return dict(self._props)

    def __contains__(self, key: str) -> bool:
        return key in self._props

    def __repr__(self) -> str:
        return f"JobConfig({len(self._props)} keys)"


# Keys shared by nearly every reference job (resource/knn.properties:1-7).
FIELD_DELIM = "field.delim"
FIELD_DELIM_REGEX = "field.delim.regex"
DEBUG_ON = "debug.on"
FEATURE_SCHEMA_FILE_PATH = "feature.schema.file.path"
