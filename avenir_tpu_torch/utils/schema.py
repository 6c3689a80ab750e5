"""JSON feature-schema metadata.

Re-provides the chombo ``FeatureSchema`` / ``FeatureField`` contract that every
reference job loads in ``setup()`` (e.g. the reference's
BayesianDistribution.java:118-120). A copy of ``avenir_tpu/utils/schema.py``:
the port imports nothing of the JAX package.
Two on-disk layouts exist and both are accepted:

- flat:   ``{"fields": [...]}``                    (resource/churn.json)
- entity: ``{"entity": {"fields": [...]}, ...}``   (resource/elearnActivity.json,
  which also carries top-level ``distAlgorithm`` / ``numericDiffThreshold`` used
  by the pairwise-distance kernel)

Field attributes mirror the reference's accessor surface
(isCategorical/isInteger/getBucketWidth/getCardinality/cardinalityIndex/
getMaxSplit/getMin/getMax — see SURVEY.md §2.9).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

_CATEGORICAL = "categorical"
_NUMERIC_TYPES = ("int", "long", "double", "float")


@dataclass
class FeatureField:
    """One column of the CSV record, as described by the schema JSON."""

    name: str
    ordinal: int
    data_type: str = "string"
    is_id: bool = False
    is_feature: bool = False
    is_class_attribute: bool = False
    cardinality: Optional[List[str]] = None
    min: Optional[float] = None
    max: Optional[float] = None
    bucket_width: Optional[float] = None
    max_split: Optional[int] = None
    weight: float = 1.0
    extra: Dict[str, Any] = field(default_factory=dict)

    # -- type predicates (chombo FeatureField accessor surface) --------------
    @property
    def is_categorical(self) -> bool:
        return self.data_type == _CATEGORICAL

    @property
    def is_numeric(self) -> bool:
        return self.data_type in _NUMERIC_TYPES

    @property
    def is_integer(self) -> bool:
        return self.data_type in ("int", "long")

    @property
    def is_text(self) -> bool:
        return self.data_type == "text"

    @property
    def is_binned(self) -> bool:
        """True when the field yields a discrete bin id.

        Categorical fields bin by vocabulary index; numeric fields bin by
        ``value // bucket_width`` (the reference's binning at
        BayesianDistribution.java:153). Numeric fields without a bucket width
        stay continuous (Gaussian-modeled in Naive Bayes).
        """
        if self.is_categorical:
            return True
        return self.is_numeric and self.bucket_width is not None

    def cardinality_index(self, value: str) -> int:
        """Vocabulary index of a categorical value (chombo cardinalityIndex)."""
        if self.cardinality is None:
            raise ValueError(f"field {self.name} has no cardinality list")
        return self.cardinality.index(value)

    def num_bins(self) -> int:
        """Number of discrete bins this field can produce."""
        if self.is_categorical:
            if self.cardinality is None:
                raise ValueError(
                    f"categorical field {self.name} needs a cardinality list "
                    "(or a vocabulary built from data by the featurizer)"
                )
            return len(self.cardinality)
        if self.bucket_width is not None:
            if self.min is None or self.max is None:
                raise ValueError(
                    f"binned numeric field {self.name} needs min/max to size bins"
                )
            return int(self.max // self.bucket_width) - int(self.min // self.bucket_width) + 1
        raise ValueError(f"field {self.name} is continuous; it has no bin count")

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "FeatureField":
        known = {
            "name", "ordinal", "dataType", "id", "feature", "classAttribute",
            "cardinality", "min", "max", "bucketWidth", "maxSplit", "weight",
        }
        card = obj.get("cardinality")
        return FeatureField(
            name=obj["name"],
            ordinal=int(obj["ordinal"]),
            data_type=obj.get("dataType", "string"),
            is_id=bool(obj.get("id", False)),
            is_feature=bool(obj.get("feature", False)),
            is_class_attribute=bool(obj.get("classAttribute", False)),
            cardinality=[str(c) for c in card] if card is not None else None,
            min=obj.get("min"),
            max=obj.get("max"),
            bucket_width=obj.get("bucketWidth"),
            max_split=obj.get("maxSplit"),
            weight=float(obj.get("weight", 1.0)),
            extra={k: v for k, v in obj.items() if k not in known},
        )


class FeatureSchema:
    """Ordered collection of :class:`FeatureField` plus entity-level metadata."""

    def __init__(self, fields: Sequence[FeatureField],
                 entity_name: Optional[str] = None,
                 dist_algorithm: Optional[str] = None,
                 numeric_diff_threshold: Optional[float] = None):
        self.fields: List[FeatureField] = sorted(fields, key=lambda f: f.ordinal)
        self.entity_name = entity_name
        self.dist_algorithm = dist_algorithm
        self.numeric_diff_threshold = numeric_diff_threshold
        self._by_ordinal = {f.ordinal: f for f in self.fields}
        self._by_name = {f.name: f for f in self.fields}

    # -- lookups (chombo FeatureSchema surface) ------------------------------
    def find_field_by_ordinal(self, ordinal: int) -> FeatureField:
        return self._by_ordinal[ordinal]

    def find_field_by_name(self, name: str) -> FeatureField:
        return self._by_name[name]

    def find_class_attr_field(self) -> FeatureField:
        """The class/label column.

        Prefers an explicit ``classAttribute`` flag (elearnActivity.json);
        falls back to the sole non-id, non-feature categorical column, which is
        how churn.json marks its ``status`` label implicitly.
        """
        flagged = [f for f in self.fields if f.is_class_attribute]
        if flagged:
            return flagged[0]
        implicit = [
            f for f in self.fields
            if f.is_categorical and not f.is_feature and not f.is_id
        ]
        if len(implicit) == 1:
            return implicit[0]
        raise ValueError("schema has no identifiable class attribute field")

    def get_feature_fields(self) -> List[FeatureField]:
        fields = [f for f in self.fields if f.is_feature]
        if fields:
            return fields
        # elearnActivity.json marks no 'feature' flags: every non-id,
        # non-class, non-string field is a feature.
        cls_ord = None
        try:
            cls_ord = self.find_class_attr_field().ordinal
        except ValueError:
            pass
        return [
            f for f in self.fields
            if not f.is_id and f.ordinal != cls_ord
            and (f.is_categorical or f.is_numeric or f.is_text)
        ]

    def get_feature_field_ordinals(self) -> List[int]:
        return [f.ordinal for f in self.get_feature_fields()]

    def find_id_field(self) -> Optional[FeatureField]:
        for f in self.fields:
            if f.is_id:
                return f
        return None

    def num_columns(self) -> int:
        return max(f.ordinal for f in self.fields) + 1

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "FeatureSchema":
        entity_name = None
        dist_algorithm = obj.get("distAlgorithm")
        numeric_diff_threshold = obj.get("numericDiffThreshold")
        if "entity" in obj:
            entity = obj["entity"]
            entity_name = entity.get("name")
            raw_fields = entity["fields"]
        else:
            raw_fields = obj["fields"]
        fields = [FeatureField.from_json(f) for f in raw_fields]
        return FeatureSchema(fields, entity_name=entity_name,
                             dist_algorithm=dist_algorithm,
                             numeric_diff_threshold=numeric_diff_threshold)

    @staticmethod
    def from_file(path: str) -> "FeatureSchema":
        with open(path, "r") as fh:
            return FeatureSchema.from_json(json.load(fh))

    @staticmethod
    def from_string(text: str) -> "FeatureSchema":
        return FeatureSchema.from_json(json.loads(text))
