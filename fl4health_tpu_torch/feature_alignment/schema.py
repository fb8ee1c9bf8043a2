"""Tabular feature schema (counterpart of
``fl4health_tpu/feature_alignment/schema.py``, a numpy copy): the column
types, per-feature info, and the JSON-serializable encoder one client
provides and the server broadcasts, so every client encodes alike.

Host-side by design: the schema is negotiated once before training. A
table is read only through ``.columns``, ``len()`` and ``table[name]``, so
any column table serves (a pandas ``DataFrame``, or a dict-backed one on a
machine without pandas); this module imports no pandas.
"""

from __future__ import annotations

import enum
import json
import re
from dataclasses import dataclass, field
from typing import Any

import numpy as np


class TabularType(str, enum.Enum):
    """A column's type."""

    NUMERIC = "numeric"
    BINARY = "binary"
    STRING = "string"
    ORDINAL = "ordinal"

    @staticmethod
    def get_default_fill_value(tabular_type: "TabularType | str") -> Any:
        """Per-type imputation default."""
        t = TabularType(tabular_type)
        if t is TabularType.NUMERIC:
            return 0.0
        if t is TabularType.BINARY:
            return 0
        if t is TabularType.STRING:
            return "N/A"
        return "UNKNOWN"  # ORDINAL


@dataclass
class TabularFeature:
    """Per-column info."""

    feature_name: str
    feature_type: TabularType
    fill_value: Any = None
    metadata: list = field(default_factory=list)

    def __post_init__(self):
        self.feature_type = TabularType(self.feature_type)
        if self.fill_value is None:
            self.fill_value = TabularType.get_default_fill_value(self.feature_type)

    def get_feature_name(self) -> str:
        return self.feature_name

    def get_feature_type(self) -> TabularType:
        return self.feature_type

    def get_fill_value(self) -> Any:
        return self.fill_value

    def get_metadata(self) -> list:
        return self.metadata

    def get_metadata_dimension(self) -> int:
        """Aligned width of this feature."""
        if self.feature_type in (TabularType.BINARY, TabularType.ORDINAL):
            return len(self.metadata)
        if self.feature_type is TabularType.NUMERIC:
            return 1
        raise ValueError("metadata dimension undefined for STRING features")

    def to_json(self) -> str:
        return json.dumps(
            {
                "feature_name": self.feature_name,
                "feature_type": self.feature_type.value,
                "fill_value": self.fill_value,
                "metadata": list(self.metadata),
            }
        )

    @staticmethod
    def from_json(s: str) -> "TabularFeature":
        d = json.loads(s)
        return TabularFeature(
            d["feature_name"], TabularType(d["feature_type"]),
            d.get("fill_value"), d.get("metadata") or [],
        )


_WORD = re.compile(r"(?u)\b\w\w+\b")  # sklearn CountVectorizer token pattern


def tokenize(text: str) -> list[str]:
    return _WORD.findall(str(text).lower())


def build_vocabulary(column) -> list[str]:
    """Sorted token vocabulary of a string column (the
    reference fits a CountVectorizer for the same purpose)."""
    vocab = set()
    for value in column:
        vocab.update(tokenize(value))
    return sorted(vocab)


def infer_feature_type(column) -> TabularType:
    """Column type inference: bools and
    two-valued columns are BINARY; numeric dtypes are NUMERIC; free-text
    (multi-token) object columns are STRING; other object columns ORDINAL."""
    arr = np.asarray(column)
    non_null = arr[[v == v and v is not None for v in arr]] if arr.dtype == object else arr
    uniques = np.unique(non_null.astype(str) if arr.dtype == object else non_null)
    if len(uniques) <= 2:
        return TabularType.BINARY
    if np.issubdtype(arr.dtype, np.number) or np.issubdtype(arr.dtype, np.bool_):
        return TabularType.NUMERIC
    # Object column: free text if values are multi-token on average.
    sample = [str(v) for v in non_null[:50]]
    avg_tokens = np.mean([len(tokenize(v)) for v in sample]) if sample else 0
    if avg_tokens > 1.5:
        return TabularType.STRING
    return TabularType.ORDINAL


class TabularFeaturesInfoEncoder:
    """The serializable schema. Targets are
    not included in tabular_features."""

    def __init__(self, tabular_features: list[TabularFeature],
                 tabular_targets: list[TabularFeature]):
        self.tabular_features = sorted(tabular_features, key=lambda f: f.feature_name)
        self.tabular_targets = sorted(tabular_targets, key=lambda f: f.feature_name)

    def get_tabular_features(self) -> list[TabularFeature]:
        return self.tabular_features

    def get_tabular_targets(self) -> list[TabularFeature]:
        return self.tabular_targets

    def get_feature_columns(self) -> list[str]:
        return sorted(f.feature_name for f in self.tabular_features)

    def get_target_columns(self) -> list[str]:
        return sorted(f.feature_name for f in self.tabular_targets)

    def features_by_type(self, t: TabularType) -> list[TabularFeature]:
        return sorted(
            (f for f in self.tabular_features if f.feature_type == t),
            key=lambda f: f.feature_name,
        )

    def get_target_dimension(self) -> int:
        """Width of the aligned target block."""
        return sum(t.get_metadata_dimension() for t in self.tabular_targets)

    @staticmethod
    def _construct_tab_feature(df, name: str, ftype: TabularType,
                               fill_values: dict | None) -> TabularFeature:
        """One column's feature info from the table."""
        fill = None if fill_values is None else fill_values.get(name)
        col = df[name]
        if ftype in (TabularType.ORDINAL, TabularType.BINARY):
            cats = sorted({str(v) for v in col if v == v and v is not None})
            return TabularFeature(name, ftype, fill, cats)
        if ftype is TabularType.STRING:
            return TabularFeature(name, ftype, fill, build_vocabulary(col))
        return TabularFeature(name, ftype, fill)

    @staticmethod
    def encoder_from_dataframe(df, id_column: str, target_columns,
                               fill_values: dict | None = None
                               ) -> "TabularFeaturesInfoEncoder":
        """Infer the schema from a raw dataframe."""
        if isinstance(target_columns, str):
            target_columns = [target_columns]
        features, targets = [], []
        for name in sorted(df.columns):
            if name == id_column:
                continue
            ftype = infer_feature_type(df[name])
            feat = TabularFeaturesInfoEncoder._construct_tab_feature(
                df, name, ftype, fill_values
            )
            (targets if name in target_columns else features).append(feat)
        return TabularFeaturesInfoEncoder(features, targets)

    def to_json(self) -> str:
        return json.dumps(
            {
                "tabular_features": json.dumps([f.to_json() for f in self.tabular_features]),
                "tabular_targets": json.dumps([t.to_json() for t in self.tabular_targets]),
            }
        )

    @staticmethod
    def from_json(s: str) -> "TabularFeaturesInfoEncoder":
        d = json.loads(s)
        return TabularFeaturesInfoEncoder(
            [TabularFeature.from_json(f) for f in json.loads(d["tabular_features"])],
            [TabularFeature.from_json(t) for t in json.loads(d["tabular_targets"])],
        )
