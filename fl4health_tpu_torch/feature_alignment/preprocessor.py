"""Numpy column transforms driven by the negotiated schema (counterpart of
``fl4health_tpu/feature_alignment/preprocessor.py``, a copy): one transform
a column from its type. Features are one-hot (unknown categories an
all-zero row), targets ordinal (unknowns a dedicated code); numeric columns
are imputed and min-max scaled; string columns TF-IDF'd against the shared
vocabulary (smooth idf, l2 rows). The output columns follow the sorted
feature names, so every client produces identically shaped arrays.
``set_feature_pipeline`` swaps a column's transform.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from fl4health_tpu_torch.feature_alignment.schema import (
    TabularFeature,
    TabularFeaturesInfoEncoder,
    TabularType,
    tokenize,
)


def _impute(col: np.ndarray, fill_value) -> np.ndarray:
    out = np.array(col, dtype=object)
    missing = np.asarray([v is None or v != v for v in out])
    out[missing] = fill_value
    return out


class _NumericTransform:
    """Impute + min-max scale. The scaler
    is fit explicitly via ``fit`` (TabularFeaturesPreprocessor.fit does this on
    the training dataframe) — or lazily on the first column seen — and the
    stored min/max are reused afterwards, matching sklearn's fit-then-transform
    pipeline so train and validation/test scale consistently."""

    def __init__(self, feature: TabularFeature):
        self.feature = feature
        self.lo: float | None = None
        self.scale: float = 1.0

    def fit(self, col: np.ndarray) -> "_NumericTransform":
        vals = _impute(col, self.feature.fill_value).astype(np.float64)
        lo, hi = float(np.min(vals)), float(np.max(vals))
        self.lo = lo
        self.scale = (hi - lo) if hi > lo else 1.0
        return self

    def __call__(self, col: np.ndarray) -> np.ndarray:
        if self.lo is None:
            self.fit(col)
        vals = _impute(col, self.feature.fill_value).astype(np.float64)
        return ((vals - self.lo) / self.scale)[:, None]


def _numeric_transform(feature: TabularFeature) -> Callable[[np.ndarray], np.ndarray]:
    return _NumericTransform(feature)


def _categorical_transform(feature: TabularFeature, one_hot: bool
                           ) -> Callable[[np.ndarray], np.ndarray]:
    """One-hot with ignored unknowns (features) or ordinal with a dedicated
    unknown code (targets)."""
    categories = [str(c) for c in feature.metadata]
    index = {c: i for i, c in enumerate(categories)}

    def transform(col: np.ndarray) -> np.ndarray:
        vals = [str(v) for v in _impute(col, feature.fill_value)]
        codes = np.asarray([index.get(v, -1) for v in vals])
        if one_hot:
            out = np.zeros((len(vals), len(categories)), np.float64)
            known = codes >= 0
            out[np.nonzero(known)[0], codes[known]] = 1.0  # unknown -> all-zero row
            return out
        unknown_code = len(categories) + 1  # OrdinalEncoder's unknown_value
        return np.where(codes >= 0, codes, unknown_code).astype(np.float64)[:, None]

    return transform


class _TfidfTransform:
    """TF-IDF against the shared vocabulary: smooth idf, l2-normalized rows —
    sklearn's defaults. idf is fit once (explicitly via ``fit`` or lazily on
    the first corpus), like the reference's fitted TfidfVectorizer."""

    def __init__(self, feature: TabularFeature):
        self.feature = feature
        self.vocab = {tok: i for i, tok in enumerate(feature.metadata)}
        self.idf: np.ndarray | None = None

    def _counts(self, col: np.ndarray) -> np.ndarray:
        docs = [tokenize(x) for x in _impute(col, self.feature.fill_value)]
        counts = np.zeros((len(docs), len(self.vocab)), np.float64)
        for row, doc in enumerate(docs):
            for tok in doc:
                j = self.vocab.get(tok)
                if j is not None:
                    counts[row, j] += 1.0
        return counts

    def fit(self, col: np.ndarray) -> "_TfidfTransform":
        counts = self._counts(col)
        n = counts.shape[0]
        df = np.count_nonzero(counts, axis=0)
        self.idf = np.log((1.0 + n) / (1.0 + df)) + 1.0  # smooth_idf
        return self

    def __call__(self, col: np.ndarray) -> np.ndarray:
        counts = self._counts(col)
        if self.idf is None:
            n = counts.shape[0]
            df = np.count_nonzero(counts, axis=0)
            self.idf = np.log((1.0 + n) / (1.0 + df)) + 1.0
        tfidf = counts * self.idf[None, :]
        norms = np.linalg.norm(tfidf, axis=1, keepdims=True)
        return tfidf / np.maximum(norms, 1e-12)


def _tfidf_transform(feature: TabularFeature) -> Callable[[np.ndarray], np.ndarray]:
    return _TfidfTransform(feature)


def _default_transform(feature: TabularFeature, one_hot: bool):
    t = feature.feature_type
    if t is TabularType.NUMERIC:
        return _numeric_transform(feature)
    if t in (TabularType.BINARY, TabularType.ORDINAL):
        return _categorical_transform(feature, one_hot=one_hot)
    return _tfidf_transform(feature)


class TabularFeaturesPreprocessor:
    """Schema-driven dataframe -> aligned arrays."""

    def __init__(self, tab_feature_encoder: TabularFeaturesInfoEncoder):
        self.encoder = tab_feature_encoder
        self.features_to_pipelines: dict[str, Callable] = {
            f.feature_name: _default_transform(f, one_hot=True)
            for f in tab_feature_encoder.get_tabular_features()
        }
        self.targets_to_pipelines: dict[str, Callable] = {
            t.feature_name: _default_transform(t, one_hot=False)
            for t in tab_feature_encoder.get_tabular_targets()
        }

    def fit(self, df) -> "TabularFeaturesPreprocessor":
        """Explicitly fit all stateful column transforms (scalers, idf) on the
        TRAINING dataframe. Callers that preprocess multiple splits should fit
        here first; otherwise transforms lazily fit on the first column they
        see, which makes call order significant."""
        n = len(df)
        for feature in self.encoder.get_tabular_features():
            pipe = self.features_to_pipelines[feature.feature_name]
            if hasattr(pipe, "fit"):
                pipe.fit(self._get_column(df, feature.feature_name,
                                          feature.fill_value, n))
        for target in self.encoder.get_tabular_targets():
            pipe = self.targets_to_pipelines[target.feature_name]
            if hasattr(pipe, "fit"):
                pipe.fit(self._get_column(df, target.feature_name,
                                          target.fill_value, n))
        return self

    def set_feature_pipeline(self, feature_name: str, transform: Callable) -> None:
        """Per-column customization hook."""
        if feature_name in self.features_to_pipelines:
            self.features_to_pipelines[feature_name] = transform
        if feature_name in self.targets_to_pipelines:
            self.targets_to_pipelines[feature_name] = transform

    def _get_column(self, df, name: str, fill_value, n_rows: int) -> np.ndarray:
        # Columns missing entirely from a client's dataframe are synthesized
        # from the fill value — the core of cross-client alignment.
        if name in df.columns:
            return np.asarray(df[name], dtype=object)
        return np.full((n_rows,), fill_value, dtype=object)

    def preprocess_features(self, df) -> tuple[np.ndarray, np.ndarray]:
        """-> (aligned_features, aligned_targets)."""
        n = len(df)
        blocks = []
        for feature in self.encoder.get_tabular_features():  # sorted order
            col = self._get_column(df, feature.feature_name, feature.fill_value, n)
            blocks.append(self.features_to_pipelines[feature.feature_name](col))
        x = np.concatenate(blocks, axis=1) if blocks else np.zeros((n, 0))

        target_blocks = []
        for target in self.encoder.get_tabular_targets():
            col = self._get_column(df, target.feature_name, target.fill_value, n)
            target_blocks.append(self.targets_to_pipelines[target.feature_name](col))
        y = np.concatenate(target_blocks, axis=1) if target_blocks else np.zeros((n, 0))
        if y.shape[1] == 1:
            y = y[:, 0]
        return x.astype(np.float32), y.astype(np.float32)
