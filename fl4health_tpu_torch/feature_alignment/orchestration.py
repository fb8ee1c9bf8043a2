"""Tabular feature alignment, the two-poll protocol (counterpart of
``fl4health_tpu/feature_alignment/orchestration.py``).

Before round 1 the server runs up to two polls: (1) without a source of
truth for the schema, it polls ONE random client for its schema and
broadcasts it with ``source_specified`` true; (2) once the clients have
aligned their local tables to that schema, it polls for the model's input
and output dimensions. Only then is the model built (``sim_builder``: a
port ``FederatedSimulation`` over the aligned arrays) and the rounds run.

Polls are in-process property lookups (``server/servers.py``
``poll_clients``); the schema travels as JSON (never pickle); alignment is
the numpy preprocessor (``feature_alignment/preprocessor.py``). A client's
table is any column table (``.columns``, ``len()``, ``table[name]``): no
pandas import.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from fl4health_tpu_torch.feature_alignment.preprocessor import TabularFeaturesPreprocessor
from fl4health_tpu_torch.feature_alignment.schema import TabularFeaturesInfoEncoder
from fl4health_tpu_torch.server.servers import poll_clients

logger = logging.getLogger(__name__)

# Wire keys.
FEATURE_INFO = "feature_info"
SOURCE_SPECIFIED = "source_specified"
INPUT_DIMENSION = "input_dimension"
OUTPUT_DIMENSION = "output_dimension"


class TabularDataClient:
    """Client half: owns a raw table; on the
    first poll offers its own schema; on the second poll aligns its frame to
    the server-chosen schema and reports the encoded dimensions.
    """

    def __init__(self, df, id_column: str, target_columns: Sequence[str]):
        self.df = df
        self.id_column = id_column
        self.target_columns = list(target_columns)
        self.aligned: tuple[np.ndarray, np.ndarray] | None = None
        self.preprocessor: TabularFeaturesPreprocessor | None = None

    # -- the get_properties handler ------------------------------------------
    def get_properties(self, request: Mapping[str, Any]) -> dict[str, Any]:
        if not request.get(SOURCE_SPECIFIED, False):
            # Poll 1: offer the local schema as a source-of-truth candidate.
            encoder = TabularFeaturesInfoEncoder.encoder_from_dataframe(
                self.df, self.id_column, self.target_columns
            )
            return {FEATURE_INFO: encoder.to_json()}
        # Poll 2: align to the broadcast schema, report dimensions. The
        # output dimension is the schema's target width (number of classes
        # for an ordinal/binary target), not the encoded column count — the
        # model head must cover every class the source of truth knows.
        self.align(request[FEATURE_INFO])
        assert self.aligned is not None
        x, _y = self.aligned
        encoder = TabularFeaturesInfoEncoder.from_json(request[FEATURE_INFO])
        return {
            INPUT_DIMENSION: int(x.shape[1]),
            OUTPUT_DIMENSION: max(int(encoder.get_target_dimension()), 1),
        }

    # -- alignment --------------------------------------------------------------
    def align(self, feature_info_json: str) -> tuple[np.ndarray, np.ndarray]:
        """Fit the preprocessor induced by the GLOBAL schema on the LOCAL
        frame and encode. Columns the schema knows but the frame lacks are
        imputed with the schema's fill values; local-only columns drop — the
        definition of alignment."""
        encoder = TabularFeaturesInfoEncoder.from_json(feature_info_json)
        self.preprocessor = TabularFeaturesPreprocessor(encoder).fit(self.df)
        self.aligned = self.preprocessor.preprocess_features(self.df)
        return self.aligned

    def aligned_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        assert self.aligned is not None, "align() has not run (poll 2 missing)"
        return self.aligned


class TabularFeatureAlignmentServer:
    """Server half: two pre-training polls, then deferred model construction
    and the normal federated rounds.

    ``sim_builder(input_dim, output_dim, clients)`` receives the ALIGNED
    clients and builds the port's ``FederatedSimulation``.
    """

    def __init__(
        self,
        config: dict[str, Any],
        clients: Sequence[TabularDataClient],
        sim_builder: Callable[[int, int, Sequence[TabularDataClient]], Any],
        feature_info_source: str | None = None,
        seed: int = 0,
    ):
        self.config = dict(config)
        self.clients = list(clients)
        self.sim_builder = sim_builder
        self.tab_features_info = feature_info_source
        self.seed = seed
        self.source_info_gathered = False
        self.dimension_info: dict[str, int] = {}
        self.initial_polls_complete = False
        self.sim = None

    # ------------------------------------------------------------------
    def poll_clients_for_feature_info(self) -> str:
        """Poll 1: ONE random client's schema becomes the source of truth."""
        logger.info("Feature info source unspecified — polling one random client.")
        idx = int(np.random.default_rng(self.seed).integers(len(self.clients)))
        request = {**self.config, SOURCE_SPECIFIED: False}
        props = poll_clients([self.clients[idx].get_properties], request)[0]
        return str(props[FEATURE_INFO])

    def poll_clients_for_dimension_info(self) -> tuple[int, int]:
        """Poll 2: ALL clients align (the broadcast does real work on
        every client); dimensions are read from the first since aligned
        frames agree by construction."""
        request = {
            **self.config,
            SOURCE_SPECIFIED: True,
            FEATURE_INFO: self.config[FEATURE_INFO],
        }
        results = poll_clients(
            [c.get_properties for c in self.clients], request
        )
        dims = {(r[INPUT_DIMENSION], r[OUTPUT_DIMENSION]) for r in results}
        assert len(dims) == 1, f"aligned clients disagree on dimensions: {dims}"
        return results[0][INPUT_DIMENSION], results[0][OUTPUT_DIMENSION]

    # ------------------------------------------------------------------
    def fit(self, n_rounds: int):
        if not self.initial_polls_complete:
            if self.tab_features_info is None:
                feature_info = self.poll_clients_for_feature_info()
            else:
                logger.info("Feature info source specified — broadcasting as-is.")
                feature_info = self.tab_features_info
            self.config[FEATURE_INFO] = feature_info
            self.source_info_gathered = True

            in_dim, out_dim = self.poll_clients_for_dimension_info()
            self.dimension_info[INPUT_DIMENSION] = in_dim
            self.dimension_info[OUTPUT_DIMENSION] = out_dim
            self.initial_polls_complete = True
            logger.info("Feature alignment complete: input_dim=%d output_dim=%d",
                        in_dim, out_dim)

        self.sim = self.sim_builder(
            self.dimension_info[INPUT_DIMENSION],
            self.dimension_info[OUTPUT_DIMENSION],
            self.clients,
        )
        return self.sim.fit(n_rounds)
