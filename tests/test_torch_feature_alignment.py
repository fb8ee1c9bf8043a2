"""Feature alignment in the port against the JAX package on the CPU.

- The schema inferred from a table, its JSON, and the aligned feature and
  target arrays are equal, for numeric, binary, ordinal and string (TF-IDF)
  columns with missing values and categories the schema does not know, a
  column one client lacks, and a table that is no ``DataFrame`` (the card's
  machine has no pandas: a dict-backed table with ``.columns``, ``len()``
  and ``[name]``).
- ``examples/feature_alignment_example/run.py`` end to end: three clients
  (one without ``bp``), the two polls, then FedAvg of ``Mlp((16,), 2)``
  with Adam(5e-3), 5 local steps of batch 8, 3 rounds, from JAX's init;
  each round's losses and metrics (``accuracy``, ``balanced_accuracy``,
  ``f1``, ``binned_auc`` on the eval path) and the final params at 5e-4.
"""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import optax
import pandas as pd
import pytest

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.feature_alignment import orchestration as jorch
from fl4health_tpu.feature_alignment import preprocessor as jpre
from fl4health_tpu.feature_alignment import schema as jschema
from fl4health_tpu.metrics import efficient as jeff
from fl4health_tpu.metrics.base import MetricManager as JMetrics
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server.simulation import ClientDataset as JDataset
from fl4health_tpu.server.simulation import FederatedSimulation as JSim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.feature_alignment import orchestration as torch_orch
from fl4health_tpu_torch.feature_alignment import preprocessor as tpre
from fl4health_tpu_torch.feature_alignment import schema as tschema
from fl4health_tpu_torch.metrics import efficient as teff
from fl4health_tpu_torch.metrics.base import MetricManager as TMetrics
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server.simulation import ClientDataset as TDataset
from fl4health_tpu_torch.server.simulation import FederatedSimulation as TSim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

TOL = 5e-4


class ColumnTable:
    """A column table without pandas: ``.columns``, ``len()``, ``[name]``."""

    def __init__(self, columns: dict):
        self._cols = {k: np.asarray(v, dtype=object if np.asarray(v).dtype.kind in "OU"
                                    else None) for k, v in columns.items()}

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        return len(next(iter(self._cols.values())))

    def __getitem__(self, name):
        return self._cols[name]


def _columns(n, seed, drop=False):
    """The example's frame (``examples/feature_alignment_example/run.py``)
    with a free-text note, an ordinal grade and missing values."""
    r = np.random.default_rng(seed)
    age = r.uniform(20, 90, n)
    bp = r.uniform(90, 180, n)
    sex = r.choice(["F", "M"], n)
    score = (age / 90 + (bp - 90) / 90 + (sex == "M") * 0.3) / 2.3
    y = (score + r.normal(0, 0.15, n) > 0.55).astype(int).astype(str)
    words = np.array(["chest pain", "short breath", "mild fever cough", "none reported",
                      "pain and fever"], dtype=object)
    note = words[r.integers(0, len(words), n)].copy()
    note[r.random(n) < 0.1] = None
    grade = np.array(["low", "mid", "high", "severe" if seed == 3 else "mid"],
                     dtype=object)[r.integers(0, 4, n)]
    age[r.random(n) < 0.1] = np.nan
    d = {"pid": np.arange(n), "age": age, "bp": bp, "sex": sex, "note": note, "grade": grade,
         "outcome": y}
    if drop:
        del d["bp"]
    return d


@pytest.mark.parametrize("table", [pd.DataFrame, ColumnTable], ids=["dataframe", "columns"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_schema_and_aligned_arrays_match_jax(seed, table):
    """Each package reads the same table. (pandas stores a string column's
    None as NaN, whose text "nan" then enters the TF-IDF vocabulary; a
    column table keeps None, which imputes: both packages alike.)"""
    source = table(_columns(60, 1))
    enc_j = jschema.TabularFeaturesInfoEncoder.encoder_from_dataframe(source, "pid", ["outcome"])
    enc_t = tschema.TabularFeaturesInfoEncoder.encoder_from_dataframe(source, "pid", ["outcome"])
    assert enc_t.to_json() == enc_j.to_json()
    assert [f.feature_type.value for f in enc_t.get_tabular_features()] == \
        [f.feature_type.value for f in enc_j.get_tabular_features()]
    schema = enc_j.to_json()
    local = table(_columns(40, seed, drop=seed == 2))
    want = jpre.TabularFeaturesPreprocessor(
        jschema.TabularFeaturesInfoEncoder.from_json(schema)).fit(local)
    got = tpre.TabularFeaturesPreprocessor(
        tschema.TabularFeaturesInfoEncoder.from_json(schema)).fit(local)
    (jx, jy), (tx, ty) = want.preprocess_features(local), got.preprocess_features(local)
    assert tx.dtype == jx.dtype == np.float32
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


def _example_clients(mod, table):
    return [mod.TabularDataClient(table(_columns(60, s, drop=(s == 2))), "pid", ["outcome"])
            for s in (1, 2, 3)]


def _jax_builder(stash):
    def builder(in_dim, out_dim, clients):
        data = []
        for c in clients:
            x, y = c.aligned_arrays()
            y = y.astype(np.int32)
            data.append(JDataset(x[:48], y[:48], x[48:], y[48:]))
        sim = JSim(logic=jengine.ClientLogic(
            jengine.from_flax(JMlp(features=(16,), n_outputs=out_dim)),
            jengine.masked_cross_entropy),
            tx=optax.adam(5e-3), strategy=JFedAvg(), datasets=data, batch_size=8,
            metrics=JMetrics((jeff.accuracy(), jeff.balanced_accuracy(out_dim),
                              jeff.f1(out_dim), jeff.binned_auc())),
            local_steps=5, seed=0, execution_mode="pipelined")
        stash["init"] = jax.tree_util.tree_map(np.asarray, sim.global_params)
        stash["dims"] = (in_dim, out_dim)
        return sim

    return builder


def _port_builder(stash):
    def builder(in_dim, out_dim, clients):
        data = []
        for c in clients:
            x, y = c.aligned_arrays()
            y = y.astype(np.int32)
            data.append(TDataset(x[:48], y[:48], x[48:], y[48:]))
        sim = TSim(logic=tengine.ClientLogic(
            tengine.from_module(TMlp(in_dim, (16,), out_dim)), tengine.masked_cross_entropy),
            tx=optim.adam(5e-3), strategy=TFedAvg(), datasets=data, batch_size=8,
            metrics=TMetrics((teff.accuracy(), teff.balanced_accuracy(out_dim),
                              teff.f1(out_dim), teff.binned_auc())),
            local_steps=5, seed=0, device="cpu")
        sim.set_global_params(convert.flax_to_torch(stash["init"]))
        stash["port_dims"] = (in_dim, out_dim)
        return sim

    return builder


def test_the_feature_alignment_example_matches_jax():
    stash = {}
    jserver = jorch.TabularFeatureAlignmentServer({}, _example_clients(jorch, ColumnTable),
                                                  _jax_builder(stash))
    jhist = jserver.fit(3)
    tserver = torch_orch.TabularFeatureAlignmentServer(
        {}, _example_clients(torch_orch, ColumnTable), _port_builder(stash))
    thist = tserver.fit(3)
    assert stash["port_dims"] == stash["dims"] and tserver.initial_polls_complete
    assert tserver.config[torch_orch.FEATURE_INFO] == jserver.config[jorch.FEATURE_INFO]
    for jc, tc in zip(jserver.clients, tserver.clients):
        for a, b in zip(tc.aligned_arrays(), jc.aligned_arrays()):
            np.testing.assert_array_equal(a, b)
    assert len(thist) == len(jhist) == 3
    for jr, tr in zip(jhist, thist):
        for got, want in ((tr.fit_losses, jr.fit_losses), (tr.eval_losses, jr.eval_losses),
                          (tr.eval_metrics, jr.eval_metrics)):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)
    assert {"balanced_accuracy", "f1", "roc_auc"} <= set(thist[-1].eval_metrics)
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jserver.sim.global_params))
    for k, v in want.items():
        np.testing.assert_allclose(tserver.sim.global_params[k].numpy(), v.numpy(), atol=TOL,
                                   rtol=0, err_msg=k)


def test_a_given_source_of_truth_skips_the_first_poll():
    schema = jschema.TabularFeaturesInfoEncoder.encoder_from_dataframe(
        pd.DataFrame(_columns(30, 5)), "pid", ["outcome"]).to_json()
    calls = []
    clients = _example_clients(torch_orch, ColumnTable)
    server = torch_orch.TabularFeatureAlignmentServer(
        {}, clients, lambda i, o, c: calls.append((i, o)) or _Fit(), feature_info_source=schema)
    server.fit(1)
    assert server.config[torch_orch.FEATURE_INFO] == schema and len(calls) == 1


class _Fit:
    def fit(self, n):
        return [n]
