"""Dynamic-layer and sparse exchange in the port (``exchange/packer.py``
``Packet``, ``LayerMaskPacket``, ``SparseMaskPacket`` and their helpers;
``exchange/exchanger.py`` ``DynamicLayerExchanger``, ``SparseExchanger``;
``strategies/dynamic_layer.py``) against the JAX package on the CPU.

- both exchangers' pushes and pulls bit for bit (a mask is a selection),
  on drifts with ties: equal leaf norms (JAX's stable ``argsort`` keeps
  the lower leaf) and mostly-zero weights (``lax.top_k`` keeps the lower
  element), the global top-k over JAX's flat leaf order;
- ``FedAvgDynamicLayer`` and ``FedAvgSparse`` over packets with partial
  senders and a dropped client, at 1e-6;
- ``examples/dynamic_layer_exchange_example`` and
  ``sparse_tensor_partial_exchange_example``'s runs (3 clients, ``Mlp(16)``,
  SGD 0.05, one local epoch) from JAX's converted init, pipelined at 5e-4,
  chunked bit for bit the pipelined run."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.datasets.synthetic import synthetic_classification
from fl4health_tpu.exchange import exchanger as jex
from fl4health_tpu.exchange import packer as jpk
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server.simulation import ClientDataset as JDataset
from fl4health_tpu.server.simulation import FederatedSimulation as JSim
from fl4health_tpu.strategies import dynamic_layer as jdl
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.exchange import exchanger as tex
from fl4health_tpu_torch.exchange import packer as tpk
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server.simulation import ClientDataset as TDataset
from fl4health_tpu_torch.server.simulation import FederatedSimulation as TSim
from fl4health_tpu_torch.strategies import dynamic_layer as tdl
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults

TOL = 5e-4
FN_TOL = 1e-6
SHAPES = {"a/kernel": (4, 3), "a/bias": (3,), "b/kernel": (3, 2), "b/bias": (2,),
          "c/kernel": (2, 5)}


def _nested(flat: dict) -> dict:
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def _params(seed=0, zero_frac=0.0):
    r = np.random.default_rng(seed)
    out = {}
    for k, s in SHAPES.items():
        v = r.normal(size=s).astype(np.float32)
        v[r.uniform(size=s) < zero_frac] = 0.0
        out[k] = v
    return out


def _flat(jtree) -> dict:
    return convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jtree))


def _t(params: dict) -> dict:
    return {k: torch.tensor(v) for k, v in params.items()}


def _assert_tree_equal(got: dict, want_nested) -> None:
    want = _flat(want_nested)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_packets_and_their_helpers_match_jax():
    p = _params()
    _assert_tree_equal(tpk.full_leaf_mask(_t(p)), jpk.full_leaf_mask(_nested(p)))
    _assert_tree_equal(tpk.full_element_mask(_t(p)), jpk.full_element_mask(_nested(p)))
    packet = tpk.packet_like(_t(p))
    assert packet.aux is None and set(packet.params) == set(p)
    stacked = ptu.stack_clients([tpk.LayerMaskPacket(_t(p), tpk.full_leaf_mask(_t(p)))] * 2)
    assert stacked.leaf_mask["a/bias"].shape == (2,)
    assert stacked.params["c/kernel"].shape == (2, 2, 5)


DYNAMIC_CASES = {
    "threshold": dict(mode="threshold", threshold=0.5),
    "threshold_raw": dict(mode="threshold", threshold=1.0, normalized=False),
    "topk": dict(mode="topk", exchange_fraction=0.4),
    "topk_third": dict(mode="topk", exchange_fraction=1 / 3),
}


@pytest.mark.parametrize("case", sorted(DYNAMIC_CASES))
def test_dynamic_layer_exchanger_matches_jax(case):
    kw = DYNAMIC_CASES[case]
    init, local = _params(0), _params(1)
    j, t = jex.DynamicLayerExchanger(**kw), tex.DynamicLayerExchanger(**kw)
    jp = j.push(_nested(local), _nested(init))
    tp = t.push(_t(local), _t(init))
    _assert_tree_equal(tp.params, jp.params)
    _assert_tree_equal(tp.leaf_mask, jp.leaf_mask)
    # the pull replaces the leaves the payload marks, keeps the others
    other = _params(2)
    payload_j = jpk.LayerMaskPacket(params=_nested(other), leaf_mask=jp.leaf_mask)
    payload_t = tpk.LayerMaskPacket(params=_t(other), leaf_mask=tp.leaf_mask)
    _assert_tree_equal(t.pull(payload_t, _t(local)), j.pull(payload_j, _nested(local)))
    _assert_tree_equal(t.pull(_t(other), _t(local)), j.pull(_nested(other), _nested(local)))


def test_dynamic_layer_top_k_ties_keep_jaxs_lower_leaf():
    """Every leaf drifts by the same normalised norm: the stable sort keeps
    the first leaves in JAX's flatten order."""
    init = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    local = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}
    kw = dict(mode="topk", exchange_fraction=0.4)
    jp = jex.DynamicLayerExchanger(**kw).push(_nested(local), _nested(init))
    tp = tex.DynamicLayerExchanger(**kw).push(_t(local), _t(init))
    _assert_tree_equal(tp.leaf_mask, jp.leaf_mask)
    sent = [k for k in ptu.flax_leaf_order(tp.leaf_mask) if float(tp.leaf_mask[k]) == 1.0]
    assert sent == ptu.flax_leaf_order(tp.leaf_mask)[:2]


@pytest.mark.parametrize("zero_frac,level", [(0.0, 0.3), (0.7, 0.5), (0.95, 0.4)])
def test_sparse_exchanger_matches_jax_with_ties(zero_frac, level):
    """Mostly-zero weights tie at |w| = 0: ``lax.top_k``'s lower-index
    choice over JAX's flat order, never more than k elements."""
    local = _params(3, zero_frac)
    j, t = jex.SparseExchanger(sparsity_level=level), tex.SparseExchanger(sparsity_level=level)
    jp = j.push(_nested(local), None)
    tp = t.push(_t(local), None)
    _assert_tree_equal(tp.params, jp.params)
    _assert_tree_equal(tp.element_mask, jp.element_mask)
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    assert sum(float(m.sum()) for m in tp.element_mask.values()) == max(1, round(level * n))
    other = _params(4)
    _assert_tree_equal(
        t.pull(tpk.SparseMaskPacket(_t(other), tp.element_mask), _t(local)),
        j.pull(jpk.SparseMaskPacket(_nested(other), jp.element_mask), _nested(local)))


def test_sparse_exchanger_with_a_drift_score_matches_jax():
    init, local = _params(5), _params(6)

    def jscore(p, i):
        return jax.tree_util.tree_map(lambda a, b: jnp.abs(a - b), p, i)

    def tscore(p, i):
        return {k: (p[k] - i[k]).abs() for k in p}

    jp = jex.SparseExchanger(0.25, jscore).push(_nested(local), _nested(init))
    tp = tex.SparseExchanger(0.25, tscore).push(_t(local), _t(init))
    _assert_tree_equal(tp.element_mask, jp.element_mask)
    with pytest.raises(ValueError, match="initial_params"):
        tex.SparseExchanger(0.25, tscore).push(_t(local), None)


def test_ravel_follows_jaxs_flatten_order():
    p = _params(7)
    flat, unravel = ptu.ravel(_t(p))
    want, _ = jax.flatten_util.ravel_pytree(_nested(p))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unravel(flat)
    assert list(back) == list(p)
    for k in p:
        np.testing.assert_array_equal(back[k].numpy(), p[k])


def _results(pk_j, pk_t, counts, mask):
    return (JFitResults(pk_j, jnp.asarray(counts), {}, {}, jnp.asarray(mask)),
            TFitResults(pk_t, torch.tensor(counts), {}, {}, torch.tensor(mask)))


@pytest.mark.parametrize("weighted", [True, False])
def test_masked_average_strategies_match_jax(weighted):
    r = np.random.default_rng(8)
    clients = [_params(10 + i) for i in range(3)]
    counts = np.asarray([10.0, 20.0, 30.0], np.float32)
    mask = np.asarray([1.0, 1.0, 0.0], np.float32)
    stack_j = lambda trees: jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    # layer masks: client 0 sends a/*, client 1 a/kernel and c, client 2
    # (dropped) everything; b/* nobody live sends
    sends = [{"a/kernel", "a/bias"}, {"a/kernel", "c/kernel"}, set(SHAPES)]
    leaf = [{k: np.float32(k in s) for k in SHAPES} for s in sends]
    jpk_l = jpk.LayerMaskPacket(stack_j([_nested(c) for c in clients]),
                                stack_j([_nested(m) for m in leaf]))
    tpk_l = tpk.LayerMaskPacket(ptu.stack_clients([_t(c) for c in clients]),
                                ptu.stack_clients([_t(m) for m in leaf]))
    prev = _params(20)
    jst = jdl.FedAvgDynamicLayer(weighted).init(_nested(prev))
    tst = tdl.FedAvgDynamicLayer(weighted).init(_t(prev))
    jr, tr = _results(jpk_l, tpk_l, counts, mask)
    jnew = jdl.FedAvgDynamicLayer(weighted).aggregate(jst, jr, 1)
    tnew = tdl.FedAvgDynamicLayer(weighted).aggregate(tst, tr, 1)
    want = _flat(jnew.params)
    for k, v in want.items():
        np.testing.assert_allclose(tnew.params[k].numpy(), v.numpy(), rtol=0, atol=FN_TOL)
    _assert_tree_equal(tnew.updated, jnew.updated)
    assert float(tnew.updated["b/bias"]) == 0.0
    np.testing.assert_array_equal(tnew.params["b/bias"].numpy(), prev["b/bias"])
    # element masks
    elem = [{k: (r.uniform(size=s) < 0.5).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(3)]
    jpk_s = jpk.SparseMaskPacket(stack_j([_nested(c) for c in clients]),
                                 stack_j([_nested(m) for m in elem]))
    tpk_s = tpk.SparseMaskPacket(ptu.stack_clients([_t(c) for c in clients]),
                                 ptu.stack_clients([_t(m) for m in elem]))
    jst = jdl.FedAvgSparse(weighted).init(_nested(prev))
    tst = tdl.FedAvgSparse(weighted).init(_t(prev))
    jr, tr = _results(jpk_s, tpk_s, counts, mask)
    jnew = jdl.FedAvgSparse(weighted).aggregate(jst, jr, 1)
    tnew = tdl.FedAvgSparse(weighted).aggregate(tst, tr, 1)
    for k, v in _flat(jnew.params).items():
        np.testing.assert_allclose(tnew.params[k].numpy(), v.numpy(), rtol=0, atol=FN_TOL)
    _assert_tree_equal(tnew.updated, jnew.updated)


def _arrays(n_clients=3, n=48):
    out = []
    for i in range(n_clients):
        x, y = synthetic_classification(jax.random.PRNGKey(i), n, (8,), 3)
        x, y = np.asarray(x), np.asarray(y)
        out.append((x[: n - 16], y[: n - 16], x[n - 16:], y[n - 16:]))
    return out


RUNS = {
    "dynamic_topk": (lambda m: m.DynamicLayerExchanger(mode="topk", exchange_fraction=0.5),
                     "FedAvgDynamicLayer"),
    "dynamic_threshold": (lambda m: m.DynamicLayerExchanger(mode="threshold", threshold=0.02),
                          "FedAvgDynamicLayer"),
    "sparse": (lambda m: m.SparseExchanger(sparsity_level=0.3), "FedAvgSparse"),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_partial_exchange_runs_match_jax(case):
    make_ex, strategy = RUNS[case]
    arrays = _arrays()
    common = dict(batch_size=8, seed=42, local_epochs=1)
    js = JSim(logic=jengine.ClientLogic(jengine.from_flax(JMlp(features=(16,), n_outputs=3)),
                                        jengine.masked_cross_entropy),
              tx=optax.sgd(0.05), strategy=getattr(jdl, strategy)(),
              datasets=[JDataset(*a) for a in arrays],
              metrics=JMetricManager((jefficient.accuracy(),)), exchanger=make_ex(jex), **common)
    init = _flat(js.global_params)
    js.fit(3)
    ports = []
    for mode in ("pipelined", "chunked"):
        ts = TSim(logic=tengine.ClientLogic(tengine.from_module(TMlp(8, (16,), 3)),
                                            tengine.masked_cross_entropy),
                  tx=optim.sgd(0.05), strategy=getattr(tdl, strategy)(),
                  datasets=[TDataset(*a) for a in arrays],
                  metrics=TMetricManager((tefficient.accuracy(),)), exchanger=make_ex(tex),
                  execution_mode=mode, device="cpu", **common)
        ts.set_global_params(init)
        ts.fit(3)
        ports.append(ts)
    ts, chunked = ports
    for j, t, c in zip(js.history, ts.history, chunked.history, strict=True):
        for k in j.fit_losses:
            np.testing.assert_allclose(t.fit_losses[k], j.fit_losses[k], rtol=0, atol=TOL)
        np.testing.assert_allclose(t.eval_losses["checkpoint"], j.eval_losses["checkpoint"],
                                   rtol=0, atol=TOL)
        assert (t.fit_losses, t.eval_losses) == (c.fit_losses, c.eval_losses)
    for k, v in _flat(js.global_params).items():
        np.testing.assert_allclose(ts.global_params[k].numpy(), v.numpy(), rtol=0, atol=TOL)
    for k, v in _flat(js.server_state.updated).items():
        np.testing.assert_array_equal(ts.server_state.updated[k].numpy(), v.numpy())
    # the clients kept their local values where nothing was refreshed
    for k, v in _flat(js.client_states.params).items():
        np.testing.assert_allclose(ts.client_states.params[k].numpy(), v.numpy(), rtol=0,
                                   atol=TOL)
