"""Shared recipes of the port's split-model personalisation tests: JAX's
fixture (``tests/clients/test_personalization.py``: 3 clients of 32 train
and 16 val rows from ``synthetic_classification(PRNGKey(i), 48, (8,), 3)``,
batch 8, one local epoch, SGD 0.05, seed 3) for every logic of the family,
built in both packages on the same numpy data, the port from the JAX run's
converted init. FedSimCLR's second view is the first plus 0.05 of a
normal draw from ``PRNGKey(100 + i)`` (JAX's ``test_fedpm_simclr.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients import apfl as japfl
from fl4health_tpu.clients import ensemble as jensemble
from fl4health_tpu.clients import fedrep as jfedrep
from fl4health_tpu.clients import fedsimclr as jsimclr
from fl4health_tpu.clients import fenda as jfenda
from fl4health_tpu.clients import gpfl as jgpfl
from fl4health_tpu.datasets.synthetic import synthetic_classification
from fl4health_tpu.exchange.exchanger import FixedLayerExchanger as JFixedLayer
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import bases as jbases
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server.simulation import ClientDataset as JDataset
from fl4health_tpu.server.simulation import FederatedSimulation as JSim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch import rng as trng
from fl4health_tpu_torch.clients import apfl as tapfl
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients import ensemble as tensemble
from fl4health_tpu_torch.clients import fedrep as tfedrep
from fl4health_tpu_torch.clients import fedsimclr as tsimclr
from fl4health_tpu_torch.clients import fenda as tfenda
from fl4health_tpu_torch.clients import gpfl as tgpfl
from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger as TFixedLayer
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import bases as tbases
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server.simulation import ClientDataset as TDataset
from fl4health_tpu_torch.server.simulation import FederatedSimulation as TSim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

TOL = 5e-4
N_CLASSES, DIM, HIDDEN, FENDA_WIDTH = 3, 8, 16, 12
GPFL_PROPS = (0.5, 0.3, 0.2)

_ARRAYS: dict = {}


def arrays(ssl: bool = False, n_clients: int = 3, n: int = 48) -> list:
    """Per client (x_train, y_train, x_val, y_val) as numpy; with ``ssl``
    the targets are the second view."""
    if (ssl, n_clients, n) not in _ARRAYS:
        out = []
        for i in range(n_clients):
            x, y = synthetic_classification(jax.random.PRNGKey(i), n, (DIM,), N_CLASSES)
            x, y = np.asarray(x), np.asarray(y)
            if ssl:
                y = x + 0.05 * np.asarray(jax.random.normal(jax.random.PRNGKey(100 + i),
                                                            x.shape))
            out.append((x[: n - 16], y[: n - 16], x[n - 16:], y[n - 16:]))
        _ARRAYS[(ssl, n_clients, n)] = out
    return _ARRAYS[(ssl, n_clients, n)]


def _jmlp():
    return JMlp(features=(HIDDEN,), n_outputs=N_CLASSES)


def _tmlp():
    return TMlp(DIM, (HIDDEN,), N_CLASSES)


def jfenda_model():
    return jbases.FendaModel(
        first_feature_extractor=jbases.DenseFeatures((FENDA_WIDTH,)),
        second_feature_extractor=jbases.DenseFeatures((FENDA_WIDTH,)),
        head_module=jbases.HeadModule(head=jbases.DenseHead(N_CLASSES)))


def tfenda_model():
    return tbases.FendaModel(tbases.DenseFeatures(DIM, (FENDA_WIDTH,)),
                             tbases.DenseFeatures(DIM, (FENDA_WIDTH,)),
                             tbases.HeadModule(tbases.DenseHead(2 * FENDA_WIDTH, N_CLASSES)))


def recipe(kind: str):
    """-> (jax logic, jax exchanger, port logic, port exchanger, ssl) of one
    logic of the family; logic keyword arguments as JAX's tests pass them
    (FedRep 2 head steps of 4, GPFL class proportions 0.5/0.3/0.2)."""
    jce, tce = jengine.masked_cross_entropy, tengine.masked_cross_entropy
    if kind == "apfl":
        kw = dict(alpha=0.5, alpha_lr=0.1)
        return (japfl.ApflClientLogic(japfl.apfl_model_def(jbases.ApflModule(
                    local_model=_jmlp(), global_model=_jmlp())), jce, **kw),
                JFixedLayer(jbases.ApflModule.exchange_global_model),
                tapfl.ApflClientLogic(tapfl.apfl_model_def(tbases.ApflModule(
                    _tmlp(), _tmlp())), tce, **kw),
                TFixedLayer(tbases.ApflModule.exchange_global_model), False)
    if kind in ("fenda", "constrained_fenda", "perfcl"):
        jcls, tcls, kw = {
            "fenda": (jfenda.FendaClientLogic, tfenda.FendaClientLogic, {}),
            "constrained_fenda": (jfenda.ConstrainedFendaClientLogic,
                                  tfenda.ConstrainedFendaClientLogic,
                                  dict(cos_sim_loss_weight=0.5, contrastive_loss_weight=0.5)),
            "perfcl": (jfenda.PerFclClientLogic, tfenda.PerFclClientLogic,
                       dict(global_feature_loss_weight=0.5, local_feature_loss_weight=0.5)),
        }[kind]
        return (jcls(jengine.from_flax(jfenda_model()), jce, **kw),
                JFixedLayer(jbases.ParallelSplitModel.exchange_global_extractor),
                tcls(tengine.from_module(tfenda_model()), tce, **kw),
                TFixedLayer(tbases.ParallelSplitModel.exchange_global_extractor), False)
    if kind == "fenda_ditto":
        return (jfenda.FendaDittoClientLogic(jengine.from_flax(jbases.TwinModel(
                    global_model=jfenda_model(), personal_model=jfenda_model())), jce, lam=1.0),
                JFixedLayer(jbases.TwinModel.exchange_global_model),
                tfenda.FendaDittoClientLogic(tengine.from_module(tbases.TwinModel(
                    tfenda_model(), tfenda_model())), tce, lam=1.0),
                TFixedLayer(tbases.TwinModel.exchange_global_model), False)
    if kind in ("fedrep", "fedper"):
        jmodel = jengine.from_flax(jbases.FedRepModel(
            features_module=jbases.DenseFeatures((HIDDEN,)),
            head_module=jbases.DenseHead(N_CLASSES)))
        tmodel = tengine.from_module(tbases.FedRepModel(tbases.DenseFeatures(DIM, (HIDDEN,)),
                                                        tbases.DenseHead(HIDDEN, N_CLASSES)))
        if kind == "fedrep":
            jlogic = jfedrep.FedRepClientLogic(jmodel, jce, head_steps=2)
            tlogic = tfedrep.FedRepClientLogic(tmodel, tce, head_steps=2)
        else:
            jlogic = jfedrep.FedPerClientLogic(jmodel, jce)
            tlogic = tfedrep.FedPerClientLogic(tmodel, tce)
        return (jlogic, JFixedLayer(jbases.SequentiallySplitModel.exchange_features_only),
                tlogic, TFixedLayer(tbases.SequentiallySplitModel.exchange_features_only),
                False)
    if kind == "gpfl":
        kw = dict(n_classes=N_CLASSES, class_proportions=GPFL_PROPS, lam=0.01, mu=0.01)
        return (jgpfl.GpflClientLogic(jgpfl.gpfl_model_def(jbases.GpflModel(
                    base_module=jbases.DenseFeatures((HIDDEN,)), n_classes=N_CLASSES,
                    feature_dim=FENDA_WIDTH)), jce, **kw),
                JFixedLayer(jbases.GpflModel.exchange_shared),
                tgpfl.GpflClientLogic(tgpfl.gpfl_model_def(tbases.GpflModel(
                    tbases.DenseFeatures(DIM, (HIDDEN,)), N_CLASSES, FENDA_WIDTH)), tce, **kw),
                TFixedLayer(tbases.GpflModel.exchange_shared), False)
    if kind == "ensemble":
        return (jensemble.EnsembleClientLogic(jengine.from_flax(jbases.EnsembleModel(
                    members=(_jmlp(), _jmlp()))), jce, n_members=2), None,
                tensemble.EnsembleClientLogic(tengine.from_module(tbases.EnsembleModel(
                    (_tmlp(), _tmlp()))), tce, n_members=2), None, False)
    if kind == "fedsimclr":
        return (jsimclr.FedSimClrClientLogic(jengine.from_flax(jbases.FedSimClrModel(
                    encoder=jbases.DenseFeatures((HIDDEN,)),
                    projection_head=jbases.DenseHead(n_outputs=DIM), pretrain=True)),
                    temperature=0.5), None,
                tsimclr.FedSimClrClientLogic(tengine.from_module(tbases.FedSimClrModel(
                    tbases.DenseFeatures(DIM, (HIDDEN,)), tbases.DenseHead(HIDDEN, DIM),
                    pretrain=True)), temperature=0.5), None, True)
    raise ValueError(kind)


KINDS = ("apfl", "fenda", "constrained_fenda", "perfcl", "fenda_ditto", "fedrep", "fedper",
         "gpfl", "ensemble", "fedsimclr")


def jsim(logic, exchanger, ssl: bool, n_clients: int = 3, **kw) -> JSim:
    kw.setdefault("local_epochs", 1)
    return JSim(logic=logic, tx=optax.sgd(0.05), strategy=kw.pop("strategy", None) or JFedAvg(),
                datasets=[JDataset(*a) for a in arrays(ssl, n_clients)], batch_size=8,
                metrics=JMetricManager(() if ssl else (jefficient.accuracy(),)),
                exchanger=exchanger, seed=3, **kw)


def tsim(logic, exchanger, ssl: bool, mode: str = "pipelined", n_clients: int = 3,
         **kw) -> TSim:
    kw.setdefault("local_epochs", 1)
    return TSim(logic=logic, tx=optim.sgd(0.05), strategy=kw.pop("strategy", None) or TFedAvg(),
                datasets=[TDataset(*a) for a in arrays(ssl, n_clients)], batch_size=8,
                metrics=TMetricManager(() if ssl else (tefficient.accuracy(),)),
                exchanger=exchanger, seed=3, execution_mode=mode, device="cpu", **kw)


def flat(jtree) -> dict:
    """A JAX tree of arrays as the port's path-keyed tensors."""
    return convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(jtree)))


def with_init(logic, params: dict):
    """``logic`` whose model initialises to ``params`` (JAX's init,
    converted): the port's clients, registry rows and ``extra`` then start
    where JAX's do."""
    logic.model = dataclasses.replace(
        logic.model, init=lambda generator: {k: v.clone() for k, v in params.items()})
    return logic


def pair(kind: str, rounds: int = 3, jax_kw=None, port_kw=None):
    """JAX's run of ``kind`` (fit ``rounds``) and the port's simulation of
    it, not yet run, from JAX's init."""
    jlogic, jexch, tlogic, texch, ssl = recipe(kind)
    js = jsim(jlogic, jexch, ssl, **(jax_kw or {}))
    init = flat(js.global_params)
    jhist = js.fit(rounds)
    ts = tsim(with_init(tlogic, init), texch, ssl, **(port_kw or {}))
    return js, jhist, ts


def close_history(jhist, thist, tol: float = TOL) -> None:
    """Every round's fit and eval losses (each key) and eval metrics
    within ``tol``."""
    assert len(jhist) == len(thist)
    for j, t in zip(jhist, thist):
        for field in ("fit_losses", "eval_losses", "eval_metrics"):
            want, got = getattr(j, field), getattr(t, field)
            assert set(got) == set(want), (field, sorted(got), sorted(want))
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                           err_msg=f"round {t.round} {field} {k}")


def close_params(want: dict, got: dict, tol: float = TOL) -> None:
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=tol,
                                   atol=tol, err_msg=k)


def client_spread(params: dict, prefix: str) -> float:
    """The largest difference over the clients of the port's leaves under
    ``prefix`` (0: every client holds the same)."""
    rows = torch.cat([v.reshape(v.shape[0], -1) for k, v in params.items()
                      if k.startswith(prefix)], 1)
    return float((rows - rows[:1]).abs().max())


def step_states(jlogic, tlogic):
    """One client's state in each package, on JAX's init (SGD 0.05, key 4):
    for driving the engines' steps and phases directly."""
    x = arrays()[0][0]
    jstate = jengine.create_train_state(jlogic, optax.sgd(0.05), jax.random.PRNGKey(4), x[:8])
    tstate = tengine.create_train_state(tlogic, optim.sgd(0.05), trng.PRNGKey(4, "cpu"),
                                        torch.Generator().manual_seed(0), torch.device("cpu"))
    params = flat(jstate.params)
    return jstate, dataclasses.replace(tstate, params=params, extra=tlogic.init_extra(params))


def batch_stack(pkg: str, masks) -> object:
    """Client 0's train rows as a ``[steps, 8, ...]`` stack of the engine's
    ``Batch`` (step s takes rows 8 (s mod 4) on), ``step_mask`` ``masks``;
    ``pkg`` "jax" or "port"."""
    x, y = arrays()[0][:2]
    rows = [slice(8 * (s % 4), 8 * (s % 4) + 8) for s in range(len(masks))]
    a = dict(x=np.stack([x[r] for r in rows]), y=np.stack([y[r] for r in rows]),
             example_mask=np.ones((len(masks), 8), np.float32),
             step_mask=np.asarray(masks, np.float32))
    if pkg == "jax":
        return jengine.Batch(**{k: jnp.asarray(v) for k, v in a.items()})
    return tengine.Batch(**{k: torch.tensor(v) for k, v in a.items()})
