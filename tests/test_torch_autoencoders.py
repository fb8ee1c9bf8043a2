"""The autoencoders, the VAE loss, PCA and FedPCA in the port
(``models/autoencoders.py``, ``strategies/fedpca.py``) against the JAX
package on the CPU.

- ``BasicAe``, ``VariationalAe`` and ``ConditionalVae`` from converted
  flax params: the forward on a train call with a key (the ``"sampling"``
  stream: ``fold_in(rng, 2)``, the root scope's ``make_rng``), on an eval
  call (``PRNGKey(0)``) and without a key, at 1e-5 (``rng.normal`` is
  within 2 ulp of JAX's); ``make_vae_loss`` and its parts at 1e-5;
- ``examples/ae_examples/fedprox_vae_example``'s run (FedProx over a VAE,
  Adam) from JAX's converted init at 5e-4, chunked bit for bit the
  pipelined run;
- ``PcaModule``: singular values, each component after aligning its
  column's sign, projections, reconstruction errors and variances at 5e-4;
  ``FedPCA``'s merge of the clients' subspaces likewise (LAPACK, XLA and
  cuSOLVER may each flip a singular vector: a sign is not a fault, a
  subspace is)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from torch import nn as tnn
import torch.nn.functional as F

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.fedprox import FedProxClientLogic as JFedProx
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models import autoencoders as J
from fl4health_tpu.server.simulation import ClientDataset as JDataset
from fl4health_tpu.server.simulation import FederatedSimulation as JSim
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu.strategies.fedpca import FedPCA as JFedPCA
from fl4health_tpu.strategies.fedpca import PcaPacket as JPcaPacket
from fl4health_tpu.strategies.fedprox import FedAvgWithAdaptiveConstraint as JAdaptive
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.fedprox import FedProxClientLogic as TFedProx
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import autoencoders as T
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.transformer import LoraDense
from fl4health_tpu_torch.server.simulation import ClientDataset as TDataset
from fl4health_tpu_torch.server.simulation import FederatedSimulation as TSim
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults
from fl4health_tpu_torch.strategies.fedpca import FedPCA as TFedPCA
from fl4health_tpu_torch.strategies.fedpca import PcaPacket as TPcaPacket
from fl4health_tpu_torch.strategies.fedprox import FedAvgWithAdaptiveConstraint as TAdaptive

TOL = 5e-4
FN_TOL = 1e-5
LATENT, D_IN, HID = 4, 6, 16


# -- the JAX test's encoders and decoders, in both packages (each Dense
# built before the next, so flax numbers them in order) ----------------------

class JEnc(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        h = nn.relu(nn.Dense(HID)(x.reshape((x.shape[0], -1))))
        return nn.Dense(LATENT)(h)


class JVEnc(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        h = nn.relu(nn.Dense(HID)(x.reshape((x.shape[0], -1))))
        return nn.Dense(LATENT)(h), nn.Dense(LATENT)(h)


class JCEnc(nn.Module):
    @nn.compact
    def __call__(self, x, cond, train=True):
        h = nn.relu(nn.Dense(HID)(jnp.concatenate([x.reshape((x.shape[0], -1)), cond], 1)))
        return nn.Dense(LATENT)(h), nn.Dense(LATENT)(h)


class JDec(nn.Module):
    out: int = D_IN

    @nn.compact
    def __call__(self, z, train=True):
        h = nn.relu(nn.Dense(HID)(z))
        return nn.Dense(self.out)(h)


class JCDec(nn.Module):
    @nn.compact
    def __call__(self, z, cond, train=True):
        h = nn.relu(nn.Dense(HID)(jnp.concatenate([z, cond], 1)))
        return nn.Dense(D_IN)(h)


class _Dense(tnn.Module):
    """Dense layers named as flax names them, ``Dense_0`` ..."""

    def __init__(self, *widths):
        super().__init__()
        for i, (a, b) in enumerate(widths):
            setattr(self, f"Dense_{i}", LoraDense(a, b, dtype=None))


class TEnc(_Dense):
    def __init__(self, d_in=D_IN, cond=0):
        super().__init__((d_in + cond, HID), (HID, LATENT))

    def forward(self, x, train=True):
        return self.Dense_1(F.relu(self.Dense_0(x.reshape(x.shape[0], -1))))


class TVEnc(_Dense):
    def __init__(self, d_in=D_IN, cond=0):
        super().__init__((d_in + cond, HID), (HID, LATENT), (HID, LATENT))

    def forward(self, x, cond=None, train=True):
        x = x.reshape(x.shape[0], -1)
        h = F.relu(self.Dense_0(x if cond is None else torch.cat([x, cond], 1)))
        return self.Dense_1(h), self.Dense_2(h)


class TDec(_Dense):
    def __init__(self, out=D_IN, cond=0):
        super().__init__((LATENT + cond, HID), (HID, out))

    def forward(self, z, cond=None, train=True):
        z = z if cond is None else torch.cat([z, cond], 1)
        return self.Dense_1(F.relu(self.Dense_0(z)))


def _unpack(x):
    return x[:, :D_IN], x[:, D_IN:]


def _models(kind):
    if kind == "basic":
        return J.BasicAe(encoder=JEnc(), decoder=JDec()), T.BasicAe(TEnc(), TDec())
    if kind == "vae":
        return J.VariationalAe(encoder=JVEnc(), decoder=JDec()), T.VariationalAe(TVEnc(), TDec())
    return (J.ConditionalVae(encoder=JCEnc(), decoder=JCDec(), unpack_input_condition=_unpack),
            T.ConditionalVae(TVEnc(cond=3), TDec(cond=3), unpack_input_condition=_unpack))


def _inputs(kind, n=5):
    x = np.random.default_rng(0).normal(size=(n, D_IN)).astype(np.float32)
    if kind == "cvae":
        x = np.concatenate([x, np.eye(3, dtype=np.float32)[np.arange(n) % 3]], 1)
    return x


@pytest.mark.parametrize("kind", ["basic", "vae", "cvae"])
def test_autoencoders_match_flax_from_converted_params(kind):
    jm, tm = _models(kind)
    x = _inputs(kind)
    params = jm.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
                     jnp.asarray(x))["params"]
    jdef, tdef = jengine.from_flax(jm), tengine.from_module(tm)
    tp = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    assert set(tp) == {k.replace(".", "/") for k, _ in tm.named_parameters()}
    key = jax.random.PRNGKey(3)
    for train, with_key in ((True, True), (False, True), (True, False)):
        kw_j = dict(rng=key) if with_key else {}
        kw_t = dict(rng=torch.tensor(np.asarray(key).astype(np.int64))) if with_key else {}
        (jp, jf), _ = jdef.apply(params, {}, jnp.asarray(x), train=train, **kw_j)
        if tdef.takes_rng:
            (tp_, tf), _ = tdef.apply(tp, {}, torch.tensor(x), train=train, **kw_t)
        else:
            (tp_, tf), _ = tdef.apply(tp, {}, torch.tensor(x), train=train)
        np.testing.assert_allclose(tp_["prediction"].detach().numpy(),
                                   np.asarray(jp["prediction"]), rtol=0, atol=FN_TOL)
        assert set(tf) == set(jf)
        for k in jf:
            np.testing.assert_allclose(tf[k].detach().numpy(), np.asarray(jf[k]), rtol=0,
                                       atol=FN_TOL)
    assert tdef.takes_rng == (kind != "basic")


def test_reparameterize_and_the_vae_loss_match_jax():
    r = np.random.default_rng(1)
    mu, logvar = (r.normal(size=(5, LATENT)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(9)
    want = np.asarray(J.reparameterize(jnp.asarray(mu), jnp.asarray(logvar), key))
    got = T.reparameterize(torch.tensor(mu), torch.tensor(logvar),
                           torch.tensor(np.asarray(key).astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FN_TOL)
    packed = r.normal(size=(5, 2 * LATENT + D_IN)).astype(np.float32)
    target = r.normal(size=(5, D_IN)).astype(np.float32)
    mask = np.asarray([1, 1, 0, 1, 1], np.float32)
    for jo, to in zip(J.unpack_vae_output(jnp.asarray(packed), LATENT),
                      T.unpack_vae_output(torch.tensor(packed), LATENT)):
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    for m in (None, mask):
        want = float(J.kl_to_standard_normal(jnp.asarray(mu), jnp.asarray(logvar),
                                             None if m is None else jnp.asarray(m)))
        got = float(T.kl_to_standard_normal(torch.tensor(mu), torch.tensor(logvar),
                                            None if m is None else torch.tensor(m)))
        assert got == pytest.approx(want, rel=1e-6, abs=FN_TOL)
    want = float(J.make_vae_loss(LATENT, jengine.masked_mse)(
        jnp.asarray(packed), jnp.asarray(target), jnp.asarray(mask)))
    got = float(T.make_vae_loss(LATENT, tengine.masked_mse)(
        torch.tensor(packed), torch.tensor(target), torch.tensor(mask)))
    assert got == pytest.approx(want, rel=1e-6, abs=FN_TOL)


def test_fedprox_vae_run_matches_jax():
    """``fedprox_vae_example``'s recipe: 3 clients reconstructing their 6
    features through a VAE of latent 4, FedProx (mu 0.1), Adam 0.01, batch
    8, 2 local epochs, seed 11, 3 rounds."""
    r = np.random.default_rng(2)
    arrays = []
    for _ in range(3):
        x = r.normal(size=(40, D_IN)).astype(np.float32)
        arrays.append((x[:32], x[:32], x[32:], x[32:]))
    common = dict(batch_size=8, seed=11, local_epochs=2, extra_loss_keys=("vanilla", "penalty"))
    jm, _ = _models("vae")
    js = JSim(logic=JFedProx(jengine.from_flax(jm), J.make_vae_loss(LATENT, jengine.masked_mse)),
              tx=optax.adam(0.01), strategy=JAdaptive(initial_drift_penalty_weight=0.1),
              datasets=[JDataset(*a) for a in arrays], metrics=JMetricManager(()), **common)
    init = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    js.fit(3)
    ports = []
    for mode in ("pipelined", "chunked"):
        _, tm = _models("vae")
        ts = TSim(logic=TFedProx(tengine.from_module(tm),
                                 T.make_vae_loss(LATENT, tengine.masked_mse)),
                  tx=optim.adam(0.01), strategy=TAdaptive(initial_drift_penalty_weight=0.1),
                  datasets=[TDataset(*a) for a in arrays], metrics=TMetricManager(()),
                  execution_mode=mode, device="cpu", **common)
        ts.set_global_params(init)
        ts.fit(3)
        ports.append(ts)
    ts, chunked = ports
    for j, t, c in zip(js.history, ts.history, chunked.history, strict=True):
        assert set(t.fit_losses) == set(j.fit_losses)
        for k in j.fit_losses:
            np.testing.assert_allclose(t.fit_losses[k], j.fit_losses[k], rtol=0, atol=TOL,
                                       err_msg=f"round {j.round} {k}")
        np.testing.assert_allclose(t.eval_losses["checkpoint"], j.eval_losses["checkpoint"],
                                   rtol=0, atol=TOL)
        assert (t.fit_losses, t.eval_losses) == (c.fit_losses, c.eval_losses)
    for k, v in convert.flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                             js.global_params)).items():
        np.testing.assert_allclose(ts.global_params[k].numpy(), v.numpy(), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# PCA and FedPCA
# ---------------------------------------------------------------------------

def align_signs(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """``got``'s columns each flipped to point along ``want``'s."""
    signs = np.sign(np.sum(got * want, axis=0))
    signs[signs == 0] = 1.0
    return got * signs


def _data(n=40, d=12, seed=0):
    r = np.random.default_rng(seed)
    # a few dominant directions, so the leading subspace is well separated
    basis = r.normal(size=(4, d)) * np.asarray([5.0, 3.0, 2.0, 1.5])[:, None]
    return (r.normal(size=(n, 4)) @ basis + 0.3 * r.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("config", [dict(), dict(low_rank=True, rank_estimation=5),
                                    dict(full_svd=True)])
def test_pca_module_matches_jax_up_to_signs(config):
    x = _data()
    jpca, tpca = J.PcaModule(**config), T.PcaModule(**config)
    for center in (True, False):
        js = jpca.fit(jnp.asarray(x), center_data=center)
        ts = tpca.fit(torch.tensor(x), center_data=center)
        assert tuple(ts.components.shape) == js.components.shape
        np.testing.assert_allclose(ts.singular_values.numpy(), np.asarray(js.singular_values),
                                   rtol=0, atol=TOL)
        k = min(5, ts.components.shape[1])
        want_u = np.asarray(js.components)[:, :k]
        got_u = align_signs(ts.components.numpy()[:, :k], want_u)
        np.testing.assert_allclose(got_u, want_u, rtol=0, atol=TOL)
        np.testing.assert_allclose(ts.data_mean.numpy(), np.asarray(js.data_mean), atol=1e-6)
        tx = torch.tensor(x)
        for kk in (2, k, None):
            for c in (True, False):
                for name in ("reconstruction_error", "projection_variance"):
                    want = float(getattr(jpca, name)(js, jnp.asarray(x), kk, c))
                    got = float(getattr(tpca, name)(ts, tx, kk, c))
                    assert got == pytest.approx(want, rel=1e-4, abs=TOL), (name, kk, c)
        low_j = np.asarray(jpca.project_lower_dim(js, jnp.asarray(x), k, True))
        low_t = tpca.project_lower_dim(ts, tx, k, True).numpy()
        signs = np.sign(np.sum(ts.components.numpy()[:, :k] * want_u, axis=0))
        np.testing.assert_allclose(low_t * signs, low_j, rtol=0, atol=TOL * 10)
        back_t = tpca.project_back(ts, torch.tensor(low_t), add_mean=True).numpy()
        back_j = np.asarray(jpca.project_back(js, jnp.asarray(low_j), add_mean=True))
        np.testing.assert_allclose(back_t, back_j, rtol=0, atol=TOL * 10)
        for name in ("explained_variance_ratios", "cumulative_explained_variance"):
            np.testing.assert_allclose(getattr(T.PcaModule, name)(ts).numpy(),
                                       np.asarray(getattr(J.PcaModule, name)(js)),
                                       rtol=1e-5, atol=TOL)


def test_fedpca_merge_matches_jax_up_to_signs():
    """``fedpca_example``'s flow: each client's top-k axes by a low-rank
    PCA, FedPCA's merge over a mask with a dropped client."""
    k = 3
    clients = [_data(30, 12, seed=i) for i in range(4)]
    jpca, tpca = J.PcaModule(low_rank=True, rank_estimation=k), T.PcaModule(
        low_rank=True, rank_estimation=k)
    jstates = [jpca.fit(jnp.asarray(c)) for c in clients]
    tstates = [tpca.fit(torch.tensor(c)) for c in clients]
    mask = np.asarray([1, 1, 0, 1], np.float32)
    counts = np.asarray([30.0] * 4, np.float32)
    jst = JFedPCA(k).init({"components": jstates[0].components,
                           "singular_values": jstates[0].singular_values})
    tst = TFedPCA(k).init({"components": tstates[0].components,
                           "singular_values": tstates[0].singular_values})
    want = JFedPCA(k).aggregate(jst, JFitResults(
        JPcaPacket(jnp.stack([s.components for s in jstates]),
                   jnp.stack([s.singular_values for s in jstates])),
        jnp.asarray(counts), {}, {}, jnp.asarray(mask)), 1)
    # the port merges its own local SVDs: every client's signs may differ
    got = TFedPCA(k).aggregate(tst, TFitResults(
        TPcaPacket(torch.stack([s.components for s in tstates]),
                   torch.stack([s.singular_values for s in tstates])),
        torch.tensor(counts), {}, {}, torch.tensor(mask)), 1)
    np.testing.assert_allclose(got.singular_values.numpy(), np.asarray(want.singular_values),
                               rtol=0, atol=TOL)
    want_u = np.asarray(want.components)
    np.testing.assert_allclose(align_signs(got.components.numpy(), want_u), want_u, rtol=0,
                               atol=TOL)
    merged = TFedPCA(k).global_params(got)
    assert set(merged) == {"components", "singular_values"}
    # the merged subspace explains the pooled data as JAX's does
    pooled = np.concatenate([c for c, m in zip(clients, mask) if m])
    pooled = pooled - pooled.mean(0)
    ratio = lambda u: float(((pooled @ u) ** 2).sum() / (pooled ** 2).sum())  # noqa: E731
    assert ratio(got.components.numpy()) == pytest.approx(ratio(want_u), abs=TOL)
