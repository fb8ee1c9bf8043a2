"""The transformer_long model at full width (vocab 8192, d_model 512,
8 heads, 4 layers, d_ff 2048; T cut from 2048 to 256 so the CPU run takes
minutes) through 2 FedAvg rounds of 2 clients x 5 SGD(0.05) steps of 32 in
both packages from the same converted init and data: per-round losses and
final params within 5e-4. The JAX side uses its dense attention core (Pallas
interpret mode at this size would take hours), the port its flash path,
whose CPU version is the plain dense one. Slow: run with -m slow."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.transformer import TransformerClassifier as JTransformer
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.datasets.synthetic import synthetic_text_classification
from fl4health_tpu_torch.kernels.flash_attention import flash_attention
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.transformer import TransformerClassifier as TTransformer
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

T = 256
CFG = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
           d_ff=2048, max_len=T, remat=True)


@pytest.mark.slow
def test_full_width_fedavg_matches_jax():
    data = []
    for i in range(2):
        x, y = synthetic_text_classification(rng.PRNGKey(i), 176, 8192, T, 4)
        x, y = x.numpy(), y.numpy()
        data.append((x[:160], y[:160], x[160:], y[160:]))
    js = jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JTransformer(**CFG)),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.05), strategy=JFedAvg(),
        datasets=[jsim.ClientDataset(*d) for d in data], batch_size=32,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=5, seed=0,
        execution_mode="pipelined")
    ts = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(
            tengine.from_module(TTransformer(**CFG, attention_fn=flash_attention)),
            tengine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=TFedAvg(),
        datasets=[tsim.ClientDataset(*d) for d in data], batch_size=32,
        metrics=TMetricManager((tefficient.accuracy(),)), local_steps=5, seed=0,
        device="cpu")
    ts.set_global_params(convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, js.global_params)))
    for jr, tr in zip(js.fit(2), ts.fit(2)):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=5e-4, rtol=0)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=5e-4, rtol=0)
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k, v in ts.global_params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=5e-4, rtol=0,
                                   err_msg=k)
