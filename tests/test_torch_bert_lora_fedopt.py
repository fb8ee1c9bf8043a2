"""BASELINE config 3's path in the port (LoRA fine-tuning of the
transformer under FedOpt: ``utils/peft.py``, ``masked_optimizer``,
``lora_exchanger``, ``FedOpt(adam)``) against the JAX package on the CPU:
the ``bert_lora_fedopt`` smoke config against JAX and its golden,
``examples/bert_finetuning_example`` and ``examples/long_context_example``
(JAX's Pallas kernel in interpret mode, the port's plain attention), and
the reference's defect of partial exchange under FedOpt, pinned in both
packages.

Tolerances: 5e-4 for runs against JAX (f32, the reference's), 1e-6 for the
frozen leaves' one-round move."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import functools
import importlib
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.datasets.synthetic import synthetic_text_classification as jtext
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.transformer import TransformerClassifier as JTransformer
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu.strategies.fedopt import FedOpt as JFedOpt
from fl4health_tpu.utils import peft as jpeft
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.kernels.flash_attention import flash_attention
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.transformer import TransformerClassifier as TTransformer
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from fl4health_tpu_torch.strategies.fedopt import FedOpt as TFedOpt
from fl4health_tpu_torch.utils import peft as tpeft

sys.path.insert(0, str(Path(__file__).parent / "smoke"))
import harness  # noqa: E402

jfa = importlib.import_module("fl4health_tpu.kernels.flash_attention")

TOL = 5e-4
FN_TOL = 1e-6


def _flat(tree) -> dict:
    return convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, tree))


def _port_sim(js, module, tx, strategy, exchanger=None, **kw):
    """The port's simulation over the JAX sim's data, from its initial
    params."""
    ts = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(tengine.from_module(module), tengine.masked_cross_entropy),
        tx=tx, strategy=strategy,
        datasets=[tsim.ClientDataset(np.asarray(d.x_train), np.asarray(d.y_train),
                                     np.asarray(d.x_val), np.asarray(d.y_val))
                  for d in js.datasets],
        metrics=TMetricManager((tefficient.accuracy(),)), exchanger=exchanger,
        device="cpu", **kw)
    ts.set_global_params(_flat(js.global_params))
    return ts


def _lora_tx(lr, params):
    return tpeft.masked_optimizer(optim.adam(lr), tpeft.lora_trainable_mask(params))


def _compare(thist, jhist, tol=TOL):
    for tr, jr in zip(thist, jhist, strict=True):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   atol=tol, rtol=0, err_msg=f"fit round {tr.round}")
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], atol=tol, rtol=0,
                                   err_msg=f"eval round {tr.round}")
        np.testing.assert_allclose(tr.eval_metrics["accuracy"],
                                   jr.eval_metrics["accuracy"], atol=1e-6)


def _bert_lora_fedopt_port(js):
    module = TTransformer(vocab_size=96, n_classes=4, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, max_len=12, lora_rank=4, remat=True)
    init = _flat(js.global_params)
    return _port_sim(js, module, _lora_tx(5e-3, init), TFedOpt(optim.adam(0.01)),
                     tpeft.lora_exchanger(), batch_size=12, local_steps=6, seed=11)


def test_bert_lora_fedopt_matches_jax_and_its_golden():
    js = harness.bert_lora_fedopt()
    ts = _bert_lora_fedopt_port(js)
    init = {k: v.clone() for k, v in ts.global_params.items()}
    jhist, thist = js.fit(harness.N_ROUNDS), ts.fit(harness.N_ROUNDS)
    _compare(thist, jhist)
    got, want = ts.global_params, _flat(js.global_params)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=TOL, rtol=0,
                                   err_msg=k)
    rounds = [{"eval_accuracy": round(h.eval_metrics["accuracy"], 6),
               "eval_loss": round(h.eval_losses["checkpoint"], 6),
               "fit_loss": round(h.fit_losses["backward"], 6)} for h in thist]
    errors = harness.compare_to_golden("bert_lora_fedopt", rounds)
    assert not errors, "\n".join(errors)
    # the clients' frozen leaves never move: each holds the initial value
    mask = tpeft.lora_trainable_mask(init)
    for k, trainable in mask.items():
        stack = ts.client_states.params[k]
        if not trainable:
            assert torch.equal(stack, init[k].expand_as(stack)), k
    # the clients' masked Adam state carried over the 5 rounds: 6 steps each
    adam = ts.client_states.opt_state.inner_states["train"].inner_state[0]
    assert adam.count.tolist() == [6 * harness.N_ROUNDS] * len(js.datasets)
    assert set(adam.mu) == {k for k, t in mask.items() if t}


def test_frozen_leaves_drift_on_the_server_in_both_packages():
    """Reference defect, pinned: ``FixedLayerExchanger.push`` sends zeros for
    the leaves it does not exchange, and FedOpt takes ``params - 0`` as
    their pseudo-gradient, so one round moves every frozen leaf of the
    server's model by about the server lr (Adam's first step is lr times
    the sign). The clients never read those leaves. JAX and the port move
    them by the same amount; when the defect is fixed in both packages,
    this test flips."""
    js = harness.bert_lora_fedopt()
    ts = _bert_lora_fedopt_port(js)
    init = {k: v.clone() for k, v in ts.global_params.items()}
    js.fit(1)
    ts.fit(1)
    jmoved = {k: v - init[k] for k, v in _flat(js.global_params).items()}
    tmoved = {k: v - init[k] for k, v in ts.global_params.items()}
    mask = tpeft.lora_trainable_mask(init)
    frozen = [k for k, t in mask.items() if not t]
    for k in frozen:
        np.testing.assert_allclose(tmoved[k].numpy(), jmoved[k].numpy(), atol=FN_TOL,
                                   rtol=0, err_msg=k)
    # the layer norm scales start at 1 and end at 0.99: moved by 0.00999993
    scale = tmoved["ln_final/scale"]
    np.testing.assert_allclose(scale.numpy(), -0.00999993, atol=FN_TOL)
    for k in frozen:  # every non-zero element took a step; the zero biases none
        nonzero = init[k] != 0
        assert bool((tmoved[k][nonzero].abs() > 0.009).all()), k
        assert bool((tmoved[k][~nonzero] == 0).all()), k
    assert sum(int((init[k] != 0).sum()) for k in frozen) > 0
    # the clients' copies of the frozen leaves are the initial values still
    for k in frozen:
        stack = ts.client_states.params[k]
        assert torch.equal(stack, init[k].expand_as(stack)), k


def test_bert_finetuning_example_matches_jax():
    """examples/bert_finetuning_example/config.yaml, 2 rounds: 4 clients of
    32 train / 16 val rows (vocab 128, T 16, 4 classes, class_sep 3), batch
    8, 8 local steps, client masked adam(0.01), server adam(0.01), LoRA rank
    4, d_model 32, 2 heads, 2 layers, d_ff 64, seed 3."""
    jmodule = JTransformer(vocab_size=128, n_classes=4, d_model=32, n_heads=2, n_layers=2,
                           d_ff=64, max_len=16, lora_rank=4)
    jmodel = jengine.from_flax(jmodule)
    datasets = []
    for i in range(4):
        x, y = jtext(jax.random.PRNGKey(10 + i), 48, 128, 16, 4, class_sep=3.0)
        datasets.append(jsim.ClientDataset(x[:32], y[:32], x[32:], y[32:]))
    init_params = jmodel.init(jax.random.PRNGKey(0), datasets[0].x_train[:1])[0]
    js = jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jmodel, jengine.masked_cross_entropy),
        tx=jpeft.masked_optimizer(optax.adam(0.01), jpeft.lora_trainable_mask(init_params)),
        strategy=JFedOpt(optax.adam(0.01)), datasets=datasets, batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=8, seed=3,
        exchanger=jpeft.lora_exchanger(), execution_mode="pipelined")
    tmodule = TTransformer(vocab_size=128, n_classes=4, d_model=32, n_heads=2, n_layers=2,
                           d_ff=64, max_len=16, lora_rank=4)
    ts = _port_sim(js, tmodule, _lora_tx(0.01, _flat(js.global_params)),
                   TFedOpt(optim.adam(0.01)), tpeft.lora_exchanger(), batch_size=8,
                   local_steps=8, seed=3)
    _compare(ts.fit(2), js.fit(2))


def test_long_context_example_matches_jax():
    """examples/long_context_example at its tiny widths (run.py's
    FL4HEALTH_EXAMPLE_TINY: T 32, vocab 64, d_model 16, 2 heads, 1 layer,
    d_ff 32, block 16, 2 local steps), 2 clients, batch 4, client
    adam(0.001), FedAvg, remat, flash attention: JAX's Pallas kernel in
    interpret mode, the port's plain version on the CPU; 1 round."""
    jmodule = JTransformer(vocab_size=64, n_classes=4, d_model=16, n_heads=2, n_layers=1,
                           d_ff=32, max_len=32, remat=True,
                           attention_fn=functools.partial(jfa.flash_attention, block_q=16,
                                                          block_k=16))
    datasets = []
    for i in range(2):
        x, y = jtext(jax.random.PRNGKey(30 + i), 24, 64, 32, 4, class_sep=3.0)
        datasets.append(jsim.ClientDataset(x[:16], y[:16], x[16:], y[16:]))
    js = jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(jmodule), jengine.masked_cross_entropy),
        tx=optax.adam(0.001), strategy=JFedAvg(), datasets=datasets, batch_size=4,
        metrics=JMetricManager((jefficient.accuracy(),)), local_steps=2, seed=23,
        execution_mode="pipelined")
    tmodule = TTransformer(vocab_size=64, n_classes=4, d_model=16, n_heads=2, n_layers=1,
                           d_ff=32, max_len=32, remat=True, attention_fn=flash_attention)
    ts = _port_sim(js, tmodule, optim.adam(0.001), TFedAvg(), batch_size=4, local_steps=2,
                   seed=23)
    init = {k: v.clone() for k, v in ts.global_params.items()}
    _compare(ts.fit(1), js.fit(1))
    got, want = ts.global_params, _flat(js.global_params)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=TOL, rtol=0,
                                   err_msg=k)
    assert float((got["classifier/kernel"] - init["classifier/kernel"]).abs().max()) > 0
