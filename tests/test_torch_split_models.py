"""The split-model bases and the contrastive losses of the port
(``models/bases.py``, ``losses/contrastive.py``) against the JAX package
on the CPU:

- every new module from its converted flax init: flax's key set and
  shapes, and the forward's outputs (predictions and features), with
  ``JoinMode.CONCATENATE`` and ``SUM``, APFL's alpha at 0, 0.3, 1 and its
  default, GPFL with and without conditional inputs, FedSimCLR's two
  stages, ``ConvFeatures`` on NHWC images;
- each base's exchange predicate picks the same leaves in both packages;
- ``ntxent_loss``, ``cosine_similarity_loss`` and ``perfcl_loss`` with and
  without masks;
- R12 (ROADMAP.md C) in both packages: Constrained FENDA's ``cos_sim`` term
  is the masked mean of cos^2, not ``cosine_similarity_loss``'s mean |cos|.

Tolerances: 5e-4 for a module's forward (f32, the reference's), 1e-5 for
the losses."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.clients.fenda import ConstrainedFendaClientLogic as JConstrained
from fl4health_tpu.losses import contrastive as jcon
from fl4health_tpu.models import bases as jb
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients.fenda import ConstrainedFendaClientLogic as TConstrained
from fl4health_tpu_torch.losses import contrastive as tcon
from fl4health_tpu_torch.models import bases as tb
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp

TOL = 5e-4
LOSS_TOL = 1e-5
DIM, N_CLASSES, B = 8, 3, 6


def _split(mode):
    return (jb.ParallelSplitModel(
                first_feature_extractor=jb.DenseFeatures((12,)),
                second_feature_extractor=jb.DenseFeatures((16,) if mode is None else (12,)),
                head_module=jb.HeadModule(head=jb.DenseHead(N_CLASSES),
                                          join_mode=getattr(jb.JoinMode, mode or "CONCATENATE"))),
            tb.ParallelSplitModel(
                tb.DenseFeatures(DIM, (12,)),
                tb.DenseFeatures(DIM, (16,) if mode is None else (12,)),
                tb.HeadModule(tb.DenseHead(28 if mode is None else
                                           (24 if mode == "CONCATENATE" else 12), N_CLASSES),
                              join_mode=getattr(tb.JoinMode, mode or "CONCATENATE"))))


# name -> (flax module, port module, apply kwargs, input shape)
MODULES = {
    "sequential": lambda: (jb.SequentiallySplitModel(features_module=jb.DenseFeatures((16,)),
                                                     head_module=jb.DenseHead(N_CLASSES)),
                           tb.SequentiallySplitModel(tb.DenseFeatures(DIM, (16,)),
                                                     tb.DenseHead(16, N_CLASSES)), {}, (DIM,)),
    "parallel_concatenate": lambda: (*_split("CONCATENATE"), {}, (DIM,)),
    "parallel_concatenate_uneven": lambda: (*_split(None), {}, (DIM,)),
    "parallel_sum": lambda: (*_split("SUM"), {}, (DIM,)),
    **{f"apfl_alpha_{a}": (lambda a=a: (
        jb.ApflModule(local_model=JMlp(features=(16,), n_outputs=N_CLASSES),
                      global_model=JMlp(features=(16,), n_outputs=N_CLASSES)),
        tb.ApflModule(TMlp(DIM, (16,), N_CLASSES), TMlp(DIM, (16,), N_CLASSES)),
        {} if a is None else {"alpha": a}, (DIM,))) for a in (None, 0.0, 0.3, 1.0)},
    "gpfl_no_conditionals": lambda: (
        jb.GpflModel(base_module=jb.DenseFeatures((16,)), n_classes=N_CLASSES, feature_dim=12),
        tb.GpflModel(tb.DenseFeatures(DIM, (16,)), N_CLASSES, 12), {}, (DIM,)),
    "gpfl_conditionals": lambda: (
        jb.GpflModel(base_module=jb.DenseFeatures((16,)), n_classes=N_CLASSES, feature_dim=12),
        tb.GpflModel(tb.DenseFeatures(DIM, (16,)), N_CLASSES, 12),
        {"p_cond": np.linspace(-1.0, 1.0, 12, dtype=np.float32),
         "g_cond": np.linspace(0.5, -0.25, 12, dtype=np.float32)}, (DIM,)),
    "ensemble": lambda: (jb.EnsembleModel(members=tuple(JMlp(features=(16,),
                                                             n_outputs=N_CLASSES)
                                                        for _ in range(3))),
                         tb.EnsembleModel([TMlp(DIM, (16,), N_CLASSES) for _ in range(3)]),
                         {}, (DIM,)),
    "fedsimclr_pretrain": lambda: (
        jb.FedSimClrModel(encoder=jb.DenseFeatures((16,)), projection_head=jb.DenseHead(5),
                          prediction_head=jb.DenseHead(N_CLASSES), pretrain=True),
        tb.FedSimClrModel(tb.DenseFeatures(DIM, (16,)), tb.DenseHead(16, 5),
                          tb.DenseHead(16, N_CLASSES), pretrain=True), {}, (DIM,)),
    "fedsimclr_finetune": lambda: (
        jb.FedSimClrModel(encoder=jb.DenseFeatures((16,)), projection_head=jb.DenseHead(5),
                          prediction_head=jb.DenseHead(N_CLASSES), pretrain=False),
        tb.FedSimClrModel(tb.DenseFeatures(DIM, (16,)), tb.DenseHead(16, 5),
                          tb.DenseHead(16, N_CLASSES), pretrain=False), {}, (DIM,)),
    "conv_features": lambda: (jb.ConvFeatures(channels=(4, 6)),
                              tb.ConvFeatures((4, 6), input_shape=(12, 12, 3)), {}, (12, 12, 3)),
    "fenda_of_conv_features": lambda: (
        jb.FendaModel(first_feature_extractor=jb.ConvFeatures(channels=(4, 6)),
                      second_feature_extractor=jb.ConvFeatures(channels=(4, 6)),
                      head_module=jb.HeadModule(head=jb.DenseHead(N_CLASSES))),
        tb.FendaModel(tb.ConvFeatures((4, 6), (12, 12, 3)), tb.ConvFeatures((4, 6), (12, 12, 3)),
                      tb.HeadModule(tb.DenseHead(2 * 54, N_CLASSES))), {}, (12, 12, 3)),
}

# the flax key sets the port must reproduce (convert.py stays a flattening)
KEYS = {
    "sequential": {"features_module/Dense_0/kernel", "features_module/Dense_0/bias",
                   "head_module/Dense_0/kernel", "head_module/Dense_0/bias"},
    "parallel_sum": {f"{m}/Dense_0/{p}" for m in ("first_feature_extractor",
                                                  "second_feature_extractor")
                     for p in ("kernel", "bias")}
    | {"head_module/head/Dense_0/kernel", "head_module/head/Dense_0/bias"},
    "gpfl_conditionals": {"base_module/Dense_0/kernel", "base_module/Dense_0/bias",
                          "feature_mapper/kernel", "feature_mapper/bias", "gce/embedding",
                          "head/kernel", "head/bias"}
    | {f"cov/Dense_{i}/{p}" for i in range(3) for p in ("kernel", "bias")},
    "ensemble": {f"members_{i}/Dense_{j}/{p}" for i in range(3) for j in range(2)
                 for p in ("kernel", "bias")},
    "fedsimclr_pretrain": {f"{m}/Dense_0/{p}" for m in ("encoder", "projection_head")
                           for p in ("kernel", "bias")},
    "fedsimclr_finetune": {f"{m}/Dense_0/{p}" for m in ("encoder", "prediction_head")
                           for p in ("kernel", "bias")},
    "conv_features": {f"Conv_{i}/{p}" for i in range(2) for p in ("kernel", "bias")},
}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _flat_outputs(out) -> dict:
    """(preds, features) or bare arrays as a path-keyed dict of numpy."""
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, (tuple, list)):
            for i, n in enumerate(node):
                walk(n, f"{path}/{i}")
        else:
            flat[path] = np.asarray(node.detach() if isinstance(node, torch.Tensor) else node)

    walk(out, "")
    return flat


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_its_flax_counterpart(name):
    jmod, tmod, kwargs, shape = MODULES[name]()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, *shape)), np.float32)
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    jparams = jmod.init(jax.random.PRNGKey(0), x, **jkw)["params"]
    params = convert.flax_to_torch(_np_tree(jparams))
    own = tmod.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in own.items()}
    if name in KEYS:
        assert set(params) == KEYS[name]
    want = _flat_outputs(jmod.apply({"params": jparams}, x, **jkw))
    tkw = {k: torch.tensor(v) for k, v in kwargs.items()}
    got = _flat_outputs(tengine.from_module(tmod).apply(params, {}, torch.tensor(x), **tkw)[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


PREDICATES = [
    ("sequential", "SequentiallySplitModel", "exchange_features_only"),
    ("parallel_sum", "ParallelSplitModel", "exchange_global_extractor"),
    ("apfl_alpha_0.3", "ApflModule", "exchange_global_model"),
    ("gpfl_conditionals", "GpflModel", "exchange_shared"),
]


@pytest.mark.parametrize("name,cls,predicate", PREDICATES, ids=[p[2] for p in PREDICATES])
def test_exchange_predicates_pick_the_same_leaves(name, cls, predicate):
    _, tmod, _, _ = MODULES[name]()
    keys = tmod.init_params(torch.Generator().manual_seed(0))
    jpred, tpred = getattr(getattr(jb, cls), predicate), getattr(getattr(tb, cls), predicate)
    picked = {k for k in keys if tpred(k)}
    assert picked == {k for k in keys if jpred(k)}
    assert picked and picked != set(keys)


def test_the_aliases_are_jax_s():
    assert tb.FedRepModel is tb.SequentiallySplitModel
    assert tb.FendaModel is tb.PerFclModel is tb.ParallelSplitModel
    assert [m.value for m in tb.JoinMode] == [m.value for m in jb.JoinMode]


def _pairs(seed, b=B, d=5):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, d)).astype(np.float32) for _ in range(5)]


MASKS = {"unmasked": None, "masked": np.array([1, 1, 0, 1, 0, 1], np.float32),
         "one_valid": np.array([0, 0, 0, 1, 0, 0], np.float32)}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("temperature", [0.5, 0.1])
def test_ntxent_matches_jax(mask, temperature):
    a, b = _pairs(2)[:2]
    m = MASKS[mask]
    want = jcon.ntxent_loss(a, b, temperature, None if m is None else jnp.asarray(m))
    got = tcon.ntxent_loss(torch.tensor(a), torch.tensor(b), temperature,
                           None if m is None else torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_cosine_similarity_loss_matches_jax(mask):
    a, b = _pairs(3)[:2]
    m = MASKS[mask]
    want = jcon.cosine_similarity_loss(a, b, None if m is None else jnp.asarray(m))
    got = tcon.cosine_similarity_loss(torch.tensor(a), torch.tensor(b),
                                      None if m is None else torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_perfcl_loss_matches_jax(mask):
    feats = _pairs(4)
    m = MASKS[mask]
    want = jcon.perfcl_loss(*feats, temperature=0.3, mask=None if m is None else jnp.asarray(m))
    got = tcon.perfcl_loss(*map(torch.tensor, feats), temperature=0.3,
                           mask=None if m is None else torch.tensor(m))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_TOL, atol=LOSS_TOL)


def test_r12_constrained_fenda_cos_term_is_the_mean_squared_cosine_in_both_packages():
    """The term JAX's docstring calls "minimizing |cos|" (citing the
    reference's cosine_similarity_loss) is the masked mean of cos^2 in JAX,
    and in the port, which mirrors it; ``cosine_similarity_loss`` (mean
    |cos|) gives another number on the same features."""
    z_p, z_s = _pairs(5)[:2]
    m = MASKS["masked"]
    batch = dict(x=np.zeros((B, DIM), np.float32), y=np.zeros((B,), np.int32),
                 example_mask=m, step_mask=np.float32(1.0))
    preds = np.zeros((B, N_CLASSES), np.float32)
    jlogic = JConstrained(None, jengine.masked_cross_entropy, cos_sim_loss_weight=1.0)
    tlogic = TConstrained(None, tengine.masked_cross_entropy, cos_sim_loss_weight=1.0)
    _, jout = jlogic.training_loss(
        {"prediction": jnp.asarray(preds)},
        {"local_features": jnp.asarray(z_p), "global_features": jnp.asarray(z_s)},
        jengine.Batch(**{k: jnp.asarray(v) for k, v in batch.items()}), None, None, None)
    _, tout = tlogic.training_loss(
        {"prediction": torch.tensor(preds)},
        {"local_features": torch.tensor(z_p), "global_features": torch.tensor(z_s)},
        tengine.Batch(**{k: torch.tensor(v) for k, v in batch.items()}), None, None, None)
    cos = np.asarray(jcon.cosine_similarity(z_p, z_s), np.float64)
    mean_sq = float((cos ** 2 * m).sum() / m.sum())
    mean_abs = float(jcon.cosine_similarity_loss(z_p, z_s, jnp.asarray(m)))
    for got in (float(jout["cos_sim"]), float(tout["cos_sim"])):
        np.testing.assert_allclose(got, mean_sq, rtol=LOSS_TOL, atol=LOSS_TOL)
        assert abs(got - mean_abs) > 0.05
