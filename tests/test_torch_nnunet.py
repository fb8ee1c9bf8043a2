"""The port's nnU-Net stack against the JAX package on the CPU: the plans
(``nnunet/plans.py``) equal for the same fingerprints, the patches
(``nnunet/data.py``) equal, the segmentation losses and Dice metrics within
5e-4, ``nnunet_optimizer``'s updates against optax's over 10 steps, the
plans handshake (``clients/nnunet.py``, ``server/nnunet.py``,
``poll_clients``), and the ``nnunet_synthetic`` smoke config
(``tests/smoke/harness.py``) through ``NnunetServer``: within 5e-4 of JAX
on the losses, and within the harness's tolerances of its golden."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import nnunet as jclient
from fl4health_tpu.losses import segmentation as jseg
from fl4health_tpu.metrics import efficient as jeff
from fl4health_tpu.nnunet import data as jdata
from fl4health_tpu.nnunet import plans as jplans
from fl4health_tpu.server import servers as jservers
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.clients import nnunet as tclient
from fl4health_tpu_torch.losses import segmentation as tseg
from fl4health_tpu_torch.metrics import efficient as teff
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models import unet as tunet
from fl4health_tpu_torch.nnunet import data as tdata
from fl4health_tpu_torch.nnunet import plans as tplans
from fl4health_tpu_torch.server import nnunet as tserver
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

sys.path.insert(0, str(Path(__file__).parent / "smoke"))
import harness  # noqa: E402

TOL = 5e-4


def synth(n, size, seed):
    """``tests/smoke/harness.py``'s synthetic spheres: ``n`` volumes of
    ``size``^3 with one sphere each, a channel of noise around it."""
    rng = np.random.default_rng(seed)
    vols, segs = [], []
    for _ in range(n):
        coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1).astype(float)
        c = np.asarray([rng.uniform(size * 0.3, size * 0.7) for _ in range(3)])
        r = size * rng.uniform(0.2, 0.3)
        seg = (np.sqrt(((coords - c) ** 2).sum(-1)) < r).astype(np.int32)
        vols.append((rng.normal(0, 0.3, (size,) * 3)[..., None] + seg[..., None]).astype(
            np.float32))
        segs.append(seg)
    return vols, segs


def _fingerprints():
    v3, s3 = synth(3, 12, 1)
    aniso = [np.random.default_rng(i).normal(size=(20 + 4 * i, 14, 9, 2)).astype(np.float32)
             for i in range(3)]
    flat = [np.random.default_rng(i).normal(size=(40, 36 + i, 1)).astype(np.float32)
            for i in range(2)]
    return {
        "3d": (v3, [(1.0, 1.0, 1.0)] * 3, s3),
        "anisotropic": (aniso, [(3.0, 1.0, 1.0), (2.5, 0.9, 1.0), (3.0, 1.1, 1.2)], None),
        "2d": (flat, [(1.0, 1.0), (0.8, 1.0)], None),
    }


@pytest.mark.parametrize("name", ["3d", "anisotropic", "2d"])
@pytest.mark.parametrize("kw", [{}, {"max_patch_voxels": 6**3, "max_stages": 4},
                                {"base_features": 8, "batch_size_cap_fraction": 0.5}])
def test_plans_equal_jax(name, kw):
    vols, spacings, segs = _fingerprints()[name]
    fp = tplans.extract_fingerprint(vols, spacings, segs)
    assert fp == jplans.extract_fingerprint(vols, spacings, segs)
    if name == "2d" and "max_patch_voxels" in kw:
        kw = {**kw, "max_patch_voxels": 20**2}
    plans = tplans.generate_plans(fp, dataset_name="D1", **kw)
    assert plans == jplans.generate_plans(fp, dataset_name="D1", **kw)
    assert tplans.default_configuration(plans) == jplans.default_configuration(plans)
    assert tplans.plans_to_bytes(plans) == jplans.plans_to_bytes(plans)
    assert tplans.plans_from_bytes(tplans.plans_to_bytes(plans)) == plans
    local = tplans.localize_plans(plans, fp, "site_b")
    assert local == jplans.localize_plans(plans, fp, "site_b")


def test_patches_equal_jax():
    vols, segs = synth(3, 12, 2)
    fp = jplans.extract_fingerprint(vols, [(1.0,) * 3] * 3, segs)
    plans = jplans.generate_plans(fp, max_patch_voxels=8**3)
    props = plans["foreground_intensity_properties_per_channel"]
    np.testing.assert_array_equal(tdata.normalize_volume(vols[0], props),
                                  jdata.normalize_volume(vols[0], props))
    for seed in (0, 3):
        tx, ty = tdata.extract_patch_dataset(vols, segs, plans, n_patches=7, seed=seed)
        jx, jy = jdata.extract_patch_dataset(vols, segs, plans, n_patches=7, seed=seed)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    tprov = tdata.make_patch_resampler([vols[:2], vols[2:]], [segs[:2], segs[2:]], plans, 4,
                                       every=2)
    jprov = jdata.make_patch_resampler([vols[:2], vols[2:]], [segs[:2], segs[2:]], plans, 4,
                                       every=2)
    for r in (1, 2, 3):
        t, j = tprov(r), jprov(r)
        assert (t is None) == (j is None)
        if t is not None:
            for a, b in zip([*t[0], *t[1]], [*j[0], *j[1]]):
                np.testing.assert_array_equal(a, b)


def _seg_inputs(seed, shape=(3, 8, 6, 4), n_classes=3):
    g = np.random.default_rng(seed)
    logits = (g.standard_normal((*shape, n_classes)) * 2).astype(np.float32)
    target = g.integers(0, n_classes, shape).astype(np.int32)
    mask = np.asarray([1.0, 1.0, 0.0], np.float32)
    return logits, target, mask


@pytest.mark.parametrize("ignore_label", [None, 2])
def test_losses_match_jax(ignore_label):
    logits, target, mask = _seg_inputs(0)
    want = jseg.masked_dice_ce_loss(jnp.asarray(logits), jnp.asarray(target),
                                    jnp.asarray(mask), ignore_label)
    got = tseg.masked_dice_ce_loss(torch.tensor(logits), torch.tensor(target),
                                   torch.tensor(mask), ignore_label)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), atol=TOL, rtol=0)
    preds = {"prediction": logits, "ds_1": _seg_inputs(1, (3, 4, 3, 2))[0],
             "ds_2": _seg_inputs(2, (3, 2, 3, 1))[0]}
    strides = [(2, 2, 2), (4, 2, 4)]
    want = jseg.deep_supervision_loss({k: jnp.asarray(v) for k, v in preds.items()},
                                      jnp.asarray(target), jnp.asarray(mask), strides,
                                      ignore_label)
    got = tseg.deep_supervision_loss({k: torch.tensor(v) for k, v in preds.items()},
                                     torch.tensor(target), torch.tensor(mask), strides,
                                     ignore_label)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), atol=TOL, rtol=0)
    for n in (1, 2, 4):
        assert tseg.deep_supervision_weights(n) == jseg.deep_supervision_weights(n)
    np.testing.assert_array_equal(
        tseg.downsample_target(torch.tensor(target), (2, 3, 2)).numpy(),
        np.asarray(jseg.downsample_target(jnp.asarray(target), (2, 3, 2))))


def _stream(tmetric, jmetric, batches):
    ts, js = tmetric.init("cpu"), jmetric.init()
    for p, t, m in batches:
        ts = tmetric.update(ts, torch.tensor(p), torch.tensor(t), torch.tensor(m))
        js = jmetric.update(js, jnp.asarray(p), jnp.asarray(t), jnp.asarray(m))
    return tmetric.compute(ts).item(), float(jmetric.compute(js))


@pytest.mark.parametrize("ignore_label", [None, 1])
def test_dice_metrics_match_jax(ignore_label):
    seg = [_seg_inputs(s) for s in (3, 4)]
    got, want = _stream(teff.segmentation_dice(3, ignore_label),
                        jeff.segmentation_dice(3, ignore_label), seg)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    g = np.random.default_rng(5)
    flat = [(g.standard_normal((6, 4)).astype(np.float32),
             g.integers(0, 4, 6).astype(np.int32), np.ones(6, np.float32)) for _ in range(2)]
    got, want = _stream(teff.multiclass_dice(4), jeff.multiclass_dice(4), flat)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    soft = [(g.standard_normal((3, 5, 5)).astype(np.float32),
             g.integers(0, 2, (3, 5, 5)).astype(np.float32),
             np.asarray([1, 0, 1], np.float32)) for _ in range(2)]
    got, want = _stream(teff.binary_soft_dice(), jeff.binary_soft_dice(), soft)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_nnunet_optimizer_matches_optax_over_10_steps():
    g = np.random.default_rng(6)
    params = {"a/kernel": g.standard_normal((4, 3)).astype(np.float32),
              "b/bias": g.standard_normal((5,)).astype(np.float32)}
    jtx, ttx = jplans.nnunet_optimizer(1e-2, 12), tplans.nnunet_optimizer(1e-2, 12)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(10):
        # big gradients in the first steps, so the global-norm clip fires
        scale = 40.0 if step < 3 else 1.0
        grads = {k: (g.standard_normal(v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        tu, ts = ttx.update({k: torch.tensor(v) for k, v in grads.items()}, ts, tp)
        jp, tp = optax.apply_updates(jp, ju), {k: tp[k] + tu[k] for k in tp}
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), atol=1e-6, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-5, rtol=0)
    for step in (0, 5, 11, 12, 20):
        np.testing.assert_allclose(
            tplans.poly_lr_schedule(1e-2, 12)(torch.tensor(step, dtype=torch.int32)).item(),
            float(jplans.poly_lr_schedule(1e-2, 12)(jnp.asarray(step, jnp.int32))),
            rtol=1e-6, atol=0)
    conv = convert.optax_state_to_torch(jax.tree_util.tree_map(np.asarray, js))
    assert int(conv[2][1].count) == int(ts[2][1].count) == 10


def test_properties_handshake_matches_jax():
    vols, segs = synth(2, 12, 3)
    segs[1][0, 0, 0] = 7  # an ignore label
    kw = dict(max_patch_voxels=12**3, ignore_label=7)
    tprov = tclient.make_nnunet_properties_provider(vols, [(1.0,) * 3] * 2, segs, **kw)
    jprov = jclient.make_nnunet_properties_provider(vols, [(1.0,) * 3] * 2, segs, **kw)
    assert (tservers.poll_clients([tprov, tprov], {"ask": 1})
            == jservers.poll_clients([jprov, jprov], {"ask": 1}))
    assert tprov({})["num_segmentation_heads"] == 2


# ---------------------------------------------------------------------------
# The nnunet_synthetic smoke config
# ---------------------------------------------------------------------------

def port_nnunet_synthetic(augment: bool = False, resample: bool = False, init=None):
    """``harness.nnunet_synthetic`` in the port, on the CPU; ``init`` (flax
    params) is installed as the initial global model."""
    client_data = [synth(4, 12, 10), synth(4, 12, 20)]
    providers = [tclient.make_nnunet_properties_provider(
        v, [(1.0, 1.0, 1.0)] * len(v), s, max_patch_voxels=12**3) for v, s in client_data]

    def sim_builder(plans, n_in, n_heads):
        cfg = plans["configurations"]["3d_fullres"]
        cfg["features_per_stage"] = [max(f // 4, 8) for f in cfg["features_per_stage"]]
        net = tunet.unet_from_plans(plans, n_in, n_heads)
        logic = tclient.NnunetClientLogic(tengine.from_module(net),
                                          ds_strides=tunet.deep_supervision_strides(plans),
                                          augment=augment)
        datasets = []
        for i, (v, s) in enumerate(client_data):
            x, y = tdata.extract_patch_dataset(v, s, plans, n_patches=10, seed=i)
            datasets.append(tsim.ClientDataset(x_train=x[:8], y_train=y[:8], x_val=x[8:],
                                               y_val=y[8:]))
        provider = None
        if resample:
            def provider(round_idx):
                fresh = tdata.make_patch_resampler([cd[0] for cd in client_data],
                                                   [cd[1] for cd in client_data],
                                                   plans, 10)(round_idx)
                if fresh is None:
                    return None
                return [x[:8] for x in fresh[0]], [y[:8] for y in fresh[1]]
        sim = tsim.FederatedSimulation(
            logic=logic, tx=tplans.nnunet_optimizer(5e-3, harness.N_ROUNDS * 4),
            strategy=TFedAvg(), datasets=datasets, batch_size=2,
            metrics=TMetricManager((teff.segmentation_dice(n_heads),)), local_steps=4,
            seed=0, extra_loss_keys=("dice", "ce"), train_data_provider=provider,
            device="cpu")
        if init is not None:
            sim.set_global_params(convert.flax_to_torch(init))
        return sim

    return tserver.NnunetServer(config={"n_server_rounds": harness.N_ROUNDS},
                                property_providers=providers, sim_builder=sim_builder)


def jax_initial_params(jserver):
    """The flax init the JAX config's simulation starts from (its builder
    called on a copy of the plans: it shrinks the features in place)."""
    jserver.update_before_fit()
    sim = jserver.sim_builder(copy.deepcopy(jserver.plans), jserver.num_input_channels,
                              jserver.num_segmentation_heads)
    return jax.tree_util.tree_map(np.asarray, sim.global_params)


def golden_rows(history):
    return [{"eval_accuracy": round(h.eval_metrics["seg_dice"], 6),
             "eval_loss": round(h.eval_losses["checkpoint"], 6),
             "fit_loss": round(h.fit_losses["backward"], 6)} for h in history]


def assert_config_matches(name, jserver, tserver_):
    jhist = jserver.fit(harness.N_ROUNDS)
    thist = tserver_.fit(harness.N_ROUNDS)
    assert tserver_.plans == jserver.plans
    assert [r.round for r in thist] == [r.round for r in jhist]
    for tr, jr in zip(thist, jhist):
        for kind, keys in (("fit_losses", ("backward", "dice", "ce")),
                           ("eval_losses", ("checkpoint", "dice", "ce"))):
            for k in keys:
                np.testing.assert_allclose(getattr(tr, kind)[k], getattr(jr, kind)[k],
                                           atol=TOL, rtol=0, err_msg=f"{kind}[{k}] {tr.round}")
        np.testing.assert_allclose(tr.eval_metrics["seg_dice"], jr.eval_metrics["seg_dice"],
                                   atol=harness.TOLERANCES["eval_accuracy"]["atol"])
    errors = harness.compare_to_golden(name, golden_rows(thist))
    assert not errors, "\n".join(errors)
    return jhist, thist


def test_nnunet_synthetic_matches_jax_and_its_golden():
    jserver = harness.nnunet_synthetic()
    tserv = port_nnunet_synthetic(init=jax_initial_params(harness.nnunet_synthetic()))
    _, thist = assert_config_matches("nnunet_synthetic", jserver, tserv)
    # JAX's default mode takes the chunked route here, and so does the port's
    assert all(r.eval_elapsed_s == 0.0 for r in thist)
    assert tserv.sim._select_execution_mode(1)[0] == tsim.EXEC_CHUNKED
