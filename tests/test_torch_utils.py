"""The port's data tail and utils against the JAX package on the CPU:
``dirichlet_partition`` bit for bit, ``fedprox_synthetic``'s features at
1e-5 and its labels equal (a near-tie could flip one; none does at these
sizes, a count this test pins), ``utils/config.py``, ``utils/random.py``,
``utils/hp_search.py`` (the same folder, the same ranking) and the
``WandBReporter`` with a fake ``wandb`` module logging JAX's payloads."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import json
import random
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.datasets import synthetic as jsynth
from fl4health_tpu.reporting.base import WandBReporter as JWandB
from fl4health_tpu.utils import config as jconfig
from fl4health_tpu.utils import hp_search as jhp
from fl4health_tpu.utils import random as jrandom
from fl4health_tpu_torch import rng
from fl4health_tpu_torch.datasets import synthetic as tsynth
from fl4health_tpu_torch.reporting.base import WandBReporter as TWandB
from fl4health_tpu_torch.utils import config as tconfig
from fl4health_tpu_torch.utils import hp_search as thp
from fl4health_tpu_torch.utils import random as trandom

FEATURE_TOL = 1e-5


@pytest.mark.parametrize("seed,dim,classes,n", [(0, 30, 6, 120), (1, 60, 10, 50),
                                                (2, 8, 3, 24)])
def test_fedprox_synthetic_matches_jax(seed, dim, classes, n):
    want = jsynth.fedprox_synthetic(jax.random.PRNGKey(seed), 5, n, alpha=0.5, beta=0.5,
                                    dim=dim, n_classes=classes)
    got = tsynth.fedprox_synthetic(rng.PRNGKey(seed), 5, n, alpha=0.5, beta=0.5, dim=dim,
                                   n_classes=classes)
    flips = 0
    for (jx, jy), (tx, ty) in zip(want, got):
        assert tx.dtype == torch.float32 and ty.dtype == torch.int32
        assert tuple(tx.shape) == (n, dim)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=FEATURE_TOL, rtol=0)
        flips += int((ty.numpy() != np.asarray(jy)).sum())
    # labels are an argmax over logits summed in another order: a near-tie
    # may flip; at these sizes none does
    assert flips == 0


@pytest.mark.parametrize("beta,parts,seed", [(0.5, 4, 3), (5.0, 3, 0), (0.1, 2, 9)])
def test_dirichlet_partition_is_bit_equal_to_jax(beta, parts, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((300, 5)).astype(np.float32)
    y = r.integers(0, 6, 300).astype(np.int32)
    want = jsynth.dirichlet_partition(jax.random.PRNGKey(seed), jnp.asarray(x),
                                      jnp.asarray(y), parts, beta)
    got = tsynth.dirichlet_partition(rng.PRNGKey(seed), torch.tensor(x), torch.tensor(y),
                                     parts, beta)
    as_np = tsynth.dirichlet_partition(rng.PRNGKey(seed), x, y, parts, beta)
    assert len(got) == len(want) == len(as_np) == parts
    for (jx, jy), (tx, ty), (nx, ny) in zip(want, got, as_np):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(nx, np.asarray(jx))
        np.testing.assert_array_equal(ny, np.asarray(jy))


def test_dirichlet_partition_refuses_as_jax():
    y = np.zeros(4, np.int32)
    x = np.zeros((4, 1), np.float32)
    with pytest.raises(ValueError) as te:
        tsynth.dirichlet_partition(rng.PRNGKey(0), x, y, 4, 0.01, min_examples=2)
    with pytest.raises(ValueError) as je:
        jsynth.dirichlet_partition(jax.random.PRNGKey(0), x, y, 4, 0.01, min_examples=2)
    assert str(te.value) == str(je.value)


CONFIGS = [{"n_server_rounds": 3, "batch_size": 8}, {"n_server_rounds": 0},
           {"n_server_rounds": True}, {"batch_size": 8}, None, [1, 2],
           {"n_server_rounds": 2, "local_steps": -1}, {"n_server_rounds": 2, "local_epochs": 1}]


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_check_config_decides_as_jax(cfg):
    def outcome(mod):
        try:
            mod.check_config(cfg)
            return "ok"
        except mod.InvalidConfigError as e:
            return str(e)

    assert outcome(tconfig) == outcome(jconfig)


def test_load_config_and_helpers_as_jax(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("n_server_rounds: 4\nbatch_size: 8\nlocal_steps: 5\nname: x\n")
    assert tconfig.load_config(str(path)) == jconfig.load_config(str(path))
    cfg = tconfig.load_config(str(path))
    assert tconfig.narrow_dict_type(cfg, "name", str) == "x"
    with pytest.raises(tconfig.InvalidConfigError):
        tconfig.narrow_dict_type(cfg, "batch_size", str)
    assert (tconfig.epochs_steps_from_config(cfg)
            == jconfig.epochs_steps_from_config(cfg) == (None, 5))
    # yaml is imported by load_config alone
    assert "yaml" not in {n.split(".")[0] for n in tconfig.__dict__}


def test_set_all_random_seeds_seeds_as_jax():
    jkey = jrandom.set_all_random_seeds(123)
    want = (random.random(), np.random.random())
    tkey = trandom.set_all_random_seeds(123)
    got = (random.random(), np.random.random())
    assert got == want
    assert [int(v) for v in rng.key_data(tkey)] == [int(v) for v in
                                                    np.asarray(jax.random.key_data(jkey))]
    state = trandom.save_random_state()
    a = (random.random(), np.random.random())
    trandom.restore_random_state(state)
    assert (random.random(), np.random.random()) == a


def test_hp_grid_matches_jax():
    assert thp.hp_grid(lr=[0.1, 0.01], mu=[0.0, 1.0]) == jhp.hp_grid(lr=[0.1, 0.01],
                                                                     mu=[0.0, 1.0])


def _sweep_tree(root):
    """A sweep directory of JsonReporter dumps and JSONL records, with a
    stale file and a stray config in it."""
    dumps = {"mu_0.01": [0.61, 0.64], "mu_0.1": [0.71, 0.69], "mu_1.0": [0.55, 0.7]}
    for hp, accs in dumps.items():
        for i, acc in enumerate(accs):
            run = root / hp / f"Run{i + 1}"
            run.mkdir(parents=True)
            rounds = {str(r): {"accuracy": acc * r / 3, "fit_loss": 1.0 / r} for r in (1, 2, 3)}
            (run / "server_metrics.json").write_text(json.dumps({"rounds": rounds}))
    (root / "mu_1.0" / "Run1" / "notes.json").write_text("{not json")
    jsonl = root / "mu_3.0" / "Run1"
    jsonl.mkdir(parents=True)
    (jsonl / "m.json").write_text("\n".join(json.dumps({"accuracy": a}) for a in (0.2, 0.3)))
    (root / "stray.json").write_text("{}")


@pytest.mark.parametrize("metric,minimize", [("accuracy", False), ("fit_loss", True),
                                             ("missing", True)])
def test_find_best_hp_dir_selects_the_jax_folder(tmp_path, metric, minimize):
    _sweep_tree(tmp_path)
    got = thp.find_best_hp_dir(tmp_path, metric=metric, minimize=minimize)
    want = jhp.find_best_hp_dir(tmp_path, metric=metric, minimize=minimize)
    assert got == want
    if metric == "accuracy":
        assert got[0].name == "mu_0.1"


def test_sweep_ranks_as_jax():
    """``sweep`` over a stand-in simulation whose history scores each
    config deterministically: the same ranking and scores in both."""
    def builder(seed, lr, mu):
        score = (lr - 0.05) ** 2 + mu + 0.01 * seed
        record = types.SimpleNamespace(eval_losses={"checkpoint": score})
        return types.SimpleNamespace(fit=lambda n: [record] * n)

    grid = thp.hp_grid(lr=[0.01, 0.05, 0.5], mu=[0.0, 0.1])
    got = thp.sweep(builder, grid, n_rounds=2, n_seeds=2)
    want = jhp.sweep(builder, grid, n_rounds=2, n_seeds=2)
    assert [(r.params, r.scores) for r in got] == [(r.params, r.scores) for r in want]


class _FakeRun:
    def __init__(self):
        self.logged, self.finished = [], False

    def log(self, payload):
        self.logged.append(payload)

    def finish(self):
        self.finished = True


def _fake_wandb(monkeypatch):
    runs, inits = [], []

    def init(project=None, **kw):
        inits.append((project, kw))
        runs.append(_FakeRun())
        return runs[-1]

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    return runs, inits


def test_wandb_reporter_logs_jax_payloads(monkeypatch):
    data = {"fit_loss": np.float32(0.5), "acc": torch.tensor(0.25), "n": 3,
            "vec": np.arange(3.0), "nested": {"a": 1.5}}
    jdata = {**data, "acc": np.float32(0.25)}
    runs, inits = _fake_wandb(monkeypatch)
    for cls, payload in ((JWandB, jdata), (TWandB, data)):
        rep = cls(project="p", entity="e")
        rep.initialize()
        rep.report(payload, round=2)
        rep.report({"eval_loss": 1.0})
        rep.shutdown()
    assert inits == [("p", {"entity": "e"})] * 2
    assert runs[1].logged == runs[0].logged and runs[1].finished
    assert runs[1].logged[0]["round"] == 2


def test_wandb_reporter_without_wandb_reports_nothing(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)
    rep = TWandB()
    rep.initialize()
    rep.report({"x": 1.0}, round=1)
    rep.shutdown()
    assert "WandBReporter disabled" in caplog.text
