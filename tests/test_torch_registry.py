"""The port's client registry against the JAX registry on the CPU, from the
same numpy data: the Dirichlet presets' index arrays equal; ``stage_round``
and ``stage_chunk`` tensors and ``chunk_window`` equal; the default key rows
``fold_in(init, i + 1)`` bit for bit; a gather then scatter round-trips a
row bit for bit (stored rows overwrite the prototype, pad slots never
persist); the client-symmetric check of the strategy rows raises; and a
cohort simulation refuses ``set_train_data``."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import pytest
import torch

from fl4health_tpu.datasets import registry_presets as jpresets
from fl4health_tpu.server import registry as jreg
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.datasets import registry_presets as tpresets
from fl4health_tpu_torch.server import registry as treg
from fl4health_tpu_torch.server import simulation as tsim

BASE_ENTROPY = [0, 5]


def _pool(n=300, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 4, 3)).astype(np.float32),
            r.integers(0, 10, n).astype(np.int32))


def _index_arrays(source):
    return ([source._train_idx[i] for i in range(source.n_clients)],
            [source._val_idx[i] for i in range(source.n_clients)])


@pytest.mark.parametrize("n_clients,beta", [(7, 0.5), (50, 0.1), (1000, 0.5)])
def test_dirichlet_registry_index_arrays_equal(n_clients, beta):
    x, y = _pool()
    want = jpresets.dirichlet_registry_source(x, y, n_clients, beta=beta, seed=3)
    got = tpresets.dirichlet_registry_source(x, y, n_clients, beta=beta, seed=3)
    assert isinstance(got, treg.IndexedPoolSource)
    for g_list, w_list in zip(_index_arrays(got), _index_arrays(want)):
        assert len(g_list) == len(w_list) == n_clients
        for g, w in zip(g_list, w_list):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.train_sizes(), want.train_sizes())
    np.testing.assert_array_equal(got.val_sizes(), want.val_sizes())


@pytest.mark.parametrize("preset", ["cifar_dirichlet_registry", "mnist_dirichlet_registry"])
def test_vision_presets_index_arrays_equal(preset):
    # the synthetic pools' labels are equal in both packages (the images
    # within rng.normal's 2 ulp), so the partitions are
    want = getattr(jpresets, preset)(40, pool_size=256, seed=1)
    got = getattr(tpresets, preset)(40, pool_size=256, seed=1)
    for g_list, w_list in zip(_index_arrays(got), _index_arrays(want)):
        for g, w in zip(g_list, w_list):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got._train_pool[1], np.asarray(want._train_pool[1]))


def _sources(kind):
    if kind == "pool":
        x, y = _pool(200)
        return (jpresets.dirichlet_registry_source(x, y, 12, beta=0.5, seed=2),
                tpresets.dirichlet_registry_source(x, y, 12, beta=0.5, seed=2))
    r = np.random.default_rng(1)
    rows = []
    for i in range(5):
        n = 20 + 3 * i
        x = {"a": r.standard_normal((n, 3)).astype(np.float32),
             "b": r.integers(0, 4, (n, 2)).astype(np.int32)}
        y = r.integers(0, 3, n).astype(np.int32)
        rows.append(({k: v[:n - 6] for k, v in x.items()}, y[:n - 6],
                     {k: v[n - 6:] for k, v in x.items()}, y[n - 6:]))
    return (jreg.as_registry_source([jsim.ClientDataset(*d) for d in rows]),
            treg.as_registry_source([tsim.ClientDataset(*d) for d in rows]))


def _leaves(tree):
    """Leaves of a JAX or port tree of staged numpy arrays, JAX's order
    (the port's dicts are walked sorted, as jax.tree_util does)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if hasattr(tree, "example_mask"):
        return [leaf for f in ("x", "y", "example_mask", "step_mask")
                for leaf in _leaves(getattr(tree, f))]
    return [np.asarray(tree)]


def _assert_staged_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in ("batches", "val_batches"):
            for g, w in zip(_leaves(got[k]), _leaves(want[k]), strict=True):
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["pool", "list"])
@pytest.mark.parametrize("steps", [dict(local_steps=3, local_epochs=None),
                                   dict(local_steps=None, local_epochs=2)])
def test_stage_round_and_stage_chunk_equal(kind, steps):
    jsrc, tsrc = _sources(kind)
    jr = jreg.ClientRegistry(jsrc, 8, **steps)
    tr = treg.ClientRegistry(tsrc, 8, **steps)
    assert (tr.train_steps, tr.val_steps) == (jr.train_steps, jr.val_steps)
    idx, valid = np.asarray([1, 3, 4, 1], np.int32), 3
    _assert_staged_equal(tr.stage_round(idx, valid, BASE_ENTROPY, 2),
                         jr.stage_round(idx, valid, BASE_ENTROPY, 2))
    draws = [(np.asarray([0, 2, 4, 0], np.int32), 3), (np.asarray([1, 2, 2, 2], np.int32), 2)]
    _assert_staged_equal(tr.stage_chunk(draws, BASE_ENTROPY, 5),
                         jr.stage_chunk(draws, BASE_ENTROPY, 5))


@pytest.mark.parametrize("n_rounds,slots", [(1, 4), (2, 4), (3, 6)])
def test_chunk_window_equal(n_rounds, slots):
    jsrc, tsrc = _sources("pool")
    jr, tr = (jreg.ClientRegistry(s, 8, 2, None) for s in (jsrc, tsrc))
    r = np.random.default_rng(n_rounds)
    idx_list = [np.sort(r.choice(12, slots, replace=False)).astype(np.int32)
                for _ in range(n_rounds)]
    valid_list = [slots - i for i in range(n_rounds)]
    got = tr.chunk_window(idx_list, valid_list, slots, n_rounds)
    want = jr.chunk_window(idx_list, valid_list, slots, n_rounds)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def _registry_with_proto(seed=9):
    _, tsrc = _sources("pool")
    reg = treg.ClientRegistry(tsrc, 8, 2, None)
    key = rng.fold_in(rng.PRNGKey(seed), 0)
    proto = tengine.TrainState(
        params={"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "h": torch.ones(3, dtype=torch.bfloat16)},
        opt_state={"m": torch.zeros(4)}, model_state={}, rng=key,
        step=torch.zeros((), dtype=torch.int32))
    reg.bind_client_states(proto, key)
    return reg, key


def test_default_rng_rows_are_fold_in_bit_for_bit():
    reg, key = _registry_with_proto()
    ids = np.asarray([0, 5, 11, 3], np.int64)
    jkey = jax.random.fold_in(jax.random.PRNGKey(9), 0)
    want = np.asarray(jax.vmap(lambda i: jax.random.fold_in(jkey, i))(ids + 1))
    got = reg.gather_client_states(ids).rng
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    # the JAX registry's own derivation, from the same key
    jr = jreg.ClientRegistry(_sources("pool")[0], 8, 2, None)
    jr._init_rng = jkey
    np.testing.assert_array_equal(got, jr._default_rng_rows(ids))


def test_gather_scatter_round_trips_bit_for_bit():
    reg, _ = _registry_with_proto()
    rows = reg.gather_client_states(np.asarray([2, 7, 2]))
    assert rows.params["h"].dtype == np.float32  # bf16 widened exactly
    # train: every row moves; pad slot 2 repeats client 2 and must not land
    r = np.random.default_rng(0)
    # (whole steps, so the bf16 leaf's values stay bf16 values)
    moved = ptu.tree_map(lambda a: (a + r.integers(1, 4, a.shape)).astype(a.dtype), rows)
    reg.scatter(np.asarray([2, 7, 2]), 2, moved, None)
    assert reg.dirty_rows == 2
    back = reg.gather_client_states(np.asarray([7, 2, 4]))
    for g, m in zip(ptu.tree_leaves(back), ptu.tree_leaves(moved)):
        np.testing.assert_array_equal(g[0], m[1])
        np.testing.assert_array_equal(g[1], m[0])
    fresh = reg.gather_client_states(np.asarray([4]))
    for g, f in zip(ptu.tree_leaves(back), ptu.tree_leaves(fresh)):
        np.testing.assert_array_equal(g[2], f[0])  # never stored: the prototype
    # to the device and back in the model's dtypes
    dev = treg.rows_to_device(back, reg.client_dtypes, torch.device("cpu"))
    assert dev.params["h"].dtype == torch.bfloat16 and dev.step.dtype == torch.int32
    again = treg.rows_to_host(dev)
    for g, a in zip(ptu.tree_leaves(back), ptu.tree_leaves(again)):
        np.testing.assert_array_equal(g, a)


def test_strategy_rows_round_trip_and_symmetric_check():
    reg, _ = _registry_with_proto()
    rows = {"residual": {"w": torch.zeros((3, 2, 3))}, "inner": None}
    reg.bind_strategy_rows(rows)
    assert reg.has_strategy_rows
    got = reg.gather_strategy_rows(np.asarray([1, 4]))
    assert got["inner"] is None and got["residual"]["w"].shape == (2, 2, 3)
    reg.scatter(np.asarray([1, 4]), 2, reg.gather_client_states(np.asarray([1, 4])),
                {"residual": {"w": np.full((2, 2, 3), 0.5, np.float32)}, "inner": None})
    np.testing.assert_array_equal(reg.gather_strategy_rows(np.asarray([4, 0]))["residual"]["w"],
                                  np.stack([np.full((2, 3), 0.5), np.zeros((2, 3))]))
    bad = {"residual": {"w": torch.arange(18.0).reshape(3, 2, 3)}, "inner": None}
    with pytest.raises(ValueError, match="state_rows must initialize every client "
                                         "identically"):
        reg.bind_strategy_rows(bad)
    jr = jreg.ClientRegistry(_sources("pool")[0], 8, 2, None)
    with pytest.raises(ValueError, match="state_rows must initialize every client "
                                         "identically"):
        jr.bind_strategy_rows({"residual": {"w": np.arange(18.0).reshape(3, 2, 3)},
                               "inner": None})
    empty = treg.ClientRegistry(_sources("pool")[1], 8, 2, None)
    empty.bind_strategy_rows({"residual": None, "inner": None})
    assert not empty.has_strategy_rows and empty.gather_strategy_rows(np.arange(2)) is None


def test_sources_refuse_what_jax_refuses():
    x, y = _pool(20)
    cases = [
        lambda m, s: m.IndexedPoolSource((x, y), (x, y), [np.arange(3)], []),
        lambda m, s: m.IndexedPoolSource((x, y), (x, y), [np.asarray([25])], [np.arange(2)]),
        lambda m, s: m.IndexedPoolSource((x, y), (x, y), [np.arange(0)], [np.arange(2)]),
        lambda m, s: m.ListDataSource([s.ClientDataset(x[:5], y[:5], x[5:8], y[5:8],
                                                       x[8:], y[8:])]),
        lambda m, s: m.ListDataSource([s.ClientDataset(x[:5], y[:4], x[5:8], y[5:8])]),
        lambda m, s: m.CohortConfig(slots=0),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(jreg, jsim)
        with pytest.raises(ValueError) as got:
            case(treg, tsim)
        assert str(got.value) == str(want.value)


def test_cohort_simulation_refuses_set_train_data():
    from fl4health_tpu_torch import optim
    from fl4health_tpu_torch.metrics import efficient
    from fl4health_tpu_torch.metrics.base import MetricManager
    from fl4health_tpu_torch.models.cnn import Mlp
    from fl4health_tpu_torch.strategies.fedavg import FedAvg

    x, y = _pool(40)
    x = x.reshape(40, -1)
    data = [tsim.ClientDataset(x[:16], y[:16], x[16:20], y[16:20]),
            tsim.ClientDataset(x[20:36], y[20:36], x[36:], y[36:])]
    sim = tsim.FederatedSimulation(
        logic=tengine.ClientLogic(tengine.from_module(Mlp(12, (8,), 10)),
                                  tengine.masked_cross_entropy),
        tx=optim.sgd(0.1), strategy=FedAvg(), datasets=data, batch_size=8,
        metrics=MetricManager((efficient.accuracy(),)), local_steps=1,
        cohort=treg.CohortConfig(slots=2), device="cpu")
    assert sim.registry.n_clients == 2 and sim.datasets == [] and sim.n_clients == 2
    with pytest.raises(ValueError, match="set_train_data swaps the dense device banks"):
        sim.set_train_data([d.x_train for d in data], [d.y_train for d in data])
