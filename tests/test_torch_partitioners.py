"""The port's data preparation against the JAX package: the Dirichlet
partitioner, the label-based samplers, the train/val split,
``federated_client_datasets`` and the on-disk loaders give arrays equal to
JAX's from the same inputs and hash keys."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import gzip
import pickle
import struct

import numpy as np
import pytest

from fl4health_tpu.datasets import partitioners as jpart
from fl4health_tpu.datasets import samplers as jsamp
from fl4health_tpu.datasets import vision as jvision
from fl4health_tpu_torch.datasets import partitioners as tpart
from fl4health_tpu_torch.datasets import samplers as tsamp
from fl4health_tpu_torch.datasets import vision as tvision
from fl4health_tpu_torch.server.simulation import ClientDataset


def _pool(n=600, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, 4, 4, 1)).astype(np.float32)
    y = r.integers(0, 10, size=n).astype(np.int32)
    return x, y


def _assert_pairs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(beta=0.8, min_label_examples=1, hash_key=42),
    dict(beta=100.0, hash_key=3),
    dict(prior_distribution={c: [1.0, 2.0, 3.0, 4.0] for c in range(10)}, hash_key=5),
], ids=["beta0.8_min1", "beta100", "prior"])
def test_dirichlet_partitions_match_jax(kw):
    x, y = _pool()
    args = dict(number_of_partitions=4, unique_labels=list(range(10)), **kw)
    got, gp = tpart.DirichletLabelBasedAllocation(**args).partition_dataset(x, y)
    want, wp = jpart.DirichletLabelBasedAllocation(**args).partition_dataset(x, y)
    _assert_pairs_equal(got, want)
    assert set(gp) == set(wp)
    for k in wp:
        np.testing.assert_array_equal(gp[k], wp[k])


def test_dirichlet_retry_exhaustion_raises_like_jax():
    x, y = _pool(60)
    args = dict(number_of_partitions=6, unique_labels=list(range(10)), beta=0.05,
                min_label_examples=5, hash_key=1)
    with pytest.raises(ValueError) as want:
        jpart.DirichletLabelBasedAllocation(**args).partition_dataset(x, y, max_retries=2)
    with pytest.raises(ValueError) as got:
        tpart.DirichletLabelBasedAllocation(**args).partition_dataset(x, y, max_retries=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,kw", [
    ("MinorityLabelBasedSampler", dict(downsampling_ratio=0.2, minority_labels={1, 3},
                                       hash_key=4)),
    ("DirichletLabelBasedSampler", dict(hash_key=9, sample_percentage=0.5, beta=0.5)),
    ("DirichletLabelBasedSampler", dict(hash_key=2, sample_percentage=0.75, beta=100)),
])
def test_samplers_match_jax(name, kw):
    x, y = _pool()
    got = getattr(tsamp, name)(list(range(10)), **kw).subsample(x, y)
    want = getattr(jsamp, name)(list(range(10)), **kw).subsample(x, y)
    _assert_pairs_equal([got], [want])


@pytest.mark.parametrize("hash_key", [None, 7])
def test_split_data_and_targets(hash_key):
    x, y = _pool(101)
    if hash_key is None:  # an unseeded split differs run to run; check sizes only
        got = tvision.split_data_and_targets(x, y, 0.2)
        assert [a.shape[0] for a in got] == [80, 80, 21, 21]
        return
    _assert_pairs_equal([tvision.split_data_and_targets(x, y, 0.3, hash_key)],
                        [jvision.split_data_and_targets(x, y, 0.3, hash_key)])


@pytest.mark.parametrize("mode", ["partitioner", "sampler", "shards"])
def test_federated_client_datasets_match_jax(mode):
    x, y = _pool()
    kw = {}
    if mode == "partitioner":
        make = lambda m: m.DirichletLabelBasedAllocation(  # noqa: E731
            number_of_partitions=4, unique_labels=list(range(10)), beta=0.8,
            min_label_examples=1, hash_key=42)
        got = tvision.federated_client_datasets(x, y, 4, partitioner=make(tpart), hash_key=7)
        want = jvision.federated_client_datasets(x, y, 4, partitioner=make(jpart), hash_key=7)
    else:
        if mode == "sampler":
            kw = dict(validation_proportion=0.25)
        make_s = (lambda m: m.MinorityLabelBasedSampler(  # noqa: E731
            list(range(10)), 0.5, {0, 2}, hash_key=1)) if mode == "sampler" else None
        got = tvision.federated_client_datasets(
            x, y, 5, sampler=make_s(tsamp) if make_s else None, hash_key=3, **kw)
        want = jvision.federated_client_datasets(
            x, y, 5, sampler=make_s(jsamp) if make_s else None, hash_key=3, **kw)
    assert all(isinstance(d, ClientDataset) for d in got)
    _assert_pairs_equal([(d.x_train, d.y_train, d.x_val, d.y_val) for d in got],
                        [(d.x_train, d.y_train, d.x_val, d.y_val) for d in want])


def _write_idx(path, arr, code):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, code, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(">u1" if code == 0x08 else arr.dtype).tobytes())


@pytest.mark.parametrize("layout", ["idx", "idx_gz_raw", "npz"])
def test_load_mnist_matches_jax(tmp_path, layout):
    r = np.random.default_rng(0)
    images = r.integers(0, 256, size=(5, 28, 28)).astype(np.uint8)
    labels = r.integers(0, 10, size=5).astype(np.uint8)
    if layout == "npz":
        np.savez(tmp_path / "mnist.npz", x_train=images, y_train=labels,
                 x_test=images[:2], y_test=labels[:2])
    else:
        base, ext = ((tmp_path / "MNIST" / "raw", ".gz") if layout == "idx_gz_raw"
                     else (tmp_path, ""))
        base.mkdir(parents=True, exist_ok=True)
        for prefix in ("train", "t10k"):
            _write_idx(base / f"{prefix}-images-idx3-ubyte{ext}", images, 0x08)
            _write_idx(base / f"{prefix}-labels-idx1-ubyte{ext}", labels, 0x08)
    for train in (True, False):
        got = tvision.load_mnist_arrays(tmp_path, train)
        want = jvision.load_mnist_arrays(tmp_path, train)
        _assert_pairs_equal([got], [want])
        assert got[0].shape[1:] == (28, 28, 1) and got[0].dtype == np.float32


def test_load_cifar10_matches_jax(tmp_path):
    r = np.random.default_rng(1)
    batch_dir = tmp_path / "cifar-10-batches-py"
    batch_dir.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(batch_dir / name, "wb") as f:
            pickle.dump({b"data": r.integers(0, 256, size=(3, 3072)).astype(np.uint8),
                         b"labels": list(r.integers(0, 10, size=3))}, f)
    for train in (True, False):
        got = tvision.load_cifar10_arrays(tmp_path, train)
        _assert_pairs_equal([got], [jvision.load_cifar10_arrays(tmp_path, train)])
        assert got[0].shape == ((15 if train else 3), 32, 32, 3)


def test_loaders_raise_without_data(tmp_path):
    with pytest.raises(FileNotFoundError):
        tvision.load_mnist_arrays(tmp_path)
    with pytest.raises(FileNotFoundError):
        tvision.load_cifar10_arrays(tmp_path)


def test_synthetic_arrays_shapes_and_determinism():
    x, y = tvision.synthetic_mnist_arrays(16, seed=3)
    assert x.shape == (16, 28, 28, 1) and y.shape == (16,) and x.dtype == np.float32
    np.testing.assert_array_equal(x, tvision.synthetic_mnist_arrays(16, seed=3)[0])
    x, y = tvision.synthetic_cifar_arrays(8, seed=1)
    assert x.shape == (8, 32, 32, 3) and y.dtype == np.int32 and set(y) <= set(range(10))
