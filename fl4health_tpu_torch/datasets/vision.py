"""MNIST / CIFAR-10 loading and federated client-dataset construction
(counterpart of ``fl4health_tpu/datasets/vision.py``). The loaders read the
standard on-disk formats (IDX or a keras-style npz for MNIST, the
python-pickle batches or an npz for CIFAR-10) into numpy with the reference's
normalization ``(x/255 - 0.5)/0.5``; nothing is downloaded. The splitting
and partitioning code is the JAX package's numpy code, so both packages
build the same clients from the same arrays and hash keys, returned as the
port's ``ClientDataset``.

``synthetic_mnist_arrays`` and ``synthetic_cifar_arrays`` draw from the
port's ``synthetic_classification`` with ``PRNGKey(seed)``, as the JAX
functions do: the same labels, and images within ``rng.normal``'s 2 ulp.
"""

from __future__ import annotations

import gzip
import pickle
import struct
from pathlib import Path
from typing import Sequence

import numpy as np

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.datasets.samplers import LabelBasedSampler
from fl4health_tpu_torch.datasets.synthetic import synthetic_classification


# ---------------------------------------------------------------------------
# Raw format readers
# ---------------------------------------------------------------------------

def _read_idx(path: Path) -> np.ndarray:
    """Read an IDX-format file (the MNIST distribution format), .gz or raw."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:  # type: ignore[operator]
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path} is not an IDX file")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                  0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
        data = np.frombuffer(f.read(), dtype=dtypes[dtype_code])
        return data.reshape(shape)


def _find_first(data_dir: Path, names: Sequence[str]) -> Path | None:
    for name in names:
        p = data_dir / name
        if p.exists():
            return p
    return None


def load_mnist_arrays(data_dir: Path | str, train: bool = True
                      ) -> tuple[np.ndarray, np.ndarray]:
    """-> (images [N,28,28,1] float32 normalized to [-1,1], labels [N] int32).

    Accepts the IDX pair (``train-images-idx3-ubyte[.gz]`` /
    ``train-labels-idx1-ubyte[.gz]``, also under an ``MNIST/raw`` subdir as
    torchvision lays it out) or a keras-style ``mnist.npz``.
    """
    data_dir = Path(data_dir)
    prefix = "train" if train else "t10k"
    for base in (data_dir, data_dir / "MNIST" / "raw"):
        images = _find_first(base, [f"{prefix}-images-idx3-ubyte",
                                    f"{prefix}-images-idx3-ubyte.gz"])
        labels = _find_first(base, [f"{prefix}-labels-idx1-ubyte",
                                    f"{prefix}-labels-idx1-ubyte.gz"])
        if images is not None and labels is not None:
            x = _read_idx(images).astype(np.float32)
            y = _read_idx(labels).astype(np.int32)
            x = (x / 255.0 - 0.5) / 0.5  # the reference's Normalize((0.5),(0.5))
            return x[..., None], y
    npz = _find_first(data_dir, ["mnist.npz"])
    if npz is not None:
        with np.load(npz) as z:
            x = z["x_train" if train else "x_test"].astype(np.float32)
            y = z["y_train" if train else "y_test"].astype(np.int32)
        return ((x / 255.0 - 0.5) / 0.5)[..., None], y
    raise FileNotFoundError(
        f"No MNIST data found under {data_dir} (looked for IDX files and "
        "mnist.npz); synthetic_mnist_arrays gives a deterministic "
        "MNIST-shaped synthetic set instead."
    )


def load_cifar10_arrays(data_dir: Path | str, train: bool = True
                        ) -> tuple[np.ndarray, np.ndarray]:
    """-> (images [N,32,32,3] float32 normalized to [-1,1], labels [N] int32).

    Accepts the python-pickle distribution (``cifar-10-batches-py/``) or a
    ``cifar10.npz`` with x_train/y_train/x_test/y_test.
    """
    data_dir = Path(data_dir)
    batch_dir = data_dir / "cifar-10-batches-py"
    if not batch_dir.exists() and (data_dir / "data_batch_1").exists():
        batch_dir = data_dir
    if batch_dir.exists():
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        xs, ys = [], []
        for name in names:
            with open(batch_dir / name, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8))
            ys.append(np.asarray(d[b"labels"], np.int32))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.concatenate(ys)
        x = (x.astype(np.float32) / 255.0 - 0.5) / 0.5
        return x, y
    npz = _find_first(data_dir, ["cifar10.npz"])
    if npz is not None:
        with np.load(npz) as z:
            x = z["x_train" if train else "x_test"].astype(np.float32)
            y = z["y_train" if train else "y_test"].astype(np.int32)
        return (x / 255.0 - 0.5) / 0.5, y
    raise FileNotFoundError(
        f"No CIFAR-10 data found under {data_dir} (looked for "
        "cifar-10-batches-py/ and cifar10.npz)."
    )


# ---------------------------------------------------------------------------
# Splitting + federated construction
# ---------------------------------------------------------------------------

def split_data_and_targets(
    x: np.ndarray,
    y: np.ndarray,
    validation_proportion: float = 0.2,
    hash_key: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Reproducible train/val split: shuffle with the hash key, put the
    first (1-p) fraction in train."""
    n = x.shape[0]
    perm = np.random.default_rng(hash_key).permutation(n)
    n_train = int(n * (1 - validation_proportion))
    tr, va = perm[:n_train], perm[n_train:]
    return x[tr], y[tr], x[va], y[va]


def synthetic_mnist_arrays(
    n: int = 4096, seed: int = 0, class_sep: float = 2.0
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped stand-in (environments without the data)."""
    x, y = synthetic_classification(rng.PRNGKey(seed), n, (28, 28, 1), 10,
                                    class_sep=class_sep)
    return x.numpy(), y.numpy()


def synthetic_cifar_arrays(n: int = 4096, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic CIFAR-shaped stand-in."""
    x, y = synthetic_classification(rng.PRNGKey(seed), n, (32, 32, 3), 10)
    return x.numpy(), y.numpy()


def federated_client_datasets(
    x: np.ndarray,
    y: np.ndarray,
    n_clients: int,
    partitioner=None,
    sampler: LabelBasedSampler | None = None,
    validation_proportion: float = 0.2,
    hash_key: int | None = None,
):
    """Partition (or sampler-subsample) pooled data into per-client
    ``ClientDataset``s with reproducible train/val splits.

    - ``partitioner``: a DirichletLabelBasedAllocation — disjoint non-IID
      partitions.
    - ``sampler``: a LabelBasedSampler applied per client to i.i.d. shards.
    """
    from fl4health_tpu_torch.server.simulation import ClientDataset

    if partitioner is not None:
        parts = partitioner.partition_dataset(x, y)[0]
    else:
        shards = np.array_split(np.random.default_rng(hash_key).permutation(x.shape[0]),
                                n_clients)
        parts = [(x[s], y[s]) for s in shards]
        if sampler is not None:
            parts = [sampler.subsample(px, py) for px, py in parts]
    out = []
    for i, (px, py) in enumerate(parts):
        xt, yt, xv, yv = split_data_and_targets(
            px, py, validation_proportion,
            None if hash_key is None else hash_key + i,
        )
        out.append(ClientDataset(x_train=xt, y_train=yt, x_val=xv, y_val=yv))
    return out
