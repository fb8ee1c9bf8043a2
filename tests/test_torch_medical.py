"""The port's medical readers (``fl4health_tpu_torch/datasets/medical.py``)
against JAX's on ``tests/datasets/test_medical.py``'s fixtures, written in
the real on-disk formats: every returned array and fact equal, and the
same errors."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import csv
import json

import numpy as np
import pytest

from fl4health_tpu.datasets import medical as jmed
from fl4health_tpu_torch.datasets import medical as tmed


def _equal(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


@pytest.fixture
def rxrx1_dir(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "images").mkdir()
    rows = []
    for i in range(12):
        well = f"well_{i:03d}"
        np.save(tmp_path / "images" / f"{well}.npy",
                rng.integers(0, 255, (8, 8, 3), dtype=np.uint8))
        rows.append({"well_id": well, "site": str(1 + i % 2),
                     "dataset": "train" if i < 9 else "test", "sirna_id": str(100 + i % 3)})
    with open(tmp_path / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return tmp_path


@pytest.mark.parametrize("site,train", [(1, True), (2, True), (None, False), (None, True)])
def test_rxrx1_matches(rxrx1_dir, site, train):
    _equal(jmed.load_rxrx1_data(rxrx1_dir, client_site=site, train=train),
           tmed.load_rxrx1_data(rxrx1_dir, client_site=site, train=train))


def test_skin_cancer_csv_and_json_centres_match(tmp_path):
    rng = np.random.default_rng(1)
    center = tmp_path / "ham10000"
    (center / "imgs").mkdir(parents=True)
    rows = []
    for i in range(6):
        name = f"imgs/im_{i}.npy"
        np.save(center / name, rng.integers(0, 255, (6, 6, 3), dtype=np.uint8))
        rows.append({"image": name, "diagnosis": ["mel", "nv", "bcc"][i % 3]})
    with open(center / "train.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "diagnosis"])
        w.writeheader()
        w.writerows(rows)
    derm = tmp_path / "derm7pt"
    derm.mkdir()
    np.save(derm / "a.npy", np.zeros((4, 4, 3), np.uint8))
    with open(derm / "test.json", "w") as f:
        json.dump([{"image": "a.npy", "label": "nv"}], f)
    _equal(jmed.load_skin_cancer_data(tmp_path, "ham10000", train=True),
           tmed.load_skin_cancer_data(tmp_path, "ham10000", train=True))
    _equal(jmed.load_skin_cancer_data(tmp_path, "derm7pt", train=False),
           tmed.load_skin_cancer_data(tmp_path, "derm7pt", train=False))


def test_msd_volumes_match_and_feed_the_port_planner(tmp_path):
    rng = np.random.default_rng(2)
    (tmp_path / "imagesTr").mkdir()
    (tmp_path / "labelsTr").mkdir()
    training = []
    for i in range(3):
        np.save(tmp_path / "imagesTr" / f"c{i}.npy",
                rng.normal(size=(10, 10, 10)).astype(np.float32))
        np.save(tmp_path / "labelsTr" / f"c{i}.npy",
                rng.integers(0, 2, (10, 10, 10)).astype(np.int32))
        training.append({"image": f"imagesTr/c{i}.npy", "label": f"labelsTr/c{i}.npy",
                         "spacing": [1.0, 1.0, 2.0]})
    with open(tmp_path / "dataset.json", "w") as f:
        json.dump({"name": "Task99_Tiny", "labels": {"0": "bg", "1": "fg"},
                   "training": training}, f)
    jds, tds = jmed.load_msd_dataset(tmp_path), tmed.load_msd_dataset(tmp_path)
    _equal(jds, tds)
    from fl4health_tpu_torch.nnunet import extract_fingerprint, generate_plans

    fp = extract_fingerprint(tds["volumes"], tds["spacings"], tds["segmentations"])
    assert "3d_fullres" in generate_plans(fp, dataset_name=tds["name"])["configurations"]


@pytest.mark.parametrize("call,match", [
    (lambda m, p: m.load_rxrx1_data(p / "nope"), None),
    (lambda m, p: m.load_skin_cancer_data(p, "isic_2019"), "manifest"),
    (lambda m, p: m.load_msd_dataset(p), "dataset.json"),
])
def test_missing_inputs_raise_alike(tmp_path, call, match):
    (tmp_path / "isic_2019").mkdir()
    for mod in (jmed, tmed):
        with pytest.raises(FileNotFoundError, match=match):
            call(mod, tmp_path)
