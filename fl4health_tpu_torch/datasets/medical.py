"""Medical dataset readers (counterpart of ``fl4health_tpu/datasets/medical.py``,
a copy of its numpy code): rxrx1 (metadata.csv-driven per-image loading
with site-based client splits), the skin-cancer centres (per-centre CSV or
JSON manifests and image folders) and MSD volumes (an nnU-Net-style
``dataset.json`` with imagesTr/labelsTr pairs).

Readers only: the arrays land in host numpy, which the simulation stacks;
nothing is downloaded, and a missing directory raises ``FileNotFoundError``.
Volumes load from .npy/.npz; NIfTI through ``nibabel`` and images through
PIL, each imported only where such a file is read.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Sequence

import numpy as np


def _load_image_array(path: Path) -> np.ndarray:
    """Load one image/volume array: .npy/.npz natively; .png/.jpg when a
    decoder (PIL) is available; .nii/.nii.gz when nibabel is available."""
    suffix = "".join(path.suffixes)
    if path.suffix == ".npy":
        return np.load(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return z[list(z.keys())[0]]
    if suffix.endswith((".nii", ".nii.gz")):
        try:
            import nibabel as nib  # gated: not in the base image
        except ImportError as e:
            raise ImportError(
                f"{path}: NIfTI volumes need nibabel, which is not installed; "
                "convert to .npy/.npz"
            ) from e
        return np.asanyarray(nib.load(str(path)).dataobj)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: image decoding needs PIL; convert to .npy/.npz"
        ) from e
    return np.asarray(Image.open(path))


def _normalize_image(arr: np.ndarray) -> np.ndarray:
    """Integer-typed images scale by 255; float images pass through. Decided
    from dtype, never per-image content — a nearly-black uint8 frame must not
    end up 255x hotter than its neighbors."""
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)


# ---------------------------------------------------------------------------
# rxrx1 — fluorescence microscopy, site-partitioned (rxrx1/load_data.py:121)
# ---------------------------------------------------------------------------

def load_rxrx1_data(
    data_dir: Path | str,
    client_site: int | None = None,
    train: bool = True,
) -> tuple[np.ndarray, np.ndarray, dict[str, Any]]:
    """-> (images [N,H,W,C] float32 in [0,1], labels [N] int32, info).

    Expects the reference's layout: ``metadata.csv`` with columns
    ``well_id,site,dataset,sirna_id`` (+ optional ``path``) and per-well
    arrays under ``images/<well_id>.npy`` (or the path column). ``site``
    selects the federated client (the reference partitions rxrx1 by
    experiment site); ``dataset`` in {train, test} selects the split.
    """
    data_dir = Path(data_dir)
    meta_path = data_dir / "metadata.csv"
    if not meta_path.exists():
        raise FileNotFoundError(f"rxrx1: no metadata.csv under {data_dir}")
    want_split = "train" if train else "test"
    rows, all_labels = [], set()
    with open(meta_path) as f:
        for row in csv.DictReader(f):
            # the label space comes from the FULL metadata (every site, every
            # split) — federated clients must agree on class indices even
            # when a site is missing some sirnas locally
            all_labels.add(int(row["sirna_id"]))
            if row.get("dataset", "train") != want_split:
                continue
            if client_site is not None and int(row["site"]) != client_site:
                continue
            rows.append(row)
    if not rows:
        raise FileNotFoundError(
            f"rxrx1: no rows for split={want_split} site={client_site}"
        )
    images, labels = [], []
    for row in rows:
        rel = row.get("path") or f"images/{row['well_id']}.npy"
        images.append(_normalize_image(_load_image_array(data_dir / rel)))
        labels.append(int(row["sirna_id"]))
    x = np.stack(images)
    if x.ndim == 3:
        x = x[..., None]
    classes = sorted(all_labels)
    remap = {c: i for i, c in enumerate(classes)}
    y = np.asarray([remap[v] for v in labels], np.int32)
    return x, y, {"n_classes": len(classes), "sirna_ids": classes}


# ---------------------------------------------------------------------------
# Skin cancer — ISIC-family per-center manifests (datasets/skin_cancer/*)
# ---------------------------------------------------------------------------

SKIN_CANCER_CENTERS = ("isic_2019", "ham10000", "pad_ufes_20", "derm7pt")


def _read_manifest(center_dir: Path, split: str) -> list[dict[str, Any]]:
    csv_path = center_dir / f"{split}.csv"
    json_path = center_dir / f"{split}.json"
    if csv_path.exists():
        with open(csv_path) as f:
            return list(csv.DictReader(f))
    if json_path.exists():
        with open(json_path) as f:
            return json.load(f)
    raise FileNotFoundError(
        f"skin-cancer: no {split}.csv/.json manifest under {center_dir}"
    )


def _record_label(rec: dict[str, Any], label_column: str, source: Path) -> str:
    label = rec.get(label_column, rec.get("label"))
    if label is None:
        raise KeyError(
            f"{source}: record {rec.get('image', rec)!r} has neither "
            f"{label_column!r} nor 'label' — refusing to invent a class"
        )
    return str(label)


def load_skin_cancer_data(
    data_dir: Path | str,
    center: str,
    train: bool = True,
    label_column: str = "diagnosis",
    classes: Sequence[str] | None = None,
) -> tuple[np.ndarray, np.ndarray, dict[str, Any]]:
    """-> (images [N,H,W,3] float32 in [0,1], labels [N] int32, info).

    Layout per center (the reference's preprocessed convention): a manifest
    ``<center>/<split>.csv`` (columns ``image``, ``<label_column>``) or
    ``<center>/<split>.json`` (list of {image, label} records), with image
    arrays resolved relative to the center directory.

    ``classes`` fixes the global label order for federated runs; when None
    it is derived from the UNION of every center manifest present under
    ``data_dir`` (both splits), so centers missing a diagnosis locally still
    agree on class indices.
    """
    data_dir = Path(data_dir)
    center_dir = data_dir / center
    split = "train" if train else "test"
    records = _read_manifest(center_dir, split)

    if classes is None:
        seen = set()
        for other in sorted(p for p in data_dir.iterdir() if p.is_dir()):
            for other_split in ("train", "test"):
                try:
                    for rec in _read_manifest(other, other_split):
                        seen.add(_record_label(rec, label_column, other))
                except FileNotFoundError:
                    continue
        classes = sorted(seen)
    else:
        classes = list(classes)

    images, labels = [], []
    for rec in records:
        images.append(_normalize_image(_load_image_array(center_dir / rec["image"])))
        labels.append(_record_label(rec, label_column, center_dir))
    remap = {c: i for i, c in enumerate(classes)}
    missing = sorted(set(labels) - set(classes))
    if missing:
        raise ValueError(
            f"skin-cancer: labels {missing} in {center} not in the class set {classes}"
        )
    return (
        np.stack(images),
        np.asarray([remap[v] for v in labels], np.int32),
        {"n_classes": len(classes), "classes": list(classes), "center": center},
    )


# ---------------------------------------------------------------------------
# MSD — Medical Segmentation Decathlon volumes (utils/load_data.py:288)
# ---------------------------------------------------------------------------

def load_msd_dataset(
    data_dir: Path | str, task: str | None = None
) -> dict[str, Any]:
    """-> {"volumes": [...], "segmentations": [...], "spacings": [...],
    "labels": {...}, "name": str}.

    Reads the nnU-Net-style ``dataset.json`` (keys ``name``, ``labels``,
    ``training``: [{image, label}]) the MSD tarballs ship; image/label paths
    resolve relative to the task directory. Spacings come from ``spacing``
    entries when present (else unit). Output feeds nnunet.extract_fingerprint
    / extract_patch_dataset directly.
    """
    data_dir = Path(data_dir)
    task_dir = data_dir / task if task else data_dir
    ds_json = task_dir / "dataset.json"
    if not ds_json.exists():
        raise FileNotFoundError(f"MSD: no dataset.json under {task_dir}")
    with open(ds_json) as f:
        desc = json.load(f)
    volumes, segs, spacings = [], [], []
    for case in desc.get("training", []):
        vol = _load_image_array(task_dir / case["image"]).astype(np.float32)
        seg = _load_image_array(task_dir / case["label"]).astype(np.int32)
        if vol.ndim == seg.ndim:  # channels-last expected by the planner
            vol = vol[..., None]
        volumes.append(vol)
        segs.append(seg)
        spacings.append(tuple(case.get("spacing", (1.0,) * seg.ndim)))
    return {
        "volumes": volumes,
        "segmentations": segs,
        "spacings": spacings,
        "labels": desc.get("labels", {}),
        "name": desc.get("name", task or data_dir.name),
    }
