"""Datasets with the reference's cv2 loading semantics, NHWC (the port's own
copy of the plain, labelled and doodle datasets of sdm_tpu/data/datasets.py).

cv2.imread gives **BGR** uint8 HWC images, and the order is kept: the plot
writer un-permutes it as the reference does. `normalized=True` scales to
[-1, 1] as (x - 127.5) / 127.5; the trainers take `normalized=False` and
ship raw uint8 pixels, which the train step normalizes on the device with
the same arithmetic. Labelled and doodle datasets read the reference's
TinyDB JSON files and shuffle once at construction, seeded.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sdm_tpu_torch.data.tinydb_compat import read_tables


def _imread_u8(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cv2 failed to read image: {path}")
    return img  # HWC, BGR, uint8


def _norm(img_u8: np.ndarray) -> np.ndarray:
    return (img_u8.astype(np.float32) - 127.5) / 127.5  # [-1, 1]


def _imread_norm(path: str) -> np.ndarray:
    """cv2.imread's BGR image in [-1, 1] (the eval CLI's loader)."""
    return _norm(_imread_u8(path))


class _DecodeCache:
    """Optional in-RAM cache of decoded uint8 images (config
    "cache_dataset"); returns raw uint8 or [-1, 1] floats."""

    def __init__(self, enabled: bool, normalized: bool = True):
        self.enabled = enabled
        self.normalized = normalized
        self._cache = {}

    def norm_batch(self, arr: np.ndarray) -> np.ndarray:
        """A whole uint8 batch (the native decoder's output) under this
        cache's normalization, the same arithmetic as `read`."""
        return _norm(arr) if self.normalized else arr

    def read(self, path: str) -> np.ndarray:
        img = self._cache.get(path) if self.enabled else None
        if img is None:
            img = _imread_u8(path)
            if self.enabled:
                self._cache[path] = img
        return _norm(img) if self.normalized else img


class ImageDataset:
    """Plain list-of-paths image dataset."""

    def __init__(self, img_paths: Sequence[str] = (),
                 return_filepaths: bool = False,
                 cache_decoded: bool = False, normalized: bool = True):
        self.img_paths = list(img_paths)
        self.return_filepaths = return_filepaths
        self._cache = _DecodeCache(cache_decoded, normalized)

    def __len__(self) -> int:
        return len(self.img_paths)

    def __getitem__(self, index: int):
        path = self.img_paths[index]
        img = self._cache.read(path)
        if self.return_filepaths:
            return {"image": img, "path": path}
        return {"image": img}

    def batch_paths(self, indices):
        """The loader's plan for a natively decoded batch (data/native.py):
        ({field: [image paths]}, {field: [plain values]}), or None when
        the batch must go through __getitem__ (the RAM cache is on: its
        decode-once semantics would be bypassed)."""
        if self._cache.enabled:
            return None
        paths = [self.img_paths[i] for i in indices]
        extras = {"path": paths} if self.return_filepaths else {}
        return {"image": paths}, extras


class ConditionalImgDataset:
    """TinyDB-backed labelled dataset: table `Data` rows carry `filename`
    and one float field per label name of table `Labels`."""

    def __init__(self, dataset_path: Optional[str] = None,
                 seed: Optional[int] = None, cache_decoded: bool = False,
                 normalized: bool = True):
        tables = read_tables(dataset_path)
        data_rows = tables.get("Data", [])
        if len(data_rows) <= 0:
            raise Exception("No data found in Data table.")
        label_rows = tables.get("Labels", [])
        if len(label_rows) <= 0:
            raise Exception("No data found in Labels table.")
        self.all_labels: List[str] = label_rows[0]["labels"]
        rng = random.Random(seed)
        rng.shuffle(data_rows)  # the reference's initial shuffle
        self.dataset: List[Tuple[str, List[float]]] = [
            (row["filename"], [float(row[lbl]) for lbl in self.all_labels])
            for row in data_rows]
        self._cache = _DecodeCache(cache_decoded, normalized)

    def get_labels(self) -> List[str]:
        return self.all_labels

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int):
        path, labels = self.dataset[index]
        return {"image": self._cache.read(path),
                "labels": np.asarray(labels, dtype=np.float32)}

    def batch_paths(self, indices):
        """See ImageDataset.batch_paths."""
        if self._cache.enabled:
            return None
        rows = [self.dataset[i] for i in indices]
        return ({"image": [p for p, _ in rows]},
                {"labels": [np.asarray(lb, dtype=np.float32)
                            for _, lb in rows]})


class DoodleImgDataset:
    """TinyDB-backed image/conditioning-image pairs: each `Data` row maps
    `filename` to the path of its conditioning (doodle) image, stored under
    the first label name of table `Labels`."""

    def __init__(self, dataset_path: Optional[str] = None,
                 seed: Optional[int] = None, cache_decoded: bool = False,
                 normalized: bool = True):
        tables = read_tables(dataset_path)
        data_rows = tables.get("Data", [])
        if len(data_rows) <= 0:
            raise Exception("No data found in Data table.")
        label_rows = tables.get("Labels", [])
        if len(label_rows) <= 0:
            raise Exception("No data found in Labels table.")
        self.all_labels: List[str] = label_rows[0]["labels"]
        rng = random.Random(seed)
        rng.shuffle(data_rows)
        label = self.all_labels[0]
        self.dataset: List[Tuple[str, str]] = [
            (row["filename"], row[label]) for row in data_rows]
        self._cache = _DecodeCache(cache_decoded, normalized)

    def get_labels(self) -> List[str]:
        return self.all_labels

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int):
        img_path, cond_path = self.dataset[index]
        return {"image": self._cache.read(img_path),
                "cond_img": self._cache.read(cond_path)}

    def batch_paths(self, indices):
        """See ImageDataset.batch_paths."""
        if self._cache.enabled:
            return None
        rows = [self.dataset[i] for i in indices]
        return ({"image": [p for p, _ in rows],
                 "cond_img": [c for _, c in rows]}, {})
