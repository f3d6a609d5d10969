"""Host-side batched loader with batched decode and batch prefetch (port
of sdm_tpu/data/loader.py).

A whole batch is decoded by the native C++ decoder (csrc/sdm_decode.cc
through data/native.py) straight into one contiguous NHWC array, engaged
only where its canary decode is bit-identical to cv2 (`native_decode`,
default True); otherwise, and for datasets whose RAM cache is on, the
images are decoded on a thread pool (cv2 releases the GIL) and stacked. A
small queue keeps `prefetch` batches ready. Batch shapes are static
(`drop_last` defaults to True for training). The shuffle is a
`random.Random(seed)` permutation per epoch, as in sdm_tpu, so a seed
gives the same batch order in both packages.

On a data-parallel run a loader may keep only some positions of each batch
(`rows`, this rank's share; the order stays the whole batch's), and a
multi-host rank reads its `DatasetShard`.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np


def _collate(samples) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = (np.stack(vals) if isinstance(vals[0], np.ndarray)
                    else vals)
    return out


class DatasetShard:
    """Per-process view of a dataset for multi-host training (port of
    sdm_tpu/data/loader.py:38-62): a fixed index subset (the strided split
    of parallel/multihost.py::shard_indices, truncated so every process
    has the same length). Other attributes (e.g. get_labels) delegate to
    the base."""

    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = list(indices)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._dataset[self._indices[i]]

    def batch_paths(self, indices):
        # Translates shard-local indices first: the __getattr__ fallback
        # would hand the base dataset the wrong rows.
        bp = getattr(self._dataset, "batch_paths", None)
        if bp is None:
            return None
        return bp([self._indices[i] for i in indices])

    def __getattr__(self, name):
        return getattr(self._dataset, name)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, drop_last: bool = True,
                 prefetch: int = 2, seed: Optional[int] = None,
                 native_decode: bool = True,
                 rows: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = (min(batch_size, len(dataset)) if len(dataset)
                           else batch_size)
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last and len(dataset) >= batch_size
        self.prefetch = prefetch
        self._rng = random.Random(seed)
        # The positions of each batch this loader decodes and yields.
        self.rows = None if rows is None else list(rows)
        # Native batched decode: engaged while native.available() holds;
        # a batch it fails on turns it off for this loader (logged once).
        self._native = bool(native_decode)
        self._native_dims: dict = {}

    def _native_batch(self, indices) -> Optional[dict]:
        """One batch decoded natively, or None for the per-image path."""
        if not self._native:
            return None
        bp = getattr(self.dataset, "batch_paths", None)
        if bp is None:
            return None
        try:
            from sdm_tpu_torch.data import native
            if not native.available():
                self._native = False
                return None
            plan = bp(indices)
            if plan is None:
                return None
            img_fields, extras = plan
            out = {}
            for key, paths in img_fields.items():
                if key not in self._native_dims:
                    self._native_dims[key] = native.probe(paths[0])
                h, w = self._native_dims[key]
                arr = native.decode_batch(paths, h, w,
                                          num_threads=self.num_workers)
                # The per-image path's normalization (uint8 or [-1, 1]).
                out[key] = self.dataset._cache.norm_batch(arr)
            for key, vals in extras.items():
                out[key] = (np.stack(vals)
                            if isinstance(vals[0], np.ndarray) else vals)
            return out
        except Exception as e:
            logging.info(f"native decode failed ({e}); using Python loader")
            self._native = False
            return None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(idx)
        batches = []
        for i in range(0, len(idx), self.batch_size):
            b = idx[i:i + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                continue
            if self.rows is not None:
                b = [b[i] for i in self.rows]
            batches.append(b)
        return batches

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        if not batches:
            return iter(())
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # Gives up once the consumer abandoned the epoch (an early break),
            # so the producer thread can exit.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        batch = self._native_batch(b)
                        if batch is None:
                            batch = _collate(list(pool.map(
                                self.dataset.__getitem__, b)))
                        if not _put(batch):
                            return
            except Exception as e:  # surface decode errors to the consumer
                _put(e)
            finally:
                _put(sentinel)

        threading.Thread(target=produce, daemon=True).start()

        def gen():
            try:
                while True:
                    item = q.get()
                    if item is sentinel:
                        break
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()
        return gen()
