"""The port's native batched decoder (sdm_tpu_torch/csrc/sdm_decode.cc +
data/native.py) against cv2.imread and against sdm_tpu's: tests/
test_native_decode.py's cases on the port's modules (bit-identical to cv2
across formats and variants; the loader's native path yields exactly the
per-image path's batches, through a DatasetShard and with the RAM cache;
a file it cannot decode falls back), and both packages' loaders yielding
identical batches."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from sdm_tpu.data.datasets import ImageDataset as JaxImageDataset  # noqa: E402
from sdm_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from sdm_tpu_torch.data import native  # noqa: E402
from sdm_tpu_torch.data.datasets import (  # noqa: E402
    ConditionalImgDataset, DoodleImgDataset, ImageDataset)
from sdm_tpu_torch.data.loader import DataLoader, DatasetShard  # noqa: E402
from sdm_tpu_torch.data.tinydb_compat import write_tables  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason="native decoder unavailable (g++/libjpeg/libpng or canary)")


def _write_variants(d):
    """One file per decode variant cv2 handles; returns the paths."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    rgba = rng.integers(0, 256, (24, 32, 4), dtype=np.uint8)
    paths = {}
    paths["jpg_color"] = str(d / "c.jpg")
    cv2.imwrite(paths["jpg_color"], img, [cv2.IMWRITE_JPEG_QUALITY, 85])
    paths["jpg_gray"] = str(d / "g.jpg")
    cv2.imwrite(paths["jpg_gray"], gray)
    paths["png_color"] = str(d / "c.png")
    cv2.imwrite(paths["png_color"], img)
    paths["png_gray"] = str(d / "g.png")
    cv2.imwrite(paths["png_gray"], gray)
    paths["png_alpha"] = str(d / "a.png")
    cv2.imwrite(paths["png_alpha"], rgba)
    return paths


def test_native_decode_bit_identical_to_cv2(tmp_path):
    paths = _write_variants(tmp_path)
    plist = list(paths.values())
    ours = native.decode_batch(plist, 24, 32)
    for i, p in enumerate(plist):
        assert np.array_equal(ours[i], cv2.imread(p)), p


def test_native_probe_and_errors(tmp_path):
    paths = _write_variants(tmp_path)
    assert native.probe(paths["jpg_color"]) == (24, 32)
    assert native.probe(paths["png_alpha"]) == (24, 32)
    with pytest.raises(RuntimeError, match="size"):
        native.decode_batch([paths["jpg_color"]], 8, 8)
    with pytest.raises(RuntimeError, match="cannot open"):
        native.decode_batch([str(tmp_path / "missing.png")], 24, 32)
    bad = str(tmp_path / "bad.dat")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    with pytest.raises(RuntimeError, match="unsupported"):
        native.decode_batch([bad], 24, 32)


def _mk_imgs(d, n=10, hw=16, ext="png"):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        p = str(d / f"im_{i}.{ext}")
        cv2.imwrite(p, rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8))
        paths.append(p)
    return paths


@pytest.mark.parametrize("normalized", [False, True])
def test_loader_native_path_matches_python_path(tmp_path, normalized):
    paths = _mk_imgs(tmp_path, ext="jpg")
    batches = {}
    for nat in (False, True):
        ds = ImageDataset(img_paths=paths, normalized=normalized)
        dl = DataLoader(ds, batch_size=4, shuffle=True, seed=5,
                        native_decode=nat)
        batches[nat] = list(dl)
        assert dl._native == nat
    assert len(batches[False]) == len(batches[True]) == 2
    for a, b in zip(batches[False], batches[True]):
        assert a["image"].dtype == b["image"].dtype
        np.testing.assert_array_equal(a["image"], b["image"])


def test_loader_native_conditional_and_doodle(tmp_path):
    paths = _mk_imgs(tmp_path, n=6)
    rows = [{"filename": p, "a": float(i % 2), "b": 1.0 - (i % 2)}
            for i, p in enumerate(paths)]
    db = str(tmp_path / "db.json")
    write_tables(db, {"Labels": [{"labels": ["a", "b"]}], "Data": rows})
    got = {}
    for nat in (False, True):
        ds = ConditionalImgDataset(dataset_path=db, seed=1, normalized=False)
        got[nat] = list(DataLoader(ds, batch_size=3, shuffle=False,
                                   native_decode=nat))
    for a, b in zip(got[False], got[True]):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["labels"], b["labels"])

    drows = [{"filename": paths[i], "doodle": paths[(i + 1) % 6]}
             for i in range(6)]
    ddb = str(tmp_path / "ddb.json")
    write_tables(ddb, {"Labels": [{"labels": ["doodle"]}], "Data": drows})
    outs = {}
    for nat in (False, True):
        ds = DoodleImgDataset(dataset_path=ddb, seed=2, normalized=False)
        outs[nat] = list(DataLoader(ds, batch_size=3, shuffle=False,
                                    native_decode=nat))
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["cond_img"], b["cond_img"])


def test_loader_native_respects_shard_rows_and_cache(tmp_path):
    """A DatasetShard translates its indices before the plan, a loader's
    `rows` (a data-parallel rank's share) keep their positions, and the
    RAM cache opts out (decode-once semantics)."""
    paths = _mk_imgs(tmp_path, n=8)
    ds = ImageDataset(img_paths=paths, normalized=False)
    shard = DatasetShard(ds, [1, 3, 5, 7])
    a = list(DataLoader(shard, batch_size=4, shuffle=False,
                        native_decode=True))[0]
    b = list(DataLoader(shard, batch_size=4, shuffle=False,
                        native_decode=False))[0]
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["image"][0], cv2.imread(paths[1]))
    rows = list(DataLoader(ds, batch_size=4, shuffle=True, seed=3,
                           native_decode=True, rows=[1, 3]))
    whole = list(DataLoader(ds, batch_size=4, shuffle=True, seed=3,
                            native_decode=False))
    for r, w in zip(rows, whole):
        np.testing.assert_array_equal(r["image"], w["image"][[1, 3]])

    cached = ImageDataset(img_paths=paths, cache_decoded=True,
                          normalized=False)
    assert cached.batch_paths([0, 1]) is None
    got = list(DataLoader(cached, batch_size=4, shuffle=False,
                          native_decode=True))
    assert len(cached._cache._cache) == 8
    np.testing.assert_array_equal(got[0]["image"][0], cv2.imread(paths[0]))


def test_loader_falls_back_when_native_cannot_decode(tmp_path):
    """A format the C++ decoder rejects (webp): the loader catches the
    native failure, turns it off, and the per-image path serves the
    batch."""
    paths = _mk_imgs(tmp_path, n=3)
    rng = np.random.default_rng(9)
    wp = str(tmp_path / "im_3.webp")
    assert cv2.imwrite(wp, rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    paths.append(wp)
    ds = ImageDataset(img_paths=paths, normalized=False)
    dl = DataLoader(ds, batch_size=4, shuffle=False, native_decode=True)
    got = list(dl)[0]
    assert dl._native is False
    np.testing.assert_array_equal(got["image"][3], cv2.imread(wp))


def test_loader_native_return_filepaths(tmp_path):
    paths = _mk_imgs(tmp_path, n=4)
    ds = ImageDataset(img_paths=paths, return_filepaths=True,
                      normalized=False)
    got = list(DataLoader(ds, batch_size=2, shuffle=False,
                          native_decode=True))[0]
    assert got["path"] == paths[:2]
    np.testing.assert_array_equal(got["image"][1], cv2.imread(paths[1]))


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_both_packages_native_loaders_yield_the_same_batches(tmp_path, ext):
    """The port's loader and sdm_tpu's, both decoding natively with the
    same seed: the same batches, bit for bit, in the same order; the
    library is the port's own build, beside sdm_tpu's."""
    paths = _mk_imgs(tmp_path, n=9, ext=ext)
    port = list(DataLoader(ImageDataset(img_paths=paths, normalized=False),
                           batch_size=4, shuffle=True, seed=11))
    jax = list(JaxDataLoader(JaxImageDataset(img_paths=paths,
                                             normalized=False),
                             batch_size=4, shuffle=True, seed=11))
    assert len(port) == len(jax) == 2
    for a, b in zip(port, jax):
        assert a["image"].dtype == b["image"].dtype == np.uint8
        np.testing.assert_array_equal(a["image"], b["image"])
    assert os.path.dirname(native.library_path()).endswith(
        os.path.join("sdm_tpu_torch", "csrc", "build"))
