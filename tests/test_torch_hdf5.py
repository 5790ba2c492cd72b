"""The port's minimal HDF5 IO (onepose_tpu_torch/utils/hdf5.py) against
h5py, on the CPU: files it writes read the same through h5py, and files
h5py writes (its default format: nested groups, groups of a thousand
members whose B-trees have more than one level, every numeric dtype SfM
writes, empty datasets, object headers continued after creation) read
the same through it. Arrays, dtypes and member names exactly equal."""
import h5py
import numpy as np
import pytest

from onepose_tpu_torch.utils import hdf5

DTYPES = ("float32", "float64", "int32", "int64", "uint8", "int16")


def _tree(rng):
    """{path: array} of nested image-like groups and a wide flat group."""
    out = {}
    for i in range(150):
        base = f"/data/obj/seq-{i % 3}/color/{i}.png"
        n = int(rng.integers(0, 9))
        out[base + "/keypoints"] = rng.uniform(0, 512, (n, 2)).astype(
            np.float32)
        out[base + "/descriptors"] = rng.normal(size=(16, n)).astype(
            np.float32)
        out[base + "/image_size"] = np.array([512, 384])
    for i in range(1000):
        out[f"pair-{i}_x/matches0"] = rng.integers(-1, 50, 7).astype(
            DTYPES[i % len(DTYPES)])
    out["scalars/f64"] = np.linspace(0, 1, 13).reshape(13, 1)
    return out


def _read_all(f, tree):
    return {p: f[p][()] for p in tree}


def _assert_same(got, ref):
    assert got.keys() == ref.keys()
    for p in ref:
        assert got[p].dtype == ref[p].dtype and got[p].shape == ref[p].shape
        np.testing.assert_array_equal(got[p], ref[p], err_msg=p)


def test_written_files_read_the_same_through_h5py(tmp_path):
    tree = _tree(np.random.default_rng(0))
    path = str(tmp_path / "ours.h5")
    with hdf5.File(path, "w") as f:
        for p, arr in tree.items():
            f.create_dataset(p, data=arr)
        # a dataset just written reads back
        np.testing.assert_array_equal(f["scalars/f64"][()], tree["scalars/f64"])
    with h5py.File(path, "r") as f:
        _assert_same(_read_all(f, tree), tree)
        assert len(f) == 1002 and len(f["data/obj/seq-1/color"]) == 50
        assert list(f["data/obj/seq-0/color/0.png"]) == [
            "descriptors", "image_size", "keypoints"]
    with hdf5.File(path, "r") as f:
        _assert_same(_read_all(f, tree), tree)
        assert list(f) == list(h5py.File(path, "r"))


def test_h5py_files_read_the_same(tmp_path):
    tree = _tree(np.random.default_rng(1))
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w") as f:
        for p, arr in tree.items():
            f.create_dataset(p, data=arr)
        # attributes added after creation continue the object header
        for k in range(40):
            f["scalars/f64"].attrs[f"note{k}"] = np.arange(20)
    with hdf5.File(path, "r") as f:
        _assert_same(_read_all(f, tree), tree)
        assert "pair-999_x" in f and "pair-1000_x" not in f
        assert "data/obj/seq-2/color/5.png/keypoints" in f
        g = f["data"]["obj"]["seq-2"]["color"]
        assert len(g) == 50 and list(g) == sorted(g, key=str.encode)
        with pytest.raises(KeyError):
            f["data/missing"]


def test_refusals(tmp_path):
    path = str(tmp_path / "x.h5")
    with hdf5.File(path, "w") as f:
        f.create_group("/a/b")
        with pytest.raises(ValueError):
            f.create_group("a/b")
        with pytest.raises(NotImplementedError):
            f.create_dataset("a/s", data=np.array(["text"]))
    with hdf5.File(path, "r") as f:
        assert list(f["a"]) == ["b"] and len(f["a/b"]) == 0
        with pytest.raises(OSError):
            f.create_group("c")
    with open(tmp_path / "y.h5", "wb") as fh:
        fh.write(b"not hdf5" * 20)
    with pytest.raises(OSError):
        hdf5.File(str(tmp_path / "y.h5"))
