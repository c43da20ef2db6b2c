"""The port's HDF5 reader and writer (``modelimport/hdf5.py``, numpy and the
standard library) held against ``libhdf5``: files written by ``h5py`` and
by the JAX ``H5File`` (both over libhdf5) read back bitwise in the port,
and the port's files read back bitwise by both. ``h5py`` appears here only;
the port never imports it."""
import zlib

import h5py
import numpy as np
import pytest

from deeplearning4j_tpu.modelimport.hdf5 import H5File as JH5File
from deeplearning4j_tpu_torch.modelimport.hdf5 import (
    H5File, UnsupportedHDF5Feature, hdf5_available)

#: every numeric dtype of the subset, both byte orders
DTYPES = ("<i1", "<u1", "<i2", "<u2", "<i4", "<u4", "<i8", "<u8", "<f2",
          "<f4", "<f8", ">i2", ">u4", ">i8", ">f4", ">f8")


def _values(dt, shape=(3, 5)):
    rng = np.random.default_rng(zlib.crc32(dt.encode()))
    dt = np.dtype(dt)
    if dt.kind == "f":
        return rng.normal(size=shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape,
                        dtype=dt.newbyteorder("="), endpoint=True).astype(dt)


def test_always_available():
    assert hdf5_available()


def test_reads_h5py_files(tmp_path):
    """Fixed- and variable-length string attributes (scalar and arrays),
    scalar and array numeric attributes, every numeric dtype, a group of
    100 children (several symbol-table nodes), a header pushed into
    continuation blocks by 60 attributes, a never-written dataset (its fill
    value) and a compact dataset."""
    p = str(tmp_path / "h5py.h5")
    with h5py.File(p, "w") as f:
        f.attrs["vlen"] = "variable length"
        f.attrs["fixed"] = np.bytes_(b"fixed length")
        f.attrs["vlen_list"] = ["a", "bcd", ""]
        f.attrs["fixed_list"] = np.array([b"x", b"yz"], dtype="S3")
        f.attrs["scalar"] = np.int64(-7)
        f.attrs["floats"] = np.arange(4, dtype=np.float32) / 3
        for dt in DTYPES:
            f.create_dataset(f"num/{dt}", data=_values(dt))
        g = f.create_group("many")
        for i in range(100):
            g.create_dataset(f"c{i:03d}", data=np.full((2,), i, np.int32))
        d = f.create_dataset("attrs", data=np.arange(3.0))
        for i in range(60):
            d.attrs[f"a{i:02d}"] = np.arange(i + 1, dtype=np.float64)
        f.create_dataset("unwritten", shape=(2, 3), dtype="f4", fillvalue=2.5)
        f.create_dataset("zeros", shape=(4,), dtype="i2")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((2, 2))
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_FLOAT, space,
                        dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL,
                                    np.arange(4, dtype=np.float32))
    with H5File(p) as f:
        assert f.read_attr("/", "vlen") == "variable length"
        assert f.read_attr("/", "fixed") == "fixed length"
        assert f.read_attr("/", "vlen_list") == ["a", "bcd", ""]
        assert f.read_attr("/", "fixed_list") == ["x", "yz"]
        assert f.read_attr("/", "scalar") == -7
        np.testing.assert_array_equal(f.read_attr("/", "floats"),
                                      np.arange(4, dtype=np.float32) / 3)
        for dt in DTYPES:
            got = f.read_dataset(f"/num/{dt}")
            want = _values(dt)
            assert got.dtype == want.dtype.newbyteorder("=")
            np.testing.assert_array_equal(got, want)
        assert f.list_group("/many") == [f"c{i:03d}" for i in range(100)]
        assert f.read_dataset("/many/c077").tolist() == [77, 77]
        for i in (0, 31, 59):
            np.testing.assert_array_equal(f.read_attr("/attrs", f"a{i:02d}"),
                                          np.arange(i + 1, dtype=np.float64))
        np.testing.assert_array_equal(f.read_dataset("/unwritten"),
                                      np.full((2, 3), 2.5, np.float32))
        np.testing.assert_array_equal(f.read_dataset("/zeros"),
                                      np.zeros(4, np.int16))
        np.testing.assert_array_equal(f.read_dataset("/compact"),
                                      np.arange(4, dtype=np.float32)
                                      .reshape(2, 2))
        assert f.exists("/many/c099") and not f.exists("/many/c100")
        assert not f.exists("/many/c000/deeper")
        assert f.has_attr("/", "vlen") and not f.has_attr("/", "nope")
        with pytest.raises(KeyError):
            f.read_attr("/", "nope")
        with pytest.raises(KeyError):
            f.read_dataset("/many")


def test_reads_superblock_version_1(tmp_path):
    """A libhdf5 file with a non-default indexed-storage K carries superblock
    version 1."""
    import ctypes

    from deeplearning4j_tpu.modelimport import hdf5 as jhdf5

    p = str(tmp_path / "v1.h5")
    lib = jhdf5._load()
    hid = ctypes.c_int64
    lib.H5Pcreate.restype, lib.H5Pcreate.argtypes = hid, [hid]
    lib.H5Pset_istore_k.argtypes = [hid, ctypes.c_uint]
    lib.H5Pclose.argtypes = [hid]
    plist = lib.H5Pcreate(hid.in_dll(lib, "H5P_CLS_FILE_CREATE_ID_g").value)
    lib.H5Pset_istore_k(plist, 64)
    fid = lib.H5Fcreate(p.encode(), jhdf5.H5F_ACC_TRUNC, plist,
                        jhdf5.H5P_DEFAULT)
    assert fid >= 0
    lib.H5Fclose(fid)
    lib.H5Pclose(plist)
    with h5py.File(p, "r+") as f:
        f.create_dataset("g/d", data=np.arange(5, dtype=np.int16))
        f.attrs["s"] = "one"
    with open(p, "rb") as fh:
        assert fh.read(9)[8] == 1
    with H5File(p) as f:
        assert f.read_attr("/", "s") == "one"
        np.testing.assert_array_equal(f.read_dataset("/g/d"), np.arange(5))


def _jax_file(path):
    with JH5File(path, "w") as f:
        f.write_attr("/", "model_config", '{"class_name": "Sequential"}')
        f.create_group("/model_weights")
        f.write_attr("/model_weights", "layer_names", ["dense_1", "dense_2"])
        f.write_dataset("/model_weights/dense_1/W",
                        np.arange(12, dtype=np.float32).reshape(3, 4))
        f.write_dataset("/model_weights/dense_1/idx",
                        np.arange(5, dtype=np.uint64))
        f.write_attr("/model_weights/dense_1", "n", 3)
        f.write_attr("/model_weights/dense_1", "v", np.arange(3.0))


def test_reads_jax_h5file_files(tmp_path):
    p = str(tmp_path / "jax.h5")
    _jax_file(p)
    with H5File(p) as f, JH5File(p) as j:
        for path in ("/", "/model_weights", "/model_weights/dense_1"):
            assert f.list_group(path) == j.list_group(path)
        assert f.read_attr("/", "model_config") == \
            j.read_attr("/", "model_config")
        assert f.read_attr("/model_weights", "layer_names") == \
            ["dense_1", "dense_2"]
        for name in ("W", "idx"):
            a = f.read_dataset(f"/model_weights/dense_1/{name}")
            b = j.read_dataset(f"/model_weights/dense_1/{name}")
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert f.read_attr("/model_weights/dense_1", "n") == 3
        np.testing.assert_array_equal(
            f.read_attr("/model_weights/dense_1", "v"), np.arange(3.0))


def _port_file(path):
    with H5File(path, "w") as f:
        f.write_attr("/", "model_config", '{"x": "old"}')
        f.write_attr("/", "model_config", '{"x": "new"}')
        f.create_group("/model_weights")
        f.write_attr("/model_weights", "layer_names",
                     [f"layer_{i}" for i in range(40)])
        f.write_attr("/model_weights", "empty", [])
        for dt in DTYPES:
            if dt[0] == "<":
                f.write_dataset(f"/num/{dt[1:]}", _values(dt))
        for i in range(300):  # several symbol-table nodes, a 2-level tree
            f.write_dataset(f"/many/g{i:03d}/w", np.full((2,), i, np.int64))
        f.write_dataset("/empty", np.zeros((0, 4), np.float32))
        f.write_dataset("/bool_as_f32", np.array([True, False]))
        f.write_attr("/num/f4", "scalar", 2.5)
        f.write_attr("/num/f4", "ints", np.arange(3, dtype=np.int32))
        f.write_attr("/num/f4", "one", ["only"])


def test_h5py_and_jax_read_port_files(tmp_path):
    p = str(tmp_path / "port.h5")
    _port_file(p)
    layer_names = [f"layer_{i}" for i in range(40)]
    with h5py.File(p, "r") as f:
        assert f.attrs["model_config"] == b'{"x": "new"}'
        assert [n.decode() for n in
                f["model_weights"].attrs["layer_names"]] == layer_names
        for dt in DTYPES:
            if dt[0] == "<":
                got = f[f"num/{dt[1:]}"][()]
                assert got.dtype == np.dtype(dt)
                np.testing.assert_array_equal(got, _values(dt))
        assert len(f["many"]) == 300
        assert f["many/g123/w"][()].tolist() == [123, 123]
        assert f["empty"].shape == (0, 4)
        assert f["bool_as_f32"].dtype == np.float32
        assert f["num/f4"].attrs["scalar"].tolist() == [2.5]
    with JH5File(p) as f:
        assert f.read_attr("/", "model_config") == '{"x": "new"}'
        assert f.read_attr("/model_weights", "layer_names") == layer_names
        assert f.read_attr("/model_weights", "empty") == []
        assert f.list_group("/many")[:3] == ["g000", "g001", "g002"]
        assert len(f.list_group("/many")) == 300
        np.testing.assert_array_equal(f.read_dataset("/many/g299/w"),
                                      [299, 299])
        for dt in ("i1", "u2", "i4", "u8", "f4", "f8"):
            np.testing.assert_array_equal(f.read_dataset(f"/num/{dt}"),
                                          _values("<" + dt))
        assert f.read_attr("/num/f4", "scalar") == 2.5
        np.testing.assert_array_equal(f.read_attr("/num/f4", "ints"),
                                      np.arange(3))
        assert f.read_attr("/num/f4", "one") == "only"
    with H5File(p) as f:
        assert f.read_attr("/model_weights", "layer_names") == layer_names
        assert f.read_attr("/num/f4", "scalar") == 2.5
        np.testing.assert_array_equal(f.read_dataset("/num/f2"),
                                      _values("<f2"))


def test_attributes_overwrite_and_writer_refusals(tmp_path):
    p = str(tmp_path / "w.h5")
    with H5File(p, "w") as f:
        f.write_dataset("/d", np.arange(3.0))
        f.write_attr("/d", "a", "first")
        f.write_attr("/d", "a", ["second", "third"])
        assert f.read_attr("/d", "a") == ["second", "third"]
        with pytest.raises(KeyError):
            f.write_attr("/nope", "a", 1)
        with pytest.raises(OSError):
            f.write_dataset("/d", np.arange(3.0))
        # an attribute past a version-1 header message's 65,535 bytes
        with pytest.raises(ValueError, match="65535"):
            f.write_attr("/d", "big", "x" * 70_000)
    with JH5File(p) as f:
        assert f.read_attr("/d", "a") == ["second", "third"]
        assert not f.has_attr("/d", "big")


@pytest.mark.parametrize("kind,match", [
    ("chunked", "chunked layout"),
    ("gzip", "filter pipeline"),
    ("string_dataset", "string dataset"),
    ("latest", "superblock version"),
    ("enum_attr", "enumeration datatype"),
])
def test_unsupported_features_raise_naming_them(tmp_path, kind, match):
    p = str(tmp_path / f"{kind}.h5")
    with h5py.File(p, "w", libver="latest" if kind == "latest" else None) \
            as f:
        if kind == "chunked":
            f.create_dataset("d", data=np.arange(100.0), chunks=(10,))
        elif kind == "gzip":
            f.create_dataset("d", data=np.arange(100.0), compression="gzip")
        elif kind == "string_dataset":
            f.create_dataset("d", data=np.array([b"ab", b"cd"]))
        elif kind == "latest":
            f.create_dataset("d", data=np.arange(3.0))
        else:
            f.create_dataset("d", data=np.arange(3.0))
            f.attrs["flag"] = np.True_
    with pytest.raises(UnsupportedHDF5Feature, match=match):
        with H5File(p) as f:
            f.read_dataset("/d")


def test_refuses_files_that_are_not_hdf5(tmp_path):
    p = tmp_path / "x.h5"
    p.write_bytes(b"not an hdf5 file at all" * 10)
    with pytest.raises(OSError, match="not an HDF5 file"):
        H5File(str(p))
    with pytest.raises(ValueError, match="mode"):
        H5File(str(p), "a")
