"""The port's HDF5 reader and writer (``sleap_tpu_torch.io.hdf5``) against
h5py: every object of every ``.slp`` file in the repository, and files h5py
writes here with the layouts SLEAP files use (chunked resizable compound
tables, shuffle + deflate, variable-length strings, large and nested groups)
read bitwise equal; files the port writes read back through h5py; features
outside the subset raise an error that names them."""

from __future__ import annotations

import glob
import os

import h5py
import numpy as np
import pytest

from sleap_tpu_torch.io import hdf5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLP_FILES = sorted(glob.glob(os.path.join(REPO, ".convergence_runs", "*", "*.slp")))

POINTS = np.dtype([("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?")])


def _same_value(a, b, files=None) -> None:
    """``a`` as h5py reads it and ``b`` as the port reads it: equal values
    of equal dtypes; references to objects of the same name (``files``:
    the two open files)."""
    if isinstance(a, h5py.Reference):
        assert isinstance(b, hdf5.Reference) and bool(a) == bool(b)
        if a:
            ref, mine = files
            assert ref[a].name == mine[b].name
        return
    if isinstance(a, h5py.Empty):
        assert b is None
        return
    if isinstance(a, np.ndarray) and a.dtype == object:
        assert isinstance(b, np.ndarray) and b.shape == a.shape
        if a.size and isinstance(a.flat[0], h5py.Reference):
            for x, y in zip(a.ravel(), b.ravel()):
                _same_value(x, y, files)
            return
        assert [bytes(x) if isinstance(x, bytes) else x for x in a.ravel()] == list(b.ravel())
        return
    if isinstance(a, (bytes, str)):
        assert type(a) is type(b) and a == b
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def assert_same_file(path: str, refused=None) -> int:
    """Every group, dataset, named datatype and attribute of ``path`` as
    h5py and the port (on the CPU route) read it: attribute names and
    ``keys()`` in the same order, soft and external links followed.
    ``refused`` maps an object's path to the feature the port must name
    when it is opened or read. Returns the number of objects compared."""
    n = 0
    refused = refused or {}
    with h5py.File(path, "r") as ref, hdf5.File(path, device="cpu") as mine:
        def check(name, ref_obj, my_obj):
            nonlocal n
            n += 1
            assert list(ref_obj.attrs.keys()) == list(my_obj.attrs.keys()), name
            for key in ref_obj.attrs:
                _same_value(ref_obj.attrs[key], my_obj.attrs[key], (ref, mine))
            if isinstance(ref_obj, h5py.Group):
                assert isinstance(my_obj, hdf5.Group), name
                assert list(ref_obj.keys()) == my_obj.keys(), name
                for key in ref_obj:
                    if f"{name}/{key}" in refused:
                        with pytest.raises(hdf5.UnsupportedFeature, match=refused[f"{name}/{key}"]) as err:
                            my_obj[key][()]
                        assert os.path.basename(path) in str(err.value)
                        continue
                    check(f"{name}/{key}", ref_obj[key], my_obj[key])
            elif isinstance(ref_obj, h5py.Datatype):
                assert isinstance(my_obj, hdf5.Datatype) and my_obj.dtype == ref_obj.dtype, name
            else:
                assert isinstance(my_obj, hdf5.Dataset), name
                assert ref_obj.shape == my_obj.shape, name
                assert (ref_obj.chunks, ref_obj.maxshape) == (my_obj.chunks, my_obj.maxshape), name
                _same_value(ref_obj[()], my_obj[()], (ref, mine))

        check("", ref, mine)
    return n


@pytest.mark.parametrize("path", SLP_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_reader_matches_h5py_on_repo_slp_files(path):
    assert assert_same_file(path) >= 8


def test_repo_has_the_sixteen_slp_files():
    assert len(SLP_FILES) == 16


def _records(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, POINTS)
    rec["x"], rec["y"] = rng.normal(size=n), rng.normal(size=n)
    rec["visible"], rec["complete"] = rng.random(n) > 0.3, rng.random(n) > 0.5
    return rec


def test_reader_matches_h5py_on_sleap_layouts(tmp_path):
    path = str(tmp_path / "layouts.h5")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        # Upstream SLEAP: resizable, chunked compound tables.
        f.create_dataset("points", data=_records(1000, 1), maxshape=(None,), chunks=(64,))
        f.create_dataset("empty_table", shape=(0,), dtype=POINTS, maxshape=(None,), chunks=(16,))
        # The JAX writer's raw frames: chunked gzip (edge chunks cut).
        f.create_dataset("video0_raw", data=rng.integers(0, 255, (5, 33, 17, 1), np.uint8),
                         compression="gzip", chunks=(2, 16, 16, 1))
        f.create_dataset("shuffled", data=rng.normal(size=(37, 5)).astype("f4"),
                         shuffle=True, compression="gzip", chunks=(8, 5))
        f.create_dataset("ints", data=np.arange(-50, 50, dtype="<i2").reshape(10, 10))
        f.create_dataset("scalar", data=3.5)
        f.create_dataset("fixed", data=np.array([b"abc", b"de", b""], "S4"))
        f.create_dataset("vlen", data=["a", "bcd" * 50, ""], dtype=h5py.string_dtype())
        f.create_dataset("empty_f8", data=np.zeros(0))
        f["vlen"].attrs["json"] = '{"a": 1}'
        f["vlen"].attrs["list"] = np.array([b"x1", b"y22"])
        f.attrs["format_id"] = 1.2
        f.attrs["count"] = np.int64(7)
        # A group with enough links that its B-tree has an internal node.
        big = f.create_group("many")
        for i in range(300):
            big.create_dataset(f"d{i:03d}", data=np.array([i], "u4"))
        f.create_group("a/b/c").create_dataset("deep", data=np.arange(4.0))
        f["a/b"].attrs["label"] = np.bytes_(b"nested")
    assert assert_same_file(path) > 300
    with hdf5.File(path) as mine, h5py.File(path, "r") as ref:
        # Rows and slices read only what they select.
        np.testing.assert_array_equal(mine["video0_raw"][3], ref["video0_raw"][3])
        np.testing.assert_array_equal(mine["video0_raw"][1:4, 5:9], ref["video0_raw"][1:4, 5:9])
        np.testing.assert_array_equal(mine["points"][-1:], ref["points"][-1:])
        assert mine["points"].chunks == (64,)
        assert mine["points"].dtype == POINTS
        assert mine["a/b/c/deep"].parent.name == "/a/b/c"
        names = []
        mine["a"].visititems(lambda name, obj: names.append(name))
        assert names == ["b", "b/c", "b/c/deep"]


def test_reader_matches_h5py_on_latest_format(tmp_path):
    """Superblock version 3, version 2 object headers and compact links."""
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("points", data=_records(10, 2))
        f.create_dataset("text", data=np.array([b"x", b"yz"]))
        g = f.create_group("g")
        g.attrs["json"] = "vlen attribute"
        g.create_dataset("v", data=np.arange(6, dtype="u8").reshape(2, 3))
    assert assert_same_file(path) == 5


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_reader_raises_on_unsupported_features(libver, tmp_path):
    """What stays outside the subset raises UnsupportedFeature naming the
    feature and the file (the rest of the file reads as h5py reads it):
    nbit and szip filters, region references, virtual datasets, and, in
    files patched to hold them (h5py writes neither), a shared object
    header message table's message and a fractal heap with I/O filters."""
    path = str(tmp_path / "unsupported.h5")
    with h5py.File(path, "w", libver=libver) as f:
        d = f.create_dataset("data", data=np.arange(20).reshape(4, 5))
        d.attrs["note"] = 1
        f.create_dataset("region", data=[d.regionref[1:3, 2:4]], dtype=h5py.regionref_dtype)
        f.create_dataset("szip", data=np.arange(64, dtype="i4"), chunks=(32,), compression="szip")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((8,))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        f.create_dataset("nbit", shape=(16,), dtype="i4", dcpl=dcpl)[...] = np.arange(16)
        layout = h5py.VirtualLayout(shape=(4, 5), dtype=d.dtype)
        layout[...] = h5py.VirtualSource(d)
        f.create_virtual_dataset("virtual", layout)
        dense = f.create_group("dense")
        for i in range(20):  # past 8 links: a fractal heap in the latest format
            dense.create_dataset(f"d{i}", data=[i])
    refused = {"/region": "region references", "/szip": "the szip filter", "/nbit": "the nbit filter",
               "/virtual": "virtual datasets"}
    assert assert_same_file(path, refused) > 20
    data = bytearray(open(path, "rb").read())
    with hdf5.File(path, device="cpu") as mine:
        note = next(m for m in mine._messages(mine["data"]._oh) if m[0] == 0xC)
    head = 8 if libver == "earliest" else 4
    data[note[2] - head + (4 if libver == "earliest" else 3)] |= 0x02  # the attribute, "shared"
    if libver == "latest":
        heap = data.index(b"FRHP")
        data[heap + 7] = 1  # I/O filters on the heap's blocks
    patched = str(tmp_path / "patched.h5")
    open(patched, "wb").write(bytes(data))
    with hdf5.File(patched, device="cpu") as mine:
        with pytest.raises(hdf5.UnsupportedFeature, match="shared object header message tables") as err:
            mine["data"].attrs
        assert patched in str(err.value)
        if libver == "latest":
            with pytest.raises(hdf5.UnsupportedFeature, match="fractal heaps with I/O filters"):
                mine["dense"].keys()


def test_writer_output_reads_back_through_h5py(tmp_path):
    path = str(tmp_path / "written.h5")
    frames = np.random.default_rng(3).integers(0, 255, (4, 9, 7, 1), np.uint8)
    compound = np.zeros(5, [("id", "<u8"), ("video", "<u4"), ("score", "<f4"), ("ok", "?")])
    compound["id"], compound["score"], compound["ok"] = np.arange(5), np.linspace(0, 1, 5), [1, 0, 1, 0, 1]
    with hdf5.Writer(path) as w:
        md = w.require_group("metadata")
        md.attrs["format_id"] = 1.2
        md.attrs["json"] = np.bytes_(b'{"version": "2.0.0"}')
        md.attrs["count"] = 3
        w.create_dataset("points", data=_records(11, 4))
        w.create_dataset("empty_points", data=np.zeros(0, POINTS))
        w.create_dataset("table", data=compound)
        w.create_dataset("videos_json", data=np.array([b'{"a":1}', b'{"bb":22}']))
        w.create_dataset("suggestions_json", data=np.zeros(0))
        w.create_dataset("video0_raw", data=frames)
        w.create_dataset("scalar", data=np.array(2.5, "f4"))
        w.create_dataset("nested/deeper/values", data=np.arange(-3, 3, dtype="i2"))
        many = w.require_group("many")
        for i in range(300):  # SNODs of 8 entries under a two-level B-tree
            many.create_dataset(f"d{i:03d}", data=np.array([i], "u4"))
    with h5py.File(path, "r") as f:
        assert f["metadata"].attrs["format_id"] == 1.2
        assert f["metadata"].attrs["json"] == b'{"version": "2.0.0"}'
        assert f["metadata"].attrs["count"] == 3
        assert f["points"].dtype == POINTS
        np.testing.assert_array_equal(f["points"][:], _records(11, 4))
        assert f["empty_points"].shape == (0,) and f["empty_points"].dtype == POINTS
        assert f["table"][:].tobytes() == compound.tobytes()
        assert list(f["videos_json"][:]) == [b'{"a":1}', b'{"bb":22}']
        assert f["suggestions_json"].shape == (0,)
        np.testing.assert_array_equal(f["video0_raw"][:], frames)
        assert f["scalar"][()] == np.float32(2.5)
        np.testing.assert_array_equal(f["nested/deeper/values"][:], np.arange(-3, 3))
        assert sorted(f["many"].keys()) == [f"d{i:03d}" for i in range(300)]
        assert f["many/d299"][0] == 299
    assert assert_same_file(path) > 300


def test_writer_variable_length_strings_read_back_through_h5py(tmp_path):
    """Scalar and array variable-length UTF-8 strings (one global heap
    collection, empty strings too, past 4096 bytes), as h5py writes a
    ``str``; the port's reader and h5py read them; "a" mode keeps them."""
    path = str(tmp_path / "strings.h5")
    long = ["x" * 3000, "é" * 900]
    with hdf5.Writer(path) as w:
        w.create_dataset("scalar", data="hello wörld")
        w.create_dataset("empty", data="")
        w.create_dataset("array", data=np.array(["ab", "", "c"] + long, dtype=object))
        w.create_dataset("grid", data=np.array([["a", "b"], ["cc", ""]], dtype=object))
    with h5py.File(path, "r") as f:
        for name in ("scalar", "empty", "array", "grid"):
            info = h5py.check_string_dtype(f[name].dtype)
            assert (info.encoding, info.length) == ("utf-8", None), name
            assert f[name].compression is None and f[name].chunks is None
        assert f["scalar"][()] == "hello wörld".encode() and f["empty"][()] == b""
        assert [v.decode() for v in f["array"][:]] == ["ab", "", "c"] + long
        assert f["grid"].shape == (2, 2) and f["grid"][1, 0] == b"cc"
    with hdf5.Writer(path, "a") as w:
        w.create_dataset("more", data="added")
    mine = hdf5.File(path)
    assert mine["scalar"][()] == "hello wörld".encode() and mine["more"][()] == b"added"
    assert [v.decode() for v in mine["array"][:]] == ["ab", "", "c"] + long
    with h5py.File(path, "r") as f:
        assert f["grid"][0, 1] == b"b" and f["more"][()] == b"added"


@pytest.mark.parametrize("level", [1, 4, 9])
def test_writer_compression_level_reads_back_through_h5py(level, tmp_path):
    path = str(tmp_path / "levels.h5")
    data = np.random.default_rng(level).normal(size=(40, 3, 2, 5))
    chunks = hdf5.guess_chunk(data.shape, data.dtype.itemsize)
    with hdf5.Writer(path) as w:
        w.create_dataset("data", data=data, compression="gzip", compression_opts=level, chunks=chunks)
        w.create_dataset("empty", data=np.zeros(0, np.int32), compression="gzip", compression_opts=level)
    with h5py.File(path, "r") as f:
        assert (f["data"].compression, f["data"].compression_opts, f["data"].chunks) == ("gzip", level, chunks)
        np.testing.assert_array_equal(f["data"][:], data)
        assert f["empty"].shape == (0,) and f["empty"].chunks == (1024,)
        assert f["empty"].compression_opts == level
    with h5py.File(str(tmp_path / "ref.h5"), "w") as f:
        ref = f.create_dataset("data", data=data, compression="gzip", compression_opts=level)
        assert ref.chunks == chunks  # h5py's own chunk choice
    np.testing.assert_array_equal(hdf5.File(path)["data"][:], data)
    assert hdf5.File(path)["empty"][:].shape == (0,)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(TypeError, match="dtype"):
        hdf5.Writer(str(tmp_path / "x.h5")).create_dataset("u", data=np.array(["text"]))


def test_keras_weights_match_the_h5py_route(tmp_path):
    """``io.keras_h5.read_keras_weights`` on the port's reader against the
    same function on h5py (the JAX package's copy), on a file laid out as
    Keras saves weights: ``layer_names`` and ``weight_names`` string-array
    attributes, each layer's weights under ``<layer>/<layer>/<name>:0``."""
    import json

    from sleap_tpu.io.keras_h5 import read_keras_weights as h5py_route
    from sleap_tpu_torch.io.keras_h5 import read_keras_weights

    rng = np.random.default_rng(5)
    layers = {
        "stack0_enc0_conv0": {"kernel": (3, 3, 1, 8), "bias": (8,)},
        "stack0_dec0_s8_to_s4_refine_conv0": {"kernel": (3, 3, 16, 8), "bias": (8,)},
        "stack0_enc2_middle_expand_conv0": {"kernel": (3, 3, 8, 16), "bias": (16,)},
        "CentroidConfmapsHead_0": {"kernel": (1, 1, 8, 1), "bias": (1,)},
    }
    path = str(tmp_path / "best_model.h5")
    with h5py.File(path, "w") as f:
        f.attrs["backend"] = "tensorflow"
        f.attrs["keras_version"] = "2.3.1"
        f.attrs["model_config"] = json.dumps({"class_name": "Model", "layers": list(layers)}).encode()
        weights = f.create_group("model_weights")
        weights.attrs["layer_names"] = np.array([n.encode() for n in ["input", *layers]])
        weights.create_group("input").attrs["weight_names"] = np.array([], "S1")
        for name, shapes in layers.items():
            group = weights.create_group(name)
            group.attrs["weight_names"] = np.array([f"{name}/{w}:0".encode() for w in shapes])
            for w, shape in shapes.items():
                group.create_dataset(f"{name}/{w}:0", data=rng.normal(size=shape).astype("f4"))
    got, want = read_keras_weights(path), h5py_route(path)
    assert list(got) == list(want) == [
        "stack0_enc0_conv0", "stack0_dec0_refine_conv0", "stack0_enc2_conv0", "CentroidConfmapsHead"]
    for layer in want:
        assert list(got[layer]) == list(want[layer])
        for name, arr in want[layer].items():
            _same_value(arr, got[layer][name])
    assert assert_same_file(path) == 19  # root, model_weights, input, 4 x (2 groups, 2 datasets)
