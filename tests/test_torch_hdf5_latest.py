"""The port's HDF5 reader on what users' own files hold: h5py files written
here with ``libver="latest"`` and under SWMR, one case per structure (dense
links and attributes in fractal heaps and version 2 B-trees, creation
order), chunk index (single chunk, implicit, fixed array, extensible
array, version 2 B-tree), filter (lzf, fletcher32, scale-offset) and link
or type (soft, external, committed datatypes, object references, external
raw data files), each read as h5py reads it (``assert_same_file``), and
the structures each case is for found in its bytes."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import h5py
import numpy as np
import pytest

from sleap_tpu_torch.io import hdf5, hdf5_index, lzf
from sleap_tpu_torch.ops import _build
from test_torch_hdf5 import assert_same_file

LATEST = {"libver": "latest"}


def _frames(n, seed=0, size=(48, 40)):
    """Gray frames of smooth blobs over faint noise (LZF finds runs)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size[0], :size[1]]
    out = np.empty((n, *size, 1), np.uint8)
    for i in range(n):
        img = rng.integers(0, 6, size).astype(np.float64)
        img += 180 * np.exp(-((xx - 10 - i) ** 2 + (yy - 20) ** 2) / 60.0)
        out[i, ..., 0] = np.clip(img, 0, 255)
    return out


# Each function below writes one structure with h5py and returns the signatures
# that its bytes must hold.


def dense_links(f):
    g = f.create_group("many")
    for i in range(300):
        g.create_dataset(f"d{i:03d}", data=np.array([i], "u4"))
    return [b"FRHP", b"FHIB", b"FHDB", b"BTHD", b"BTIN", b"BTLF"]


def nested_indirect_blocks(f):
    """Soft links whose long targets fill the heap's direct rows, so its
    root indirect block holds indirect blocks."""
    f.create_dataset("target", data=np.arange(3))
    g = f.create_group("soft")
    path = "/target" + "/." * 120
    for i in range(2600):
        g[f"s{i:05d}"] = h5py.SoftLink(path)
    return [b"FHIB"]


def creation_order(f):
    for to in (True, False):
        g = f.create_group(f"tracked_{to}", track_order=to)
        for name in ("zeta", "alpha", "Mid", "beta", "b"):
            g.create_dataset(name, data=[1])
            g.attrs[name] = len(name)
        big = g.create_group("dense", track_order=to)
        for i in range(20):
            big.create_group(f"g{(7 * i) % 20}")
            big.attrs[f"a{(7 * i) % 20}"] = i
        d = g.create_dataset("dataset", data=[1.0], track_order=to)
        for i in range(12):
            d.attrs[f"x{(5 * i) % 12}"] = i
    return [b"FRHP"]


def dense_attributes(f):
    d = f.create_dataset("many_attrs", data=np.arange(4))
    g = f.create_group("group_attrs")
    for i in range(40):
        d.attrs[f"attr{i:02d}"] = np.arange(i, dtype="i2")
        g.attrs[f"k{i}"] = f"value {i}"
    # Past the heap's largest managed object (4 KiB): a huge object.
    d.attrs["huge"] = np.arange(3000, dtype="f8")
    g.attrs["huge"] = "x" * 9000
    return [b"FRHP", b"BTHD"]


def single_chunk(f):
    f.create_dataset("plain", data=np.arange(60, dtype="i4").reshape(6, 10), chunks=(6, 10))
    f.create_dataset("filtered", data=np.arange(60, dtype="f8").reshape(6, 10), chunks=(6, 10),
                     compression="gzip", shuffle=True)
    return []


def implicit(f):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((4, 3))
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    d = f.create_dataset("implicit", shape=(10, 7), dtype="u2", dcpl=dcpl)
    d[...] = np.arange(70, dtype="u2").reshape(10, 7)
    return []


def fixed_array(f):
    f.create_dataset("small", data=np.arange(100, dtype="i8"), chunks=(7,))
    f.create_dataset("filtered", data=np.arange(300, dtype="f4"), chunks=(9,), compression="lzf")
    paged = f.create_dataset("paged", shape=(2100,), dtype="u2", chunks=(2,), fillvalue=7)
    paged[:900] = np.arange(900)  # the second page stays unwritten
    paged[2000:2050] = 5
    f.create_dataset("paged_full", data=np.arange(2100, dtype="u1"), chunks=(2,), fletcher32=True)
    return [b"FAHD", b"FADB"]


def extensible_array(f):
    d = f.create_dataset("grown", shape=(0, 3), maxshape=(None, 3), chunks=(1, 3), dtype="i4")
    for i in range(300):  # past the index block's data blocks: secondary blocks
        d.resize(i + 1, axis=0)
        d[i] = [i, -i, 2 * i]
    e = f.create_dataset("filtered", shape=(0, 5), maxshape=(None, 5), chunks=(2, 5), dtype="f8",
                         compression="gzip", fillvalue=-1.5)
    e.resize(90, axis=0)
    e[::3] = np.arange(150, dtype="f8").reshape(30, 5)
    u = f.create_dataset("unlimited_last", shape=(4, 0), maxshape=(4, None), chunks=(2, 2), dtype="u1")
    u.resize(40, axis=1)
    u[...] = np.arange(160, dtype="u1").reshape(4, 40)
    return [b"EAHD", b"EAIB", b"EASB", b"EADB"]


def btree2(f):
    d = f.create_dataset("two_unlimited", shape=(30, 40), maxshape=(None, None), chunks=(2, 3), dtype="i2")
    d[...] = np.arange(1200, dtype="i2").reshape(30, 40)
    e = f.create_dataset("filtered", shape=(12, 13), maxshape=(None, None), chunks=(5, 5), dtype="f4",
                         compression="lzf", fletcher32=True, fillvalue=np.float32(3.25))
    e[:7, :] = np.arange(91, dtype="f4").reshape(7, 13)
    return [b"BTHD", b"BTIN", b"BTLF"]


def lzf_filter(f):
    frames = _frames(6)
    f.create_dataset("frames", data=frames, chunks=(1, 48, 40, 1), compression="lzf", shuffle=True)
    noise = np.random.default_rng(1).integers(0, 256, (8, 64), np.uint8)
    f.create_dataset("incompressible", data=noise, chunks=(2, 64), compression="lzf")  # stored raw
    f.create_dataset("table", data=np.arange(500, dtype="<i8") % 7, chunks=(100,), compression="lzf")
    return []


def fletcher(f):
    f.create_dataset("checked", data=np.arange(1001, dtype="u2"), chunks=(333,), fletcher32=True)
    f.create_dataset("odd", data=np.arange(7, dtype="u1"), chunks=(7,), fletcher32=True)
    f.create_dataset("all", data=_frames(3), chunks=(1, 48, 40, 1), shuffle=True, compression="lzf",
                     fletcher32=True)
    return []


def scaleoffset(f):
    rng = np.random.default_rng(2)
    for dt in ("i1", "u1", "i2", "u2", "i4", "u4", "i8", "u8"):
        info = np.iinfo(dt)
        lo, hi = max(info.min // 2, -1000), min(info.max // 2, 1000)  # libhdf5 fails on full-range bytes
        f.create_dataset(f"int_{dt}", data=rng.integers(lo, hi, (50, 3)).astype(dt), chunks=(16, 3),
                         scaleoffset=0)
    f.create_dataset("int_bits", data=rng.integers(-5, 90, 40).astype("i4"), chunks=(40,), scaleoffset=4)
    f.create_dataset("int_constant", data=np.full(20, 9, "i2"), chunks=(8,), scaleoffset=0)
    filled = f.create_dataset("int_fill", shape=(30,), dtype="i4", chunks=(10,), scaleoffset=0, fillvalue=-7)
    filled[5:12] = np.arange(7) * 100
    filled[20:] = -7
    f.create_dataset("f4", data=rng.normal(size=(33, 2)).astype("f4"), chunks=(10, 2), scaleoffset=3)
    f.create_dataset("f8", data=rng.normal(100, 5, 64), chunks=(16,), scaleoffset=2)
    ff = f.create_dataset("f8_fill", shape=(20,), dtype="f8", chunks=(5,), scaleoffset=1, fillvalue=2.5)
    ff[3:9] = np.linspace(-1, 1, 6)
    return []


def committed_types(f):
    f["point_t"] = np.dtype([("x", "<f8"), ("y", "<f8"), ("visible", "?")])
    f["int_t"] = np.dtype("<i2")
    t = f["point_t"]
    t.attrs["about"] = "a committed compound"
    data = np.zeros(4, t.dtype)
    data["x"] = np.arange(4)
    f.create_dataset("points", data=data, dtype=t)
    f.create_dataset("ints", data=np.arange(5), dtype=f["int_t"])
    f["ints"].attrs.create("typed", np.array([3, 4], "<i2"), dtype=f["int_t"])
    return []


def references(f):
    d = f.create_dataset("data", data=np.arange(6))
    g = f.create_group("group")
    g.create_dataset("inner", data=[1.5])
    refs = f.create_dataset("refs", data=[d.ref, g.ref, g["inner"].ref, h5py.Reference()], dtype=h5py.ref_dtype)
    refs.attrs["one"] = d.ref
    f.attrs["refs"] = np.array([g.ref, d.ref], dtype=h5py.ref_dtype)
    return []


def soft_links(f):
    f.create_dataset("d1", data=np.arange(10))
    g = f.create_group("g")
    g.create_dataset("x", data=[2.0])
    g.attrs["a"] = 1
    f["soft"] = h5py.SoftLink("/d1")
    f["soft_group"] = h5py.SoftLink("/g")
    g["relative"] = h5py.SoftLink("x")
    f["chain"] = h5py.SoftLink("/soft")
    return []


LAYOUTS = {
    "dense links": (dense_links, LATEST),
    "nested indirect blocks": (nested_indirect_blocks, LATEST),
    "creation order, latest": (creation_order, LATEST),
    "creation order, earliest": (creation_order, {}),
    "dense attributes": (dense_attributes, LATEST),
    "single chunk": (single_chunk, LATEST),
    "implicit index": (implicit, LATEST),
    "fixed array": (fixed_array, LATEST),
    "extensible array": (extensible_array, LATEST),
    "version 2 B-tree index": (btree2, LATEST),
    "lzf": (lzf_filter, LATEST),
    "lzf, earliest": (lzf_filter, {}),
    "fletcher32": (fletcher, LATEST),
    "fletcher32, earliest": (fletcher, {}),
    "scaleoffset": (scaleoffset, LATEST),
    "scaleoffset, earliest": (scaleoffset, {}),
    "committed datatypes, latest": (committed_types, LATEST),
    "committed datatypes, earliest": (committed_types, {}),
    "references, latest": (references, LATEST),
    "references, earliest": (references, {}),
    "soft links, latest": (soft_links, LATEST),
    "soft links, earliest": (soft_links, {}),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_reader_matches_h5py(case, tmp_path):
    build, kwargs = LAYOUTS[case]
    path = str(tmp_path / "case.h5")
    with h5py.File(path, "w", **kwargs) as f:
        signatures = build(f)
    data = Path(path).read_bytes()
    for sig in signatures:
        assert sig in data, f"{case}: no {sig!r} in the file"
    assert assert_same_file(path) >= 2


def test_nested_indirect_blocks_and_deep_name_index(tmp_path):
    """The heap of 2600 long soft links has indirect blocks below its root
    and its name index B-tree is two levels deep."""
    path = str(tmp_path / "deep.h5")
    with h5py.File(path, "w", libver="latest") as f:
        nested_indirect_blocks(f)
    with hdf5.File(path, device="cpu") as mine:
        data = Path(path).read_bytes()
        assert data.count(b"FHIB") >= 2
        heap = hdf5_index.FractalHeap(mine, data.index(b"FRHP"))
        assert heap.root_rows > heap.max_direct_rows
        bthd = data.index(b"BTHD")
        assert int.from_bytes(data[bthd + 12:bthd + 14], "little") >= 2  # depth
        assert len(mine["soft"].keys()) == 2600
        np.testing.assert_array_equal(mine["soft/s02599"][:], np.arange(3))


def test_swmr_appended_frames(tmp_path):
    """A video grown frame by frame under SWMR (shuffle + lzf + fletcher32,
    chunks of one frame): an extensible-array index, read as h5py reads it."""
    path = str(tmp_path / "swmr.h5")
    frames = _frames(20, seed=3)
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("video", shape=(0, 48, 40, 1), maxshape=(None, 48, 40, 1), dtype="u1",
                             chunks=(1, 48, 40, 1), shuffle=True, compression="lzf", fletcher32=True)
        f.swmr_mode = True
        for i, frame in enumerate(frames):
            d.resize(i + 1, axis=0)
            d[i] = frame
            d.flush()
    assert b"EAHD" in Path(path).read_bytes()
    assert assert_same_file(path) == 2
    with hdf5.File(path, device="cpu") as mine:
        assert mine["video"].maxshape == (None, 48, 40, 1)
        np.testing.assert_array_equal(mine["video"][7], frames[7])
        np.testing.assert_array_equal(mine["video"][3:9], frames[3:9])


def test_soft_link_in_symbol_table_group(tmp_path):
    """A soft link in an earliest-format group (a symbol table entry of
    cache type 2, its value in the local heap) is followed."""
    path = str(tmp_path / "soft.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("d1", data=np.arange(10))
        f["soft"] = h5py.SoftLink("/d1")
        f["dangling"] = h5py.SoftLink("/nowhere")
    with hdf5.File(path, device="cpu") as mine:
        assert mine["soft"].name == "/soft"
        np.testing.assert_array_equal(mine["soft"][:], np.arange(10))
        assert mine.keys() == ["d1", "dangling", "soft"]
        assert "dangling" in mine  # the link exists, as h5py says
        with pytest.raises(KeyError):
            mine["dangling"]


def test_external_raw_data_files(tmp_path, monkeypatch):
    """A dataset in an external raw file reads its values, not zeros, with
    relative names taken from the working directory, as libhdf5 takes them
    by default; a missing or short file raises OSError naming it."""
    home, other = tmp_path / "home", tmp_path / "elsewhere"
    home.mkdir(), other.mkdir()
    (home / "ext.bin").write_bytes(b"\0" * 16 + np.arange(10, dtype="<i8").tobytes())
    path = str(home / "external.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("d", shape=(10,), dtype="<i8", external=[("ext.bin", 16, h5py.h5f.UNLIMITED)])
        f.create_dataset("split", shape=(2, 3), dtype="<i8",
                         external=[("ext.bin", 16, 16), ("ext.bin", 48, 32)])
    monkeypatch.chdir(home)
    assert assert_same_file(path) == 3
    with hdf5.File(path, device="cpu") as mine:
        np.testing.assert_array_equal(mine["d"][:], np.arange(10))
        np.testing.assert_array_equal(mine["d"][4:7], [4, 5, 6])
    monkeypatch.chdir(other)
    with h5py.File(path, "r") as ref, pytest.raises(OSError):
        ref["d"][:]
    with hdf5.File(path, device="cpu") as mine, pytest.raises(OSError, match="ext.bin"):
        mine["d"][:]
    (other / "ext.bin").write_bytes(b"\0" * 16 + np.arange(100, 110, dtype="<i8").tobytes())
    with h5py.File(path, "r") as ref, hdf5.File(path, device="cpu") as mine:
        np.testing.assert_array_equal(mine["d"][:], ref["d"][:])
        np.testing.assert_array_equal(mine["d"][:], np.arange(100, 110))
    (other / "ext.bin").write_bytes(b"\0" * 16 + np.arange(5, dtype="<i8").tobytes())
    with hdf5.File(path, device="cpu") as mine, pytest.raises(OSError, match="ext.bin.*short"):
        mine["d"][:]  # h5py fills the missing bytes with zeros: the port refuses them


def test_external_links(tmp_path, monkeypatch):
    """An external link opens its file as libhdf5 looks for it: beside the
    file holding the link first, then relative to the working directory;
    a missing file raises KeyError naming it."""
    here, cwd = tmp_path / "here", tmp_path / "cwd"
    here.mkdir(), cwd.mkdir()
    for folder, value in ((here, 1), (cwd, 2)):
        with h5py.File(folder / "target.h5", "w") as f:
            f.create_dataset("t", data=[value])
            f.create_group("g").create_dataset("inner", data=[value * 10])
    with h5py.File(cwd / "only_cwd.h5", "w") as f:
        f.create_dataset("t", data=[3])
    path = str(here / "links.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f["beside"] = h5py.ExternalLink("target.h5", "/t")
        f["group"] = h5py.ExternalLink("target.h5", "/g")
        f["cwd"] = h5py.ExternalLink("only_cwd.h5", "/t")
        f["missing"] = h5py.ExternalLink("nowhere.h5", "/t")
    monkeypatch.chdir(cwd)
    with h5py.File(path, "r") as ref, hdf5.File(path, device="cpu") as mine:
        for name in ("beside", "group/inner", "cwd"):
            np.testing.assert_array_equal(mine[name][()], ref[name][()])
            assert mine[name].name == ref[name].name
        assert mine["beside"][0] == 1 and mine["cwd"][0] == 3
        assert "missing" in mine and "missing" in ref
        with pytest.raises(KeyError):
            ref["missing"]
        with pytest.raises(KeyError, match="nowhere.h5"):
            mine["missing"]


def test_committed_datatype_object_and_references(tmp_path):
    path = str(tmp_path / "types.h5")
    with h5py.File(path, "w", libver="latest") as f:
        committed_types(f)
        references(f)
    with h5py.File(path, "r") as ref, hdf5.File(path, device="cpu") as mine:
        assert isinstance(mine["point_t"], hdf5.Datatype)
        assert mine["point_t"].dtype == ref["point_t"].dtype
        assert mine["points"].dtype == ref["points"].dtype
        refs = mine["refs"][:]
        assert [mine[r].name for r in refs[:3]] == ["/data", "/group", "/group/inner"]
        assert not refs[3]
        with pytest.raises(ValueError, match="null"):
            mine[refs[3]]
        np.testing.assert_array_equal(mine[mine["refs"].attrs["one"]][:], np.arange(6))
        assert isinstance(mine[refs[1]], hdf5.Group)


def test_partial_edge_chunks_left_unfiltered(tmp_path):
    """The layout flag "do not filter partial edge chunks": the edge chunk
    is stored raw, and both readers skip the filters on it."""
    path = str(tmp_path / "edge.h5")
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("d", shape=(10,), maxshape=(10,), dtype="<i4", chunks=(4,), compression="gzip")
        d[:8] = np.arange(8)
        d.id.write_direct_chunk((8,), np.array([8, 9, 0, 0], "<i4").tobytes(), filter_mask=0)
    data = bytearray(Path(path).read_bytes())
    with hdf5.File(path, device="cpu") as mine:
        layout = next(m for m in mine._messages(mine["d"]._oh) if m[0] == 0x8)[2]
    assert data[layout] == 4 and data[layout + 1] == 2
    data[layout + 2] |= 1
    # The object header's checksum, over the header up to it.
    ohdr = data.rindex(b"OHDR", 0, layout)
    end = ohdr + 6 + (16 if data[ohdr + 5] & 0x20 else 0) + (4 if data[ohdr + 5] & 0x10 else 0)
    width = 1 << (data[ohdr + 5] & 3)
    end += width + int.from_bytes(data[end:end + width], "little")
    data[end:end + 4] = hdf5._lookup3(bytes(data[ohdr:end])).to_bytes(4, "little")
    Path(path).write_bytes(bytes(data))
    with h5py.File(path, "r") as ref:
        np.testing.assert_array_equal(ref["d"][:], np.arange(10))
    assert assert_same_file(path) == 2


def test_lzf_plain_decoder_equals_h5py(tmp_path):
    """Each stored LZF chunk, decoded by the plain decoder, is the bytes
    h5py reads (long runs, overlapping copies, literals only)."""
    path = str(tmp_path / "lzf.h5")
    rng = np.random.default_rng(5)
    cases = {"runs": np.repeat(rng.integers(0, 256, 300, np.uint8), rng.integers(1, 400, 300)),
             "blobs": _frames(2).reshape(-1), "zeros": np.zeros(70000, np.uint8),
             "pattern": np.tile(np.arange(3, dtype=np.uint8), 5000)}
    with h5py.File(path, "w") as f:
        for name, data in cases.items():
            f.create_dataset(name, data=data, chunks=(len(data),), compression="lzf")
    with hdf5.File(path, device="cpu") as mine:
        for name, data in cases.items():
            ds = mine[name]
            (offsets, mask, size, addr), = ds._chunk_entries()
            assert mask == 0 and size < len(data)
            assert lzf.decode_plain(bytes(mine._buf[addr:addr + size])) == data.tobytes()
    with pytest.raises(ValueError, match="corrupt"):
        lzf.decode_plain(b"\x20\x05")  # a back reference before the start


def test_fletcher32_mismatch_raises(tmp_path):
    path = str(tmp_path / "checked.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("d", data=np.arange(100, dtype="<u4"), chunks=(50,), fletcher32=True)
    with hdf5.File(path, device="cpu") as mine:
        addr = mine["d"]._chunk_entries()[1][3]
    data = bytearray(Path(path).read_bytes())
    data[addr + 5] ^= 0x40
    bad = str(tmp_path / "flipped.h5")
    Path(bad).write_bytes(bytes(data))
    with h5py.File(bad, "r") as ref, pytest.raises(OSError):
        ref["d"][:]
    with hdf5.File(bad, device="cpu") as mine:
        np.testing.assert_array_equal(mine["d"][:50], np.arange(50))
        with pytest.raises(OSError, match="Fletcher-32"):
            mine["d"][:]


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """``csrc/hdf5.cu`` built with the system C++ compiler, bound as the
    kernel library binds it."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host LZF decoder")
    lib = tmp_path_factory.mktemp("host") / "libhdf5host.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(Path(_build.CSRC) / "hdf5.cu")], check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))

    def entry(name):
        fn = getattr(cdll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
        return fn

    return entry


def test_card_route_decodes_lzf_in_host_c(host_library, monkeypatch, tmp_path):
    """``File(path, device="cuda")`` decodes LZF with the host C decoder:
    the plain decoder's bytes, and h5py's values."""
    monkeypatch.setattr(_build, "entry", host_library)
    path = str(tmp_path / "lzf.h5")
    with h5py.File(path, "w", libver="latest") as f:
        lzf_filter(f)
    with hdf5.File(path, device="cuda") as mine, h5py.File(path, "r") as ref:
        for name in ("frames", "incompressible", "table"):
            np.testing.assert_array_equal(mine[name][:], ref[name][:])
            for offsets, mask, size, addr in mine[name]._chunk_entries():
                stream = bytes(mine._buf[addr:addr + size])
                if mask:  # stored raw: lzf did not shrink it
                    continue
                plain = lzf.decode_plain(stream)
                assert lzf.decode_host(stream, len(plain)) == plain
                assert lzf.decode_host(stream, 1) == plain  # the buffer grows as h5py's does
    with pytest.raises(ValueError, match="corrupt"):
        lzf.decode_host(b"\x20\x05", 10)


def test_paged_extensible_array(tmp_path):
    """140000 chunks of one element: the extensible array's later super
    blocks hold data blocks of more elements than a page, in pages."""
    path = str(tmp_path / "paged_ea.h5")
    n = 140000
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("d", shape=(0,), maxshape=(None,), chunks=(1,), dtype="u2", fillvalue=3)
        d.resize((n,))
        d[:131000] = np.arange(131000) % 65521
        d[135000:] = 9
    with h5py.File(path, "r") as ref, hdf5.File(path, device="cpu") as mine:
        np.testing.assert_array_equal(mine["d"][:], ref["d"][:])
        np.testing.assert_array_equal(mine["d"][130990:131010], ref["d"][130990:131010])


# --------------------------------------------------------------------------- #
# The committed fixtures (scripts/make_torch_hdf5_fixtures.py)
# --------------------------------------------------------------------------- #

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_data", "hdf5")
FIXTURE_FILES = ("latest_raw.slp", "features.h5", "features_earliest.h5")


def _manifest_module():
    import sys

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import hdf5_manifest

    return hdf5_manifest


@pytest.fixture
def in_fixtures(monkeypatch):
    """The fixtures' folder as the working directory (``features.h5`` names
    its external raw file relative to it, as libhdf5 resolves it)."""
    import json

    monkeypatch.chdir(FIXTURES)
    with open("manifest.json") as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_committed_manifest_is_what_h5py_reads(name, in_fixtures):
    hm = _manifest_module()
    entry = in_fixtures["files"][name]
    with h5py.File(name, "r") as f:
        assert hm.differences(entry["objects"], hm.manifest(f, entry["refused"])) == []


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_port_reads_the_fixtures_as_the_manifest_says(name, in_fixtures):
    """The CPU route against the manifest, refusals probed (phase 20a holds
    the card's route to the same file)."""
    hm = _manifest_module()
    entry = in_fixtures["files"][name]
    with hdf5.File(name, device="cpu") as f:
        got = hm.manifest(f, entry["refused"], probe=True)
    assert hm.differences(entry["objects"], got) == []
    refused = {k: v.replace("the ", "") for k, v in entry["refused"].items()}
    assert assert_same_file(name, {"/" + k.strip("/"): v for k, v in refused.items()}) >= 10


def test_fixtures_hold_their_structures(in_fixtures):
    """From the fixtures' bytes: the heap's indirect blocks, a name index of
    depth 1, a paged fixed array with an unwritten page, an extensible array
    with secondary blocks (and the SWMR video's), a chunk B-tree of depth 1,
    a soft link in a symbol table entry."""
    features = Path("features.h5").read_bytes()
    for sig in (b"FHIB", b"BTIN", b"FAHD", b"FADB", b"EAHD", b"EAIB", b"EASB", b"EADB"):
        assert sig in features, sig
    with hdf5.File("features.h5", device="cpu") as f:
        kinds = {name: f[name]._index[0] for name in ("single", "single_filtered", "implicit", "fixed_paged",
                                                      "extensible", "btree2", "lzf")}
        assert kinds == {"single": hdf5_index.SINGLE, "single_filtered": hdf5_index.SINGLE,
                         "implicit": hdf5_index.IMPLICIT, "fixed_paged": hdf5_index.FIXED_ARRAY,
                         "extensible": hdf5_index.EXTENSIBLE_ARRAY, "btree2": hdf5_index.BTREE2,
                         "lzf": hdf5_index.FIXED_ARRAY}
        header = f["fixed_paged"]._index[1]
        n, page_bits = int.from_bytes(features[header + 8:header + 16], "little"), features[header + 7]
        assert n > 1 << page_bits  # paged
        block = int.from_bytes(features[header + 16:header + 24], "little")
        assert features[block + 14] & 0x80 and not features[block + 14] & 0x40  # page 0 written, 1 not
        btree = f["btree2"]._index[1]
        assert features[btree + 5] == 11 and int.from_bytes(features[btree + 12:btree + 14], "little") >= 1
        heap = hdf5_index.FractalHeap(f, features.index(b"FRHP"))
        assert heap.root_rows > 0  # an indirect root block
        links = next(m for m in f._messages(f["many"]._oh) if m[0] == 0x2)[2]
        names = int.from_bytes(features[links + 2 + 8:links + 2 + 16], "little")
        assert int.from_bytes(features[names + 12:names + 14], "little") >= 1  # name index depth
        assert f["many_attrs"].attrs["huge"].shape == (1000,)
    with hdf5.File("latest_raw.slp", device="cpu") as f:
        video = f["video0_raw"]
        assert video._index[0] == hdf5_index.EXTENSIBLE_ARRAY and video.maxshape == (None, 384, 384, 1)
        assert [fid for fid, _ in video.filters] == [2, 32000, 3]
        assert f.keys()[:2] == ["metadata", "videos_json"]  # creation order, not name order
    with hdf5.File("features_earliest.h5", device="cpu") as f:
        assert f["old"]._members["soft"] == ("soft", "/old/d")


def test_fixture_script_rebuilds_the_features_byte_for_byte(tmp_path, monkeypatch):
    import sys

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_torch_hdf5_fixtures as script

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(script.SEED)
    script.write_features("features.h5", rng)
    script.write_earliest("features_earliest.h5", rng)
    for name in ("features.h5", "features_earliest.h5", "external.bin"):
        assert (tmp_path / name).read_bytes() == Path(FIXTURES, name).read_bytes(), name


# --------------------------------------------------------------------------- #
# The JAX package's readers on the latest-format twins
# --------------------------------------------------------------------------- #


def test_latest_twin_loads_as_in_the_jax_package():
    """``latest_raw.slp`` through ``sleap_tpu``'s ``load_file`` and the
    port's: equal ``Labels``, frames bitwise (LZF decoded by the plain
    decoder), and equal to ``raw.slp``'s."""
    from sleap_tpu.io import slp as jslp
    from sleap_tpu_torch.io import slp
    from test_torch_slp import assert_same_labels

    path = os.path.join(FIXTURES, "latest_raw.slp")
    mine, ref = slp.read_labels(path, device="cpu"), jslp.read_labels(path)
    assert_same_labels(mine, ref)
    raw = slp.read_labels(os.path.join(REPO, "tests", "torch_data", "raw.slp"), device="cpu")
    assert mine.video.shape == ref.videos[0].shape == raw.video.shape
    for i in range(mine.video.num_frames):
        a, b = mine.video.get_frame(i), ref.videos[0].get_frame(i)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, raw.video.get_frame(i))


def test_latest_analysis_file_reads_as_in_the_jax_package(tmp_path):
    """An analysis file copied into the latest format (lzf, track order)
    reads as the JAX package reads it."""
    from sleap_tpu.info import write_tracking_h5 as j_export
    from sleap_tpu.io import formats as j_formats
    from sleap_tpu_torch.io import formats as t_formats
    from test_torch_convert import tracked
    from test_torch_data_model import JAX, summary

    src, path = str(tmp_path / "src.analysis.h5"), str(tmp_path / "latest.analysis.h5")
    j_export.export_analysis_file(tracked(JAX), src)
    with h5py.File(src, "r") as s, h5py.File(path, "w", libver="latest", track_order=True) as f:
        for name in reversed(list(s)):
            value = s[name][()]
            kw = {"chunks": True, "compression": "lzf"} if isinstance(value, np.ndarray) and value.ndim else {}
            f.create_dataset(name, data=value, dtype=s[name].dtype, **kw)
            for key, attr in s[name].attrs.items():
                f[name].attrs[key] = attr
    mine, ref = t_formats.read(path, device="cpu"), j_formats.read(path)
    assert summary(mine) == summary(ref)
    np.testing.assert_array_equal(mine.numpy(), ref.numpy())


def test_append_to_the_latest_twin_reads_as_the_jax_append(tmp_path):
    """``Video.to_hdf5`` into a copy of ``latest_raw.slp``: the port's writer
    (mode "a": the file read, then written again in the earliest layout)
    and the JAX package's (``h5py.File(path, "a")``) leave files that h5py
    reads alike: every object, value and attribute, and their orders (the
    root's creation order, the added group last). The layouts differ: the
    port's writer deflates what lzf filtered, gives no maximum shape, and
    chunks frames one a chunk where h5py guesses smaller chunks."""
    from sleap_tpu.io import slp as jslp
    from sleap_tpu_torch.io import slp

    hm = _manifest_module()
    raw = os.path.join(REPO, "tests", "torch_data", "raw.slp")
    mine_path, ref_path = str(tmp_path / "port.slp"), str(tmp_path / "jax.slp")
    for path in (mine_path, ref_path):
        shutil.copy(os.path.join(FIXTURES, "latest_raw.slp"), path)
    slp.read_labels(raw, device="cpu").video.to_hdf5(mine_path, "extra", frame_numbers=[0, 3, 5], device="cpu")
    jslp.read_labels(raw).videos[0].to_hdf5(ref_path, "extra", frame_numbers=[0, 3, 5])
    with h5py.File(mine_path, "r") as a, h5py.File(ref_path, "r") as b:
        assert list(a) == list(b) == [*SLP_ROOT, "extra"]
        layout = ("maxshape", "chunks")  # the port's writer: no maximum shape, a frame a chunk
        want = [{k: v for k, v in e.items() if k not in layout} for e in hm.manifest(b)]
        got = [{k: v for k, v in e.items() if k not in layout} for e in hm.manifest(a)]
        assert hm.differences(want, got) == []
        assert a["video0_raw"].compression == "gzip" and b["video0_raw"].compression == "lzf"
    assert_same_file(mine_path)


SLP_ROOT = ["metadata", "videos_json", "tracks_json", "suggestions_json", "frames", "instances", "points",
            "pred_points", "video0_raw"]


@pytest.mark.parametrize("what", ["soft link", "external link", "reference", "committed datatype"])
def test_append_refuses_what_the_writer_cannot_write(what, tmp_path):
    """``Writer(path, "a")`` on a file holding what it does not write raises
    UnsupportedFeature naming it, and leaves the file as it was."""
    path = str(tmp_path / "holds.h5")
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("d", data=np.arange(3))
        if what == "soft link":
            f["s"] = h5py.SoftLink("/d")
        elif what == "external link":
            f["e"] = h5py.ExternalLink("other.h5", "/x")
        elif what == "reference":
            f.create_group("g").attrs["r"] = d.ref
        else:
            f["t"] = np.dtype("<i2")
    before = Path(path).read_bytes()
    with pytest.raises(hdf5.UnsupportedFeature, match=f"{what.split()[0]}.*{Path(path).name}|"
                       f"{Path(path).name}.*{what.split()[0]}"):
        hdf5.Writer(path, "a", device="cpu")
    assert Path(path).read_bytes() == before
