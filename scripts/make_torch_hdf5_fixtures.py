"""Rebuild the HDF5 fixtures of the port's reader tests and ``chip_smoke.py``
phase 20 with h5py (and the JAX package's ``write_labels``), from a seed;
nothing is downloaded.

    JAX_PLATFORMS=cpu python scripts/make_torch_hdf5_fixtures.py [--out DIR]

Writes ``tests/torch_data/hdf5/`` (or ``DIR``):

- ``latest_raw.slp``: ``tests/torch_data/raw.slp``'s objects (the labels of
  ``scripts/make_torch_slp_fixtures.py``, written by ``write_labels``) in a
  ``libver="latest"`` file whose root tracks creation order, in the order
  ``write_labels`` writes them; the frames ``video0_raw`` written as a
  recorder writes them under SWMR: ``maxshape=(None, 384, 384, 1)``, one
  frame a chunk, shuffle + lzf + fletcher32, appended one frame at a time
  with ``swmr_mode`` on (an extensible-array chunk index);
- ``features.h5`` (``libver="latest"``): a group of 300 links (a fractal heap
  with an indirect block, a name index B-tree of depth 1), a creation-ordered
  group, an object with 40 attributes and one past the heap's largest
  managed object (a huge object), the five chunk indexes (single chunk,
  filtered and not; implicit; a paged fixed array; an extensible array with
  secondary blocks; a version 2 B-tree of depth 1), lzf, fletcher32 and
  scale-offset (integers and floats), a committed datatype in use, object
  references, a soft link, external links to the sibling files, a dataset in
  the external raw file ``external.bin``, and a region reference and an
  nbit dataset (which the port refuses);
- ``features_earliest.h5`` (``libver="earliest"``): a soft link in a
  symbol-table group, lzf, fletcher32 and scale-offset behind version 1
  B-tree chunk indexes, a committed datatype, object references;
- ``manifest.json``: h5py's read of every object of the three files
  (``scripts/hdf5_manifest.py``), for the card, which has no h5py.

Groups are made with object times off (h5py's datasets already are), and
the times libhdf5 stamps on committed datatypes are zeroed (their header's
checksum recomputed), so the files are the same bytes on every run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import h5py  # noqa: E402

import hdf5_manifest  # noqa: E402
from sleap_tpu_torch.io.hdf5 import _lookup3  # noqa: E402

SEED = 21
OUT = os.path.join(REPO, "tests", "torch_data", "hdf5")
FILES = ("latest_raw.slp", "features.h5", "features_earliest.h5")
# What the port refuses, by file and path: the feature its error names.
REFUSED = {"features.h5": {"/region": "region references", "/nbit": "the nbit filter"}}
# write_labels' order of a .slp's root (the frames last, as a recorder adds them).
SLP_ORDER = ("metadata", "videos_json", "tracks_json", "suggestions_json", "frames", "instances",
             "points", "pred_points", "video0_raw")
ORDERED = h5py.h5p.CRT_ORDER_TRACKED | h5py.h5p.CRT_ORDER_INDEXED


def new_file(path: str, latest: bool, track_order: bool = False) -> h5py.File:
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST if latest else h5py.h5f.LIBVER_EARLIEST,
                           h5py.h5f.LIBVER_LATEST)
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)
    if track_order:
        fcpl.set_link_creation_order(ORDERED)
        fcpl.set_attr_creation_order(ORDERED)
    return h5py.File(h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fapl=fapl, fcpl=fcpl))


def group(parent, name: str, track_order: bool = False):
    """``parent.create_group(name, track_order=...)`` with object times off."""
    gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
    gcpl.set_obj_track_times(False)
    if track_order:
        gcpl.set_link_creation_order(ORDERED)
        gcpl.set_attr_creation_order(ORDERED)
    h5py.h5g.create(parent.id, name.encode(), gcpl=gcpl)
    return parent[name]


def zero_times(path: str) -> None:
    """Zero the times of every version 2 object header that stores them
    (libhdf5 stamps committed datatypes), and redo its checksum."""
    data = bytearray(open(path, "rb").read())
    at = data.find(b"OHDR")
    while at >= 0:
        flags = data[at + 5]
        if data[at + 4] == 2 and flags & 0x20:
            data[at + 6:at + 22] = bytes(16)
            p = at + 22 + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            end = p + width + int.from_bytes(data[p:p + width], "little")
            data[end:end + 4] = _lookup3(bytes(data[at:end])).to_bytes(4, "little")
        at = data.find(b"OHDR", at + 4)
    open(path, "wb").write(bytes(data))


def frames_like(n: int, rng, size=(40, 48)) -> np.ndarray:
    yy, xx = np.mgrid[:size[0], :size[1]]
    out = np.empty((n, *size, 1), np.uint8)
    for i in range(n):
        img = rng.integers(0, 8, size).astype(np.float64)
        img += 200 * np.exp(-((xx - 8 - 2 * i) ** 2 + (yy - 20) ** 2) / 80.0)
        out[i, ..., 0] = np.clip(img, 0, 255)
    return out


def write_latest_raw(path: str) -> None:
    """raw.slp's labels through ``write_labels``, copied into the latest
    format; the frames appended under SWMR."""
    import make_torch_slp_fixtures as slp_fixtures
    from sleap_tpu.io.slp import write_labels

    with tempfile.TemporaryDirectory() as tmp:
        src_path = os.path.join(tmp, "raw.slp")
        write_labels(src_path, slp_fixtures.fixture_labels())
        with h5py.File(src_path, "r") as src, new_file(path, True, track_order=True) as f:
            names = [n for n in SLP_ORDER if n in src] + [n for n in src if n not in SLP_ORDER]
            for name in names:
                obj = src[name]
                if isinstance(obj, h5py.Group):
                    dst = group(f, name)
                    assert not len(obj), f"{name}: a .slp group with members"
                elif name == "video0_raw":
                    frames = obj[()]
                    dst = f.create_dataset(name, shape=(0,) + frames.shape[1:], maxshape=(None,) + frames.shape[1:],
                                           dtype=frames.dtype, chunks=(1,) + frames.shape[1:], shuffle=True,
                                           compression="lzf", fletcher32=True)
                else:
                    dst = f.create_dataset(name, data=obj[()], dtype=obj.dtype)
                for key, value in obj.attrs.items():
                    dst.attrs[key] = value
            f.swmr_mode = True
            video = f["video0_raw"]
            for i, frame in enumerate(frames):
                video.resize(i + 1, axis=0)
                video[i] = frame
                video.flush()


def write_features(path: str, rng) -> None:
    with new_file(path, True) as f:
        many = group(f, "many")
        for i in range(300):
            many.create_dataset(f"d{i:03d}", data=np.array([i], "u4"))
        ordered = group(f, "ordered", track_order=True)
        for name in ("zeta", "alpha", "Mid", "beta", "b", "gamma", "a1", "z0", "k", "e"):
            ordered.create_dataset(name, data=np.array([len(name)], "i2"))
            ordered.attrs[name] = name.upper()
        attrs = f.create_dataset("many_attrs", data=np.arange(6, dtype="f4"))
        for i in range(40):
            attrs.attrs[f"attr{(17 * i) % 40:02d}"] = np.arange(i, dtype="i2")
        attrs.attrs["huge"] = np.linspace(0, 1, 1000)  # past the heap's largest managed object

        f.create_dataset("single", data=np.arange(60, dtype="<i4").reshape(6, 10), chunks=(6, 10))
        f.create_dataset("single_filtered", data=rng.normal(size=(6, 10)), chunks=(6, 10), compression="gzip",
                         shuffle=True)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((4, 3))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        f.create_dataset("implicit", shape=(10, 7), dtype="<u2", dcpl=dcpl)[...] = \
            np.arange(70, dtype="u2").reshape(10, 7)
        paged = f.create_dataset("fixed_paged", shape=(5000,), dtype="<u2", chunks=(2,), fillvalue=7,
                                 compression="lzf")
        paged[:900] = np.arange(900)  # the second of three pages never written: its bitmap bit is off
        paged[4500:4550] = 5
        grown = f.create_dataset("extensible", shape=(0, 3), maxshape=(None, 3), chunks=(1, 3), dtype="<i4",
                                 fletcher32=True)
        grown.resize(300, axis=0)  # past the index block's data blocks: secondary blocks
        grown[...] = np.arange(900, dtype="<i4").reshape(300, 3)
        two = f.create_dataset("btree2", shape=(30, 40), maxshape=(None, None), chunks=(2, 3), dtype="<i2",
                               scaleoffset=0)
        two[...] = rng.integers(-300, 300, (30, 40)).astype("<i2")
        f.create_dataset("lzf", data=frames_like(4, rng), chunks=(1, 40, 48, 1), compression="lzf",
                         shuffle=True, fletcher32=True)
        f.create_dataset("scaleoffset_f4", data=rng.normal(size=(33, 2)).astype("<f4"), chunks=(10, 2),
                         scaleoffset=3)
        filled = f.create_dataset("scaleoffset_fill", shape=(30,), dtype="<f8", chunks=(10,), scaleoffset=2,
                                  fillvalue=2.5)
        filled[3:17] = np.linspace(-1, 1, 14)

        f["point_t"] = np.dtype([("x", "<f8"), ("y", "<f8"), ("visible", "?")])
        point_t = f["point_t"]
        point_t.attrs["about"] = "a committed compound"
        points = np.zeros(5, point_t.dtype)
        points["x"], points["y"] = rng.normal(size=5), rng.normal(size=5)
        f.create_dataset("points", data=points, dtype=point_t)
        f["points"].attrs.create("origin", points[:1], dtype=point_t)

        refs = f.create_dataset("refs", data=[f["points"].ref, f["many"].ref, f["many/d007"].ref,
                                              h5py.Reference()], dtype=h5py.ref_dtype)
        refs.attrs["first"] = f["single"].ref
        f["soft"] = h5py.SoftLink("/single")
        f["external"] = h5py.ExternalLink("features_earliest.h5", "/old")
        f["external_slp"] = h5py.ExternalLink("latest_raw.slp", "/metadata")
        with open("external.bin", "wb") as fh:
            fh.write(b"header--" + np.arange(24, dtype="<i8").tobytes())
        f.create_dataset("external_storage", shape=(4, 6), dtype="<i8",
                         external=[("external.bin", 8, 96), ("external.bin", 104, h5py.h5f.UNLIMITED)])

        data = f["single"]
        f.create_dataset("region", data=[data.regionref[1:3, 2:5]], dtype=h5py.regionref_dtype)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((8,))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        f.create_dataset("nbit", shape=(16,), dtype="<i4", dcpl=dcpl)[...] = np.arange(16)
    zero_times(path)


def write_earliest(path: str, rng) -> None:
    with new_file(path, False) as f:
        old = group(f, "old")
        old.create_dataset("d", data=np.arange(10, dtype="<i8"))
        old["soft"] = h5py.SoftLink("/old/d")  # a symbol table entry of cache type 2
        old.attrs["style"] = "symbol table"
        f.create_dataset("lzf", data=frames_like(3, rng), chunks=(1, 40, 48, 1), compression="lzf")
        f.create_dataset("fletcher32", data=np.arange(1001, dtype="<u2"), chunks=(333,), fletcher32=True)
        f.create_dataset("scaleoffset", data=rng.integers(-50, 900, (40, 2)).astype("<i4"), chunks=(16, 2),
                         scaleoffset=0)
        f["int_t"] = np.dtype("<i2")
        f.create_dataset("typed", data=np.arange(5, dtype="<i2"), dtype=f["int_t"])
        f.create_dataset("refs", data=[f["old"].ref, f["typed"].ref], dtype=h5py.ref_dtype)
    zero_times(path)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=OUT)
    out = os.path.abspath(parser.parse_args().out)
    os.makedirs(out, exist_ok=True)
    here = os.getcwd()
    os.chdir(out)  # external.bin is named relative to the working directory
    try:
        rng = np.random.default_rng(SEED)
        write_latest_raw("latest_raw.slp")
        write_features("features.h5", rng)
        write_earliest("features_earliest.h5", rng)
        files = {}
        for name in FILES:
            with h5py.File(name, "r") as f:
                files[name] = {"refused": REFUSED.get(name, {}),
                               "objects": hdf5_manifest.manifest(f, REFUSED.get(name))}
        record = {"h5py": h5py.__version__, "hdf5": h5py.version.hdf5_version, "files": files}
        with open("manifest.json", "w") as fh:
            json.dump(record, fh, indent=1, sort_keys=True)
            fh.write("\n")
    finally:
        os.chdir(here)
    for name in (*FILES, "external.bin", "manifest.json"):
        print(f"wrote {os.path.join(out, name)}: {os.path.getsize(os.path.join(out, name))} bytes")


if __name__ == "__main__":
    main()
