"""Frames embedded in HDF5 files, both ways between the port and the JAX
package, all exact (tolerance 0):

- the port's HDF5 writer (``sleap_tpu_torch.io.hdf5.Writer``): chunked,
  deflated datasets of every dtype and shape it writes, row assignment,
  multi-level chunk B-trees and the append mode, read back by ``h5py`` and
  by the port's own ``File``, bitwise;
- ``.pkg.slp`` training packages: JAX-written PNG, JPEG, BMP and TIFF rows
  read by the port's ``HDF5Video(device="cpu")`` as JAX's ``HDF5Video.get_frame`` reads
  them; port-written packages read by ``sleap_tpu.io.slp.read_labels`` to
  the same frames, frame numbers, instances and source video;
- ``save_frame_data_hdf5``, ``Video.to_hdf5`` and ``embed_all_labeled`` /
  ``embed_suggested`` against the JAX package's (the ImgStore exporters are
  ``tests/test_torch_imgstore.py``'s).
"""

from __future__ import annotations

import json
from pathlib import Path

import h5py
import numpy as np
import pytest

from sleap_tpu.core.instance import Instance as JInstance
from sleap_tpu.core.instance import LabeledFrame as JLabeledFrame
from sleap_tpu.core.labels import Labels as JLabels
from sleap_tpu.core.labels import SuggestionFrame as JSuggestion
from sleap_tpu.core.skeleton import Skeleton as JSkeleton
from sleap_tpu.io import slp as jslp
from sleap_tpu.io import video as jvideo
from sleap_tpu_torch.core.instance import Instance, LabeledFrame
from sleap_tpu_torch.core.labels import Labels, SuggestionFrame
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io import hdf5
from sleap_tpu_torch.io import slp as tslp
from sleap_tpu_torch.io import video as tvideo

REPO = Path(__file__).resolve().parent.parent
JPEG_PKG = REPO / "tests" / "torch_data" / "jpeg_pkg.slp"
RECORD = json.loads((REPO / "tests" / "torch_data" / "jpeg" / "decoded.json").read_text())


def _frames(n, h, w, c, seed):
    """Blobs over noise, as a camera sees animals."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = rng.integers(0, 30, (n, h, w, c)).astype(np.float64)
    img += 180 * np.exp(-((yy - h / 2) ** 2 + (xx - w / 3) ** 2) / 50.0)[None, ..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# The chunked writer
# --------------------------------------------------------------------------- #

_COMPOUND = np.dtype([("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("score", "<f4")])


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "int8_rows": rng.integers(-128, 127, (5, 3000), dtype=np.int8),
        "frames": rng.integers(0, 255, (3, 33, 17, 3), dtype=np.uint8),
        "big_frames": rng.integers(0, 255, (2, 200, 300, 1), dtype=np.uint8),
        "float32": rng.normal(size=(7, 9)).astype("<f4"),
        "float64_1d": rng.normal(size=20000),
        "int64": rng.integers(-9, 9, (300,), dtype=np.int64),
        "uint16": rng.integers(0, 9999, (4, 5, 6), dtype=np.uint16),
        "compound": np.array([(1.5, -2.0, True, 0.25)] * 11, _COMPOUND),
        "bool": np.array([True, False, True]),
        "fixed_strings": np.array([b"abc", b"d", b""], "S3"),
    }


@pytest.mark.parametrize("name", sorted(_arrays()))
@pytest.mark.parametrize("level", [None, 1, 9])
def test_chunked_datasets_read_back_bitwise(name, level, tmp_path):
    arr = _arrays()[name]
    path = str(tmp_path / "x.h5")
    with hdf5.Writer(path) as f:
        if level is None:
            f.create_dataset(name, data=arr, compression=None, chunks=(1,) + arr.shape[1:])
        else:
            f.create_dataset(name, data=arr, compression="gzip", compression_opts=level)
    with h5py.File(path, "r") as f:
        ds = f[name]
        assert ds.dtype == arr.dtype and ds.shape == arr.shape
        assert ds.chunks is not None
        assert ds.compression == (None if level is None else "gzip")
        if level is not None:
            assert ds.compression_opts == level
        np.testing.assert_array_equal(ds[()], arr)
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f[name][...], arr)
        if len(arr) > 1:
            np.testing.assert_array_equal(f[name][1], arr[1])


def test_default_chunks_are_one_frame_or_64_kib(tmp_path):
    """One encoded or raw frame a chunk; smaller rows grouped to 64 KiB."""
    path = str(tmp_path / "x.h5")
    arrays = _arrays()
    with hdf5.Writer(path) as f:
        for name in ("big_frames", "int8_rows", "float64_1d"):
            f.create_dataset(name, data=arrays[name])
    with h5py.File(path, "r") as f:
        assert f["big_frames"].chunks == (1, 200, 300, 1)
        assert f["int8_rows"].chunks == (5, 3000)
        assert f["float64_1d"].chunks == (8192,)


def test_many_chunks_need_a_deeper_chunk_tree(tmp_path):
    """More chunks than a B-tree node holds (64): internal nodes."""
    arr = np.arange(3 * 700, dtype=np.int32).reshape(700, 3)
    path = str(tmp_path / "x.h5")
    with hdf5.Writer(path) as f:
        f.create_dataset("rows", data=arr, chunks=(1, 3))
        f.create_dataset("partial", data=arr[:, :2], chunks=(3, 2))  # an edge chunk
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["rows"][()], arr)
        np.testing.assert_array_equal(f["rows"][345:351], arr[345:351])
        np.testing.assert_array_equal(f["partial"][()], arr[:, :2])
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["rows"][...], arr)
        np.testing.assert_array_equal(f["partial"][699], arr[699, :2])


def test_row_assignment_and_attributes(tmp_path):
    """``dset[i, :n] = row`` as the embedders fill encoded rows."""
    rows = [np.arange(n, dtype=np.int8) for n in (5, 9, 2)]
    path = str(tmp_path / "x.h5")
    with hdf5.Writer(path) as f:
        ds = f.create_dataset("video0/video", shape=(3, 9), dtype="int8", chunks=(1, 9))
        for i, r in enumerate(rows):
            ds[i, :len(r)] = r
        ds.attrs["format"] = "png"
        ds.attrs["height"] = 4
    want = np.zeros((3, 9), np.int8)
    for i, r in enumerate(rows):
        want[i, :len(r)] = r
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["video0/video"][()], want)
        assert f["video0/video"].attrs["format"] == "png"  # a str, stored as h5py stores one
        assert f["video0/video"].attrs["height"] == 4


def test_append_mode_keeps_what_the_file_holds(tmp_path):
    path = str(tmp_path / "x.h5")
    arrays = _arrays()
    with h5py.File(path, "w") as f:  # written by h5py: chunked with shuffle, and contiguous
        f.create_dataset("a/shuffled", data=arrays["float32"], compression="gzip", shuffle=True)
        f.create_dataset("plain", data=arrays["int64"])
        f["plain"].attrs["note"] = np.bytes_(b"kept")
    with hdf5.Writer(path, "a") as f:
        f.create_dataset("b/new", data=arrays["frames"])
        with pytest.raises(ValueError, match="already exists"):
            f.create_dataset("plain", data=arrays["int64"])
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["a/shuffled"][()], arrays["float32"])
        assert f["a/shuffled"].compression == "gzip"
        np.testing.assert_array_equal(f["plain"][()], arrays["int64"])
        assert f["plain"].attrs["note"] == b"kept"
        np.testing.assert_array_equal(f["b/new"][()], arrays["frames"])


# --------------------------------------------------------------------------- #
# Training packages
# --------------------------------------------------------------------------- #


def _jax_project(frames, labeled=(0, 2, 3), predicted=(), suggested=()):
    from sleap_tpu.core.instance import PredictedInstance as JPredicted

    skeleton = JSkeleton("s")
    skeleton.add_node("A")
    skeleton.add_node("B")
    video = jvideo.Video.from_numpy(frames)
    lfs = [JLabeledFrame(video, i, [JInstance(skeleton=skeleton, points=np.array(
        [[1.0 + i, 2.0], [3.0, 4.0 + i]]))]) for i in labeled]
    lfs += [JLabeledFrame(video, i, [JPredicted(skeleton=skeleton, points=np.array(
        [[5.0, 6.0], [7.0, 8.0]]), score=0.5)]) for i in predicted]
    labels = JLabels(labeled_frames=sorted(lfs, key=lambda lf: lf.frame_idx))
    labels.suggestions = [JSuggestion(video, i) for i in suggested]
    return labels


def _port_project(frames, labeled=(0, 2, 3), predicted=(), suggested=()):
    from sleap_tpu_torch.core.instance import PredictedInstance

    skeleton = Skeleton("s")
    skeleton.add_node("A")
    skeleton.add_node("B")
    video = tvideo.Video.from_numpy(frames)
    lfs = [LabeledFrame(video, i, [Instance(skeleton, np.array([[1.0 + i, 2.0], [3.0, 4.0 + i]]))])
           for i in labeled]
    lfs += [LabeledFrame(video, i, [PredictedInstance.from_arrays(
        np.array([[5.0, 6.0], [7.0, 8.0]]), np.ones(2), 0.5, skeleton)]) for i in predicted]
    labels = Labels(lfs)
    labels.suggestions = [SuggestionFrame(video, i) for i in suggested]
    return labels


@pytest.mark.parametrize("fmt", ["png", "jpg", "bmp", "tif"])
@pytest.mark.parametrize("channels", [1, 3])
def test_jax_written_packages_read_by_the_port(fmt, channels, tmp_path):
    frames = _frames(5, 24, 40, channels, seed=channels)
    path = str(tmp_path / "x.pkg.slp")
    jslp.write_labels(path, _jax_project(frames), save_frame_data=True, image_format=fmt)
    mine = tslp.read_labels(path, device="cpu").video
    ref = jslp.read_labels(path).videos[0]
    assert mine.backend.embedded_frame_inds == ref.backend.embedded_frame_inds == [0, 2, 3]
    assert mine.shape == ref.shape
    for i in (0, 2, 3):
        got, want = mine.get_frame(i), ref.get_frame(i)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert mine.backend.source_video.backend.filename == "numpy_video"


@pytest.mark.parametrize("row", [0, 15])
def test_committed_jpeg_package_read_by_the_port(row):
    """The phase-13 package: the port's plain route, JAX's cv2 and the
    recorded hash give the same frame."""
    import hashlib

    mine = tslp.read_labels(str(JPEG_PKG), device="cpu").video
    ref = jslp.read_labels(str(JPEG_PKG)).videos[0]
    got = mine.get_frame(row)
    np.testing.assert_array_equal(got, ref.get_frame(row))
    assert hashlib.sha256(got[..., 0].tobytes()).hexdigest() == RECORD["package"][row]["sha256"]


def _assert_same_package(path, frames, nums):
    """JAX reads the port's package: frames, frame numbers, source video,
    instances."""
    ref = jslp.read_labels(path)
    video = ref.videos[0]
    assert type(video.backend).__name__ == "HDF5Video"
    assert video.backend.embedded_frame_inds == list(nums)
    for i in nums:
        np.testing.assert_array_equal(video.get_frame(i), frames[i])
    assert video.backend.source_video.backend.filename == "numpy_video"
    mine = tslp.read_labels(path, device="cpu")
    assert [lf.frame_idx for lf in ref] == [lf.frame_idx for lf in mine]
    for a, b in zip(ref, mine):
        for x, y in zip(a.instances, b.instances):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    with h5py.File(path, "r") as f:
        assert json.loads(f["videos_json"][0])["backend"]["filename"] == "."
        assert f["video0/video"].compression == "gzip" and f["video0/video"].chunks[0] == 1
        assert f["video0/video"].attrs["format"] in (b"png", "png")


@pytest.mark.parametrize("channels", [1, 3])
def test_port_written_packages_read_by_jax(channels, tmp_path):
    frames = _frames(5, 30, 20, channels, seed=7)
    path = str(tmp_path / "x.pkg.slp")
    _port_project(frames).save(path, with_images=True)
    _assert_same_package(path, frames, [0, 2, 3])
    with h5py.File(path, "r") as f:
        for key in ("height", "width", "channels"):
            assert f["video0/video"].attrs[key] == {"height": 30, "width": 20,
                                                    "channels": channels}[key]


@pytest.mark.parametrize("all_labeled,suggested,want", [
    (False, False, [0, 2]), (True, False, [0, 1, 2, 4]), (False, True, [0, 2, 3]),
    (True, True, [0, 1, 2, 3, 4])])
def test_embed_all_labeled_and_suggested_match_jax(all_labeled, suggested, want, tmp_path):
    frames = _frames(5, 16, 16, 1, seed=3)
    mine, ref = str(tmp_path / "mine.slp"), str(tmp_path / "ref.slp")
    _port_project(frames, labeled=(0, 2), predicted=(1, 4), suggested=(3,)).save(
        mine, with_images=True, embed_all_labeled=all_labeled, embed_suggested=suggested)
    _jax_project(frames, labeled=(0, 2), predicted=(1, 4), suggested=(3,)).save(
        ref, with_images=True, embed_all_labeled=all_labeled, embed_suggested=suggested)
    for path in (mine, ref):
        video = jslp.read_labels(path).videos[0]
        assert video.backend.embedded_frame_inds == want
        for i in want:
            np.testing.assert_array_equal(video.get_frame(i), frames[i])


def test_save_frame_data_hdf5_matches_jax(tmp_path):
    frames = [_frames(4, 20, 24, 1, seed=1), _frames(3, 12, 10, 3, seed=2)]
    mine_labels, ref_labels = _port_project(frames[0]), _jax_project(frames[0])
    second = tvideo.Video.from_numpy(frames[1])
    mine_labels.labeled_frames.append(LabeledFrame(second, 1, [Instance(
        mine_labels.skeletons[0], np.array([[1.0, 1.0], [2.0, 2.0]]))]))
    mine_labels.update_cache()
    jsecond = jvideo.Video.from_numpy(frames[1])
    ref_labels.labeled_frames.append(JLabeledFrame(jsecond, 1, [JInstance(
        skeleton=ref_labels.skeletons[0], points=np.array([[1.0, 1.0], [2.0, 2.0]]))]))
    ref_labels = JLabels(labeled_frames=ref_labels.labeled_frames)
    mine, ref = str(tmp_path / "mine.h5"), str(tmp_path / "ref.h5")
    got = mine_labels.save_frame_data_hdf5(mine, device="cpu")
    want = ref_labels.save_frame_data_hdf5(ref)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.backend.dataset == w.backend.dataset
        for i in w.backend.embedded_frame_inds:
            np.testing.assert_array_equal(g.get_frame(i), w.get_frame(i))
    with h5py.File(mine, "r") as fm, h5py.File(ref, "r") as fr:
        for key in ("video0/frame_numbers", "video1/frame_numbers"):
            np.testing.assert_array_equal(fm[key][()], fr[key][()])
        for v in ("video0", "video1"):
            assert json.loads(fm[v + "/source_video"].attrs["json"]) == \
                json.loads(fr[v + "/source_video"].attrs["json"])
    # JAX reads the port's file.
    jread = jvideo.Video.from_hdf5("video1/video", mine)
    np.testing.assert_array_equal(jread.get_frame(1), frames[1][1])


@pytest.mark.parametrize("fmt", ["", "png"])
def test_to_hdf5_matches_jax(fmt, tmp_path):
    frames = _frames(4, 18, 22, 3, seed=5)
    mine, ref = str(tmp_path / "mine.h5"), str(tmp_path / "ref.h5")
    got = tvideo.Video.from_numpy(frames).to_hdf5(mine, "clip", [1, 3], format=fmt, device="cpu")
    want = jvideo.Video.from_numpy(frames).to_hdf5(ref, "clip", [1, 3], format=fmt)
    for i in (1, 3):
        np.testing.assert_array_equal(got.get_frame(i), want.get_frame(i))
        np.testing.assert_array_equal(got.get_frame(i), frames[i])
    with h5py.File(mine, "r") as f:
        if not fmt:
            assert f["clip/video"].compression_opts == 9
            np.testing.assert_array_equal(f["clip/video"][()], frames[[1, 3]])
        assert list(f["clip/frame_numbers"][()]) == [1, 3]
    # JAX reads the port's file; and a second video joins the same file.
    np.testing.assert_array_equal(jvideo.Video.from_hdf5("clip/video", mine).get_frame(3),
                                  frames[3])
    tvideo.Video.from_numpy(frames).to_hdf5(mine, "other", [0], format=fmt, device="cpu")
    with h5py.File(mine, "r") as f:
        assert sorted(f) == ["clip", "other"]


def test_jpeg_writing_raises_naming_the_roadmap_item(tmp_path):
    """JPEG, BMP and TIFF rows (``Video.to_hdf5`` and
    ``save_frame_data_hdf5`` with ``format="jpg"``, ``"bmp"`` or ``"tif"``)
    are byte-equal to the JAX package's, which cv2 encodes; a format the
    port does not write raises naming the ones it does."""
    for fmt in ("jpg", "bmp", "tif"):
        for channels in (1, 3):
            frames = _frames(4, 21, 35, channels, seed=channels)
            mine = str(tmp_path / f"mine_{fmt}{channels}.h5")
            ref = str(tmp_path / f"ref_{fmt}{channels}.h5")
            tvideo.Video.from_numpy(frames).to_hdf5(mine, "v", [0, 2, 3], format=fmt, device="cpu")
            jvideo.Video.from_numpy(frames).to_hdf5(ref, "v", [0, 2, 3], format=fmt)
            _port_project(frames).save_frame_data_hdf5(mine, format=fmt, device="cpu")
            _jax_project(frames).save_frame_data_hdf5(ref, format=fmt)
            with h5py.File(mine, "r") as fm, h5py.File(ref, "r") as fr:
                for key in ("v/video", "video0/video"):
                    np.testing.assert_array_equal(fm[key][()], fr[key][()])
                    for attr in ("format", "channels", "height", "width"):  # bytes or str
                        a, b = fm[key].attrs[attr], fr[key].attrs[attr]
                        assert (a.decode() if isinstance(a, bytes) else a) == b
    video = tvideo.Video.from_numpy(_frames(2, 8, 8, 1, seed=0))
    with pytest.raises(NotImplementedError, match="'webp'.*png, jpg, jpeg, bmp, tif, tiff"):
        video.to_hdf5(str(tmp_path / "x.h5"), "v", format="webp", device="cpu")


def test_raw_in_memory_videos_are_written_deflated(tmp_path):
    """A project over an in-memory video writes its frames as a gzip
    ``video0_raw``, as the JAX package does; both read it back."""
    frames = _frames(3, 40, 30, 1, seed=9)
    path = str(tmp_path / "raw.slp")
    _port_project(frames, labeled=(0, 1)).save(path)
    with h5py.File(path, "r") as f:
        assert f["video0_raw"].compression == "gzip"
        np.testing.assert_array_equal(f["video0_raw"][()], frames)
    np.testing.assert_array_equal(jslp.read_labels(path).videos[0].get_frame(2), frames[2])
    np.testing.assert_array_equal(tslp.read_labels(path, device="cpu").video.get_frame(2),
                                  frames[2])
