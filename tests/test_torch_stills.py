"""BMP and TIFF stills through both packages on the CPU, on the same seeded
frames, all exact (tolerance 0) but predictions:

- ``SingleImageVideo`` folders of 8- and 16-bit TIFF (gray, RGB, RGBA, and
  float32) and of BMP (gray, BGR, BGRA), written by cv2, give the JAX
  package's frames (``load_video`` of the folder, grayscale or not);
- ``Video.to_hdf5(format="tif" | "bmp")``: the JAX package's file read by
  the port and the port's read by JAX give equal frames;
- ``Labels.save(image_format="tif" | "bmp")`` writes rows equal to JAX's
  ``write_labels(save_frame_data=True, image_format=...)``;
- ``to_imgstore(format="tif" | "bmp")`` writes the JAX package's files and
  both read them to the same frames;
- ``predict`` with the trained ``.convergence_runs/minimal_instance`` pair
  on a TIFF image folder (of ``tests/torch_data/raw.slp``'s frames) agrees
  with the JAX predictor on the same folder within 0.05 px and 1e-3.
"""

from __future__ import annotations

import os
from pathlib import Path

import cv2
import h5py
import jax
import numpy as np
import pytest

import sleap_tpu as jsleap
from sleap_tpu.core.instance import Instance as JInstance
from sleap_tpu.core.instance import LabeledFrame as JLabeledFrame
from sleap_tpu.core.labels import Labels as JLabels
from sleap_tpu.core.skeleton import Skeleton as JSkeleton
from sleap_tpu.io import dirimgstore as jstore
from sleap_tpu.io import slp as jslp
from sleap_tpu.io import video as jvideo
from sleap_tpu_torch.core.instance import Instance, LabeledFrame
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.io import dirimgstore as tstore
from sleap_tpu_torch.io import slp as tslp
from sleap_tpu_torch.io import video as tvideo

REPO = Path(__file__).resolve().parent.parent
RUNS = REPO / ".convergence_runs"
PAIR = [str(RUNS / "minimal_instance.UNet.centroid"), str(RUNS / "minimal_instance.UNet.centered_instance")]
PREDICT_XY_TOL, PREDICT_VAL_TOL = 0.05, 1e-3


def _frames(n, h, w, channels, seed, dtype=np.uint8):
    """Blobs on a gradient with some noise; 16-bit frames at 12 bits."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = 40 + 60 * ((xx + yy) / (h + w))[None, ..., None] + rng.normal(0, 4, (n, h, w, channels))
    img += 150 * np.exp(-((yy - h / 2) ** 2 + (xx - w / 3) ** 2) / 40.0)[None, ..., None]
    img = np.clip(img, 0, 255)
    if dtype == np.uint16:
        return (img * 16).astype(np.uint16)
    if dtype == np.float32:
        return (img / 255).astype(np.float32)
    return img.astype(np.uint8)


FOLDERS = {
    "tif gray": ("tif", 1, np.uint8), "tif rgb": ("tif", 3, np.uint8), "tif rgba": ("tif", 4, np.uint8),
    "tif gray16": ("tif", 1, np.uint16), "tif rgb16": ("tif", 3, np.uint16),
    "tif float": ("tif", 1, np.float32),
    "bmp gray": ("bmp", 1, np.uint8), "bmp bgr": ("bmp", 3, np.uint8), "bmp bgra": ("bmp", 4, np.uint8),
}


@pytest.mark.parametrize("grayscale", [None, True])
@pytest.mark.parametrize("kind", sorted(FOLDERS))
def test_single_image_folders_match_jax(kind, grayscale, tmp_path):
    ext, channels, dtype = FOLDERS[kind]
    frames = _frames(3, 30, 44, channels, seed=channels, dtype=dtype)
    for i, img in enumerate(frames):
        assert cv2.imwrite(str(tmp_path / f"img{i}.{ext}"), img[..., 0] if channels == 1 else img)
    mine = tvideo.load_video(str(tmp_path), grayscale=grayscale, device="cpu")
    ref = jvideo.load_video(str(tmp_path), grayscale=grayscale)
    assert type(mine.backend).__name__ == "SingleImageVideo"
    assert mine.shape == ref.shape
    got, want = mine[:], ref[:]
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert mine.backend.is_grayscale == ref.backend.is_grayscale
    assert mine.to_dict() == ref.to_dict()


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("fmt", ["tif", "bmp"])
def test_to_hdf5_files_read_across_packages(fmt, channels, tmp_path):
    frames = _frames(5, 21, 35, channels, seed=channels)
    nums = [0, 2, 3]
    mine, ref = str(tmp_path / "mine.h5"), str(tmp_path / "ref.h5")
    tvideo.Video.from_numpy(frames).to_hdf5(mine, "v", nums, format=fmt, device="cpu")
    jvideo.Video.from_numpy(frames).to_hdf5(ref, "v", nums, format=fmt)
    port_reads_jax = tvideo.Video.from_hdf5("v/video", ref, device="cpu")
    jax_reads_port = jvideo.Video.from_hdf5("v/video", mine)
    for video in (port_reads_jax, jax_reads_port):
        np.testing.assert_array_equal(np.stack([video.get_frame(i) for i in nums]), frames[nums])
    with h5py.File(mine, "r") as fm, h5py.File(ref, "r") as fr:
        np.testing.assert_array_equal(fm["v/video"][()], fr["v/video"][()])


def _projects(frames):
    jskel, tskel = JSkeleton("s"), Skeleton("s")
    for skel in (jskel, tskel):
        skel.add_node("a")
        skel.add_node("b")
    jv, tv = jvideo.Video.from_numpy(frames), tvideo.Video.from_numpy(frames)
    pts = np.array([[3.0, 4.0], [10.0, 12.0]])
    jl = JLabels([JLabeledFrame(video=jv, frame_idx=i, instances=[JInstance(skeleton=jskel, points=pts)])
                  for i in (0, 2, 3)])
    tl = Labels([LabeledFrame(tv, i, [Instance(tskel, pts)]) for i in (0, 2, 3)])
    return jl, tl


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("fmt", ["tif", "bmp"])
def test_labels_save_writes_jax_rows(fmt, channels, tmp_path):
    frames = _frames(4, 24, 31, channels, seed=10 + channels)
    jl, tl = _projects(frames)
    mine, ref = str(tmp_path / "mine.pkg.slp"), str(tmp_path / "ref.pkg.slp")
    tl.save(mine, with_images=True, image_format=fmt, device="cpu")
    jslp.write_labels(ref, jl, save_frame_data=True, image_format=fmt)
    with h5py.File(mine, "r") as fm, h5py.File(ref, "r") as fr:
        np.testing.assert_array_equal(fm["video0/video"][()], fr["video0/video"][()])
        np.testing.assert_array_equal(fm["video0/frame_numbers"][()], fr["video0/frame_numbers"][()])
        a, b = fm["video0/video"].attrs["format"], fr["video0/video"].attrs["format"]  # bytes or str
        assert (a.decode() if isinstance(a, bytes) else a) == (b.decode() if isinstance(b, bytes) else b)
    got = tslp.read_labels(mine, device="cpu").video
    want = jslp.read_labels(ref).videos[0]
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got.get_frame(i), want.get_frame(i))
        np.testing.assert_array_equal(got.get_frame(i), frames[i])


@pytest.mark.parametrize("fmt", ["tif", "bmp"])
def test_to_imgstore_writes_jax_files(fmt, tmp_path):
    frames = _frames(4, 20, 26, 3, seed=20)
    nums = [1, 2, 3]
    mine = tvideo.Video.from_numpy(frames).to_imgstore(str(tmp_path / "mine"), nums, format=fmt,
                                                       device="cpu")
    jvideo.Video.from_numpy(frames).to_imgstore(str(tmp_path / "ref"), nums, format=fmt)
    for i in range(len(nums)):
        name = os.path.join("000000", "%06d.%s" % (i, fmt))
        assert (tmp_path / "mine" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    ref = jstore.new_for_filename(str(tmp_path / "ref"))
    back = tstore.new_for_filename(str(tmp_path / "ref"), device="cpu")
    for n in nums:
        np.testing.assert_array_equal(back.get_image(frame_number=n)[0], ref.get_image(frame_number=n)[0])
        np.testing.assert_array_equal(mine.get_frame(n), frames[n])


@pytest.fixture
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def test_predict_on_a_tiff_folder_matches_jax(tmp_path, _highest_precision):
    """The trained top-down pair on ``raw.slp``'s eight 384^2 frames, stored
    as TIFF stills (the frames a labelling project exported as TIFF)."""
    raw = tslp.read_labels(str(REPO / "tests" / "torch_data" / "raw.slp"), device="cpu").video[:]
    for i, img in enumerate(raw):
        assert cv2.imwrite(str(tmp_path / f"frame{i:02d}.tif"), img[..., 0])
    tpred = tp.load_model(PAIR, device="cpu", peak_threshold=0.05, batch_size=4)
    jpred = jsleap.load_model(PAIR, peak_threshold=0.05, batch_size=4)
    got = tpred.predict(tvideo.load_video(str(tmp_path), device="cpu"))
    want = jpred.predict(jvideo.load_video(str(tmp_path)))
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    assert sum(len(lf.instances) for lf in got) >= len(raw)
    for a, b in zip(got, want):
        assert len(a.instances) == len(b.instances)
        for x, y in zip(a.instances, b.instances):
            np.testing.assert_allclose(np.nan_to_num(x.numpy()), np.nan_to_num(y.numpy()),
                                       atol=PREDICT_XY_TOL)
            assert abs(x.score - y.score) <= PREDICT_VAL_TOL
            np.testing.assert_allclose(np.nan_to_num(x.scores), np.nan_to_num(y.scores),
                                       atol=PREDICT_VAL_TOL)
