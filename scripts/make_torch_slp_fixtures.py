"""Rebuild the ``.slp`` fixtures of the port's tests and ``chip_smoke.py``
phase 8b with the JAX package's writer (``sleap_tpu.io.slp.write_labels``),
from a seed; nothing is downloaded.

    JAX_PLATFORMS=cpu python scripts/make_torch_slp_fixtures.py

Writes ``tests/torch_data/raw.slp`` (the frames as a chunked, gzip
``video0_raw`` dataset) and ``tests/torch_data/pkg.slp`` (a training package:
the frames embedded as PNG rows with ``save_frame_data=True``, each PNG's
rows cycling through all five row filters, as ``scripts/png_decode_time.py``
encodes them, where cv2 would filter every row with Sub). Both hold
the same 8 frames of 384^2: two Gaussian blobs of sigma 14 px that move 3 px
a frame over faint noise, each labeled with a user instance of the
``minimal_instance`` skeleton (nodes A and B, 6 px either side of the
blob's centre along x), on tracks "left" and "right".
"""

from __future__ import annotations

import os
import sys
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from png_decode_time import FILTERS, encode  # noqa: E402

N_FRAMES, SIZE, SIGMA, AMPLITUDE, NOISE, SEED = 8, 384, 14.0, 200.0, 8, 0
STARTS = np.array([[110.0, 120.0], [270.0, 250.0]])
STEP = np.array([[3.0, 0.0], [0.0, -3.0]])
HALF_SPAN = 6.0


def fixture_frames():
    """(frames (n, H, W, 1) uint8, blob centres (n, 2, 2) xy)."""
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    centres = STARTS[None] + np.arange(N_FRAMES)[:, None, None] * STEP[None]
    frames = np.empty((N_FRAMES, SIZE, SIZE, 1), np.uint8)
    for i, points in enumerate(centres):
        img = rng.integers(0, NOISE, (SIZE, SIZE)).astype(np.float64)
        for x, y in points:
            img += AMPLITUDE * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * SIGMA**2))
        frames[i, ..., 0] = np.clip(img, 0, 255)
    return frames, centres


def every_filter_imencode(ext: str, img: np.ndarray):
    """``cv2.imencode`` for the writer's gray ``.png`` frames, with row y
    filtered by filter y % 5."""
    assert ext == ".png" and img.shape[-1] == 1
    return True, np.frombuffer(encode(img[..., 0], FILTERS.index("mixed")), np.uint8)


def fixture_labels():
    """The fixtures' labels, as the JAX package's ``Labels`` of an in-memory
    video of :func:`fixture_frames`."""
    from sleap_tpu.core.instance import Instance, LabeledFrame, Track
    from sleap_tpu.core.labels import Labels
    from sleap_tpu.core.skeleton import Skeleton
    from sleap_tpu.io.video import Video

    frames, centres = fixture_frames()
    skeleton = Skeleton("Skeleton-0")
    skeleton.add_node("A")
    skeleton.add_node("B")
    skeleton.add_edge("A", "B")
    tracks = [Track(spawned_on=0, name="left"), Track(spawned_on=0, name="right")]
    video = Video.from_numpy(frames)
    lfs = []
    for i, points in enumerate(centres):
        instances = [
            Instance(skeleton=skeleton, points=np.array([[x - HALF_SPAN, y], [x + HALF_SPAN, y]]),
                     track=track)
            for (x, y), track in zip(points, tracks)
        ]
        lfs.append(LabeledFrame(video=video, frame_idx=i, instances=instances))
    return Labels(labeled_frames=lfs)


def main() -> None:
    import cv2

    from sleap_tpu.core.labels import Labels
    from sleap_tpu.io.slp import write_labels

    lfs = fixture_labels().labeled_frames
    out = os.path.join(REPO, "tests", "torch_data")
    os.makedirs(out, exist_ok=True)
    for name, embed in (("raw.slp", False), ("pkg.slp", True)):
        path = os.path.join(out, name)
        with mock.patch.object(cv2, "imencode", every_filter_imencode):
            write_labels(path, Labels(labeled_frames=lfs), save_frame_data=embed)
        print(f"wrote {path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
