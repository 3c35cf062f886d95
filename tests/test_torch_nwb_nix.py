"""The port's NWB and NIX adaptors (``sleap_tpu_torch.io.formats.ndx_pose``
and ``nix``) against the JAX package's, as ``tests/io/test_nwb_nix.py``
tests the JAX ones: the same projects, built in each package from a seed,
give the same pose arrays and the same nixtrack arrays and maps exactly (NaN
equal to NaN), the pose arrays go back to the same frames, ``_check_video``
refuses alike, and where ``pynwb``/``ndx_pose`` or ``nixio`` is absent
(as here) every reader and writer raises the JAX package's ``ImportError``
naming the package.
"""

from __future__ import annotations

import numpy as np
import pytest

from sleap_tpu.io.formats import ndx_pose as j_ndx
from sleap_tpu.io.formats import nix as j_nix
from sleap_tpu_torch.io.formats import ndx_pose as t_ndx
from sleap_tpu_torch.io.formats import nix as t_nix
from test_torch_data_model import JAX, TORCH, make_project

PAIRS = ((TORCH, t_ndx, t_nix), (JAX, j_ndx, j_nix))


def two_tracks(P):
    """``tests/io/test_nwb_nix.py``'s project: three frames of a 4-frame
    video, two tracked predictions each."""
    skel = P.Skeleton.from_names_and_edge_inds(["a", "b", "c"], [(0, 1), (1, 2)], name="S")
    video = P.Video.from_numpy(np.zeros((4, 32, 32, 1), np.uint8))
    t0, t1 = P.Track(0, "t0"), P.Track(0, "t1")
    lfs = []
    for i in range(3):
        insts = [
            P.PredictedInstance.from_arrays(points=np.full((3, 2), base + i), point_confidences=np.full(3, c),
                                            instance_score=c, skeleton=skel, track=t)
            for base, c, t in ((10.0, 0.9, t0), (20.0, 0.8, t1))
        ]
        lfs.append(P.LabeledFrame(video=video, frame_idx=i, instances=insts))
    return P.Labels(lfs)


def one_untracked(P):
    skel = P.Skeleton.from_names_and_edge_inds(["a"], [], name="S")
    video = P.Video.from_numpy(np.zeros((2, 16, 16, 1), np.uint8))
    inst = P.PredictedInstance.from_arrays(points=np.array([[1.0, 2.0]]), point_confidences=np.array([0.5]),
                                           instance_score=0.5, skeleton=skel)
    return P.Labels([P.LabeledFrame(video=video, frame_idx=0, instances=[inst])])


def seeded(P, seed):
    """``test_torch_data_model.py``'s project: two videos, tracked and
    untracked predictions, user instances, NaN and invisible points."""
    return make_project(P, seed, two_skeletons=False)


PROJECTS = {"two_tracks": two_tracks, "one_untracked": one_untracked,
            "seeded0": lambda P: seeded(P, 0), "seeded3": lambda P: seeded(P, 3)}


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b)
    else:
        assert a == b


def _frames(lfs):
    return [(lf.frame_idx, [(inst.track.name if inst.track else None, inst.numpy(), inst.scores,
                             inst.score) for inst in lf.instances]) for lf in lfs]


@pytest.mark.parametrize("name", sorted(PROJECTS))
def test_pose_arrays_and_their_frames_match_jax(name):
    results = []
    for P, ndx, _ in PAIRS:
        labels = PROJECTS[name](P)
        per_video = []
        for video in labels.videos:
            arr, untracked = ndx.labels_to_pose_arrays(labels, video)
            lfs = ndx.tracks_numpy_to_labeled_frames(arr[..., :2], arr[..., 2], not untracked, video,
                                                     labels.skeleton)
            # Every instance comes back with its points as they went.
            for lf in lfs:
                for inst in lf.instances:
                    rows = [k for k in range(arr.shape[1])
                            if np.array_equal(arr[lf.frame_idx, k, :, :2], inst.numpy(), equal_nan=True)]
                    assert rows, (lf.frame_idx, inst)
            assert all((inst.track is not None) == (not untracked) for lf in lfs for inst in lf.instances)
            per_video.append((arr, untracked, _frames(lfs)))
        results.append(per_video)
    _same(results[0], results[1])


def test_pose_arrays_span_the_whole_video():
    for P, ndx, _ in PAIRS:
        labels = two_tracks(P)
        arr, untracked = ndx.labels_to_pose_arrays(labels, labels.video)
        assert arr.shape == (4, 2, 3, 3) and not untracked
        np.testing.assert_allclose(arr[0, 0, :, 2], 0.9)
        np.testing.assert_allclose(arr[1, 1, :, :2], 21.0)
        labels = one_untracked(P)
        arr, untracked = ndx.labels_to_pose_arrays(labels, labels.video)
        assert arr.shape == (2, 1, 1, 3) and untracked


@pytest.mark.parametrize("name", sorted(PROJECTS))
def test_nix_arrays_match_jax(name):
    results = []
    for P, _, nix in PAIRS:
        labels = PROJECTS[name](P)
        results.append([nix.assemble_nix_arrays(labels, video) for video in labels.videos])
    _same(results[0], results[1])
    data = results[0][0]
    if name == "two_tracks":
        np.testing.assert_array_equal(data["arrays"]["frame"], [0, 0, 1, 1, 2, 2])
        np.testing.assert_array_equal(data["arrays"]["track"], [0, 1, 0, 1, 0, 1])
        assert data["maps"]["track_map"][0] == ("none", -1, -1) and ("t0", 0, 0) in data["maps"]["track_map"]


@pytest.mark.parametrize("case", ["not_in_project", "no_videos", "no_frames", "default"])
def test_nix_check_video_matches_jax(case):
    outcomes = []
    for P, _, nix in PAIRS:
        labels = two_tracks(P)
        if case == "not_in_project":
            args = (labels, P.Video.from_numpy(np.zeros((2, 8, 8, 1), np.uint8)))
        elif case == "no_videos":
            args = (P.Labels([]), None)
        elif case == "no_frames":
            extra = P.Video.from_numpy(np.zeros((2, 8, 8, 1), np.uint8))
            labels.add_video(extra)
            args = (labels, extra)
        else:
            args = (labels, None)
        try:
            outcomes.append(labels.videos.index(nix._check_video(*args)))
        except ValueError as e:
            outcomes.append(str(e).split(" ")[0] + str(e).split(".")[-2])
    assert outcomes[0] == outcomes[1]
    if case != "default":
        assert isinstance(outcomes[0], str)


def _absent(package: str) -> bool:
    try:
        __import__(package)
    except ImportError:
        return True
    return False


@pytest.mark.parametrize("call", ["ndx_pose.write_labels", "ndx_pose.read_labels", "nix.write_labels"])
def test_readers_and_writers_raise_the_jax_import_error(call, tmp_path):
    module, fn = call.split(".")
    package = "nixio" if module == "nix" else "pynwb"
    if not _absent(package):
        pytest.skip(f"{package} is installed")
    messages = []
    for P, ndx, nix in PAIRS:
        target = getattr(nix if module == "nix" else ndx, fn)
        path = str(tmp_path / f"out.{module}")
        with pytest.raises(ImportError, match=package) as e:
            target(path) if fn == "read_labels" else target(path, two_tracks(P))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert not list(tmp_path.iterdir())
