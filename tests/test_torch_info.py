"""The port's host modules of ``info/`` and ``io/pathutils.py``, and the
tracker's re-tracking ``main``, against the JAX package's, on the CPU.

Each function runs on the same seeded project (``test_torch_data_model.py``'s
``make_project``, built in each package) or the same arrays, and must give
the same values exactly (NaN equal to NaN; suggestions as (video, frame,
group)). ``pathutils`` runs on the same files with each package's prefix
store in a temporary folder, and each package reads the store the other
wrote. Re-tracking: the port's ``sleap-track`` predicts ``raw.slp`` with the
trained top-down pair, and the two packages' tracker ``main`` (flow, the
port's with ``--cpu``) re-track that file: the same tracks by name, tracking
scores within 1e-4 (flow in each framework; ``test_torch_cli_track.py``'s
tolerance); then each package's
``trackcleaner`` culls the result to one animal a frame, alike.
"""

from __future__ import annotations

import os
import random
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from sleap_tpu.info import align as j_align
from sleap_tpu.info import metrics as j_metrics
from sleap_tpu.info import suggestions as j_suggestions
from sleap_tpu.info import summary as j_summary
from sleap_tpu.info import trackcleaner as j_trackcleaner
from sleap_tpu.io import pathutils as j_pathutils
from sleap_tpu.io.slp import read_labels as jread
from sleap_tpu.tracking import tracker as j_tracker
from sleap_tpu_torch.cli import track as ttrack
from sleap_tpu_torch.info import align as t_align
from sleap_tpu_torch.info import metrics as t_metrics
from sleap_tpu_torch.info import suggestions as t_suggestions
from sleap_tpu_torch.info import summary as t_summary
from sleap_tpu_torch.info import trackcleaner as t_trackcleaner
from sleap_tpu_torch.io import pathutils as t_pathutils
from sleap_tpu_torch.tracking import tracker as t_tracker
from test_torch_data_model import JAX, TORCH, make_project

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RUNS = REPO / ".convergence_runs"
RAW = REPO / "tests" / "torch_data" / "raw.slp"
TRACK_SCORE_TOL = 1e-4


def _same(a, b):
    """Equal values: arrays bitwise with NaN equal to NaN, containers by item."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not (a and isinstance(a[0], (int, float))):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (a, b)
        np.testing.assert_array_equal(a, b)


def _both(seed=0, two_skeletons=False):
    return make_project(TORCH, seed, two_skeletons), make_project(JAX, seed, two_skeletons)


# --------------------------------------------------------------------------- #
# summary
# --------------------------------------------------------------------------- #

SERIES = [
    ("get_point_count_series", {}),
    ("get_point_score_series", {"reduction": "sum"}),
    ("get_point_score_series", {"reduction": "min"}),
    ("get_instance_score_series", {"reduction": "sum"}),
    ("get_instance_score_series", {"reduction": "min"}),
    ("get_point_displacement_series", {"reduction": "mean"}),
    ("get_point_displacement_series", {"reduction": "max"}),
    ("get_primary_point_displacement_series", {}),
    ("get_primary_point_displacement_series", {"primary_node": "thorax"}),
]


@pytest.mark.parametrize("video", [0, 1])
@pytest.mark.parametrize("method,kwargs", SERIES, ids=[f"{m}-{k}" for m, k in SERIES])
def test_statistic_series_matches_jax(method, kwargs, video):
    t, j = _both()
    got = getattr(t_summary.StatisticSeries(t), method)(t.videos[video], **kwargs)
    want = getattr(j_summary.StatisticSeries(j), method)(j.videos[video], **kwargs)
    _same(got, want)


# --------------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------------- #


def _perturbed(P, seed):
    """The seeded project and a copy whose predictions moved by up to 6 px."""
    gt = make_project(P, 0, False)
    pr = make_project(P, 0, False)
    rng = np.random.default_rng(seed)
    for lf in pr.labeled_frames:
        for inst in lf.instances:
            if type(inst).__name__ == "PredictedInstance":
                for axis in ("x", "y"):
                    inst.points[axis] += rng.uniform(-6, 6, len(inst.points))
    return gt, pr


@pytest.mark.parametrize("frame_range", [None, range(0, 4)])
def test_matched_instance_distances_matches_jax(frame_range):
    got = t_metrics.matched_instance_distances(*_perturbed(TORCH, 1), frame_range=frame_range)
    want = j_metrics.matched_instance_distances(*_perturbed(JAX, 1), frame_range=frame_range)
    assert len(got[0]) > 0
    _same(list(got), list(want))


def test_instance_list_metrics_match_jax():
    for P, m, out in ((TORCH, t_metrics, []), (JAX, j_metrics, [])):
        gt, pr = _perturbed(P, 2)
        a = list(gt.labeled_frames[1].instances)
        b = list(reversed(pr.labeled_frames[1].instances))
        cost = lambda x, y, m=m: float(np.nansum(m.point_dist(x, y)))  # noqa: E731
        for pairing in (m.match_instance_lists(a, b, cost), m.match_instance_lists_nodewise(a, b)):
            out.append([i.numpy() for side in pairing for i in side])
            out.append(m.compare_instance_lists(*pairing))
        out += [m.nodeless_point_dist(a[0], b[1]), m.list_points(a), m.point_dist(a[0], b[0])]
        if P is TORCH:
            got = out
        else:
            want = out
    _same(got, want)


# --------------------------------------------------------------------------- #
# align
# --------------------------------------------------------------------------- #


def _points(seed=3):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-20, 20, (6, 2))
    pts = []
    for _ in range(12):
        theta = rng.uniform(0, 2 * np.pi)
        rot = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
        pts.append(base @ rot.T + rng.uniform(-50, 50, 2) + rng.normal(0, 0.5, base.shape))
    pts = np.stack(pts)
    pts[2, 4] = np.nan
    return pts


@pytest.mark.parametrize("call", [
    lambda m, p: m.get_mean_and_std_for_points(p),
    lambda m, p: m.align_instance_points(p[0], p[1]),
    lambda m, p: m.align_instance_points(p[2], p[3]),
    lambda m, p: m.align_instances(p, node_a=1, node_b=3),
    lambda m, p: m.align_instances_on_most_stable(p),
    lambda m, p: m.align_instances_on_most_stable(p, min_stable_dist=1e3),
], ids=["mean_std", "points", "points_nan", "instances", "most_stable", "none_stable"])
def test_align_matches_jax(call):
    _same(call(t_align, _points()), call(j_align, _points()))


def test_template_points_match_jax():
    t, j = _both()
    got = t_align.get_template_points_array(t.labeled_frames[0].instances + t.labeled_frames[2].instances)
    want = j_align.get_template_points_array(j.labeled_frames[0].instances + j.labeled_frames[2].instances)
    _same(got, want)
    _same(t_align.get_instances_points(t.labeled_frames[1].instances),
          j_align.get_instances_points(j.labeled_frames[1].instances))


# --------------------------------------------------------------------------- #
# suggestions
# --------------------------------------------------------------------------- #


def _keyed(labels, suggestions):
    return [(labels.videos.index(s.video), s.frame_idx, s.group) for s in suggestions]


SUGGEST = {
    "sample random": {"method": "sample", "per_video": 4, "sampling_method": "random"},
    "sample stride": {"method": "sample", "per_video": 3, "sampling_method": "stride"},
    "prediction score": {"method": "prediction score", "score_limit": 0.6,
                         "instance_limit_upper": 2, "instance_limit_lower": 1},
    "velocity by index": {"method": "velocity", "node": 1, "threshold": 0.3},
    "velocity by name": {"method": "velocity", "node": "head", "threshold": 0.1},
    "frame chunk": {"method": "frame_chunk", "frame_from": 3, "frame_to": 11},
    "frame chunk empty": {"method": "frame_chunk", "frame_from": 5, "frame_to": 2},
    "max point displacement": {"method": "max_point_displacement", "displacement_threshold": 20.0},
}


@pytest.mark.parametrize("name", list(SUGGEST))
def test_suggestions_match_jax(name):
    results = []
    for P, mod in ((TORCH, t_suggestions), (JAX, j_suggestions)):
        labels = make_project(P, 0, False)
        random.seed(7)
        got = mod.VideoFrameSuggestions.suggest({**SUGGEST[name], "videos": labels.videos}, labels)
        results.append(_keyed(labels, got))
    assert results[0] == results[1]


def test_suggestion_helpers_and_refusals_match_jax():
    results = []
    for P, mod in ((TORCH, t_suggestions), (JAX, j_suggestions)):
        labels = make_project(P, 0, False)
        cls = mod.VideoFrameSuggestions
        frames = cls.idx_list_to_frame_list([0, 2, 4, 11], labels.videos[0], 3)
        kept = cls.filter_unique_suggestions(labels, labels.videos, frames)
        results.append((_keyed(labels, frames), _keyed(labels, kept)))
        with pytest.raises(ValueError, match="No nope method"):
            cls.suggest({"method": "nope"}, labels)
    assert results[0] == results[1]
    # The image-feature method runs the ported pipeline
    # (tests/test_torch_feature_suggestions.py): the same suggestions.
    keyed = []
    for P, mod in ((TORCH, t_suggestions), (JAX, j_suggestions)):
        labels = make_project(P, 0, False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # k-means of the blank frames finds one cluster
            got = mod.VideoFrameSuggestions.suggest(
                {"method": "image features", "videos": labels.videos, "per_video": 2,
                 "sample_method": "stride", "scale": 1.0, "merge_video_features": "across all videos",
                 "feature_type": "raw images", "pca_components": 2, "n_clusters": 2,
                 "per_cluster": 1}, labels)
        keyed.append(_keyed(labels, got))
    assert keyed[0] == keyed[1] and keyed[0]


# --------------------------------------------------------------------------- #
# pathutils
# --------------------------------------------------------------------------- #


@pytest.fixture
def prefix_stores(tmp_path, monkeypatch):
    stores = {}
    for name, mod in (("torch", t_pathutils), ("jax", j_pathutils)):
        stores[name] = str(tmp_path / name / "path_prefixes.yaml")
        monkeypatch.setattr(mod, "_PREFIX_STORE", stores[name])
        os.makedirs(os.path.dirname(stores[name]))
    return stores


def test_path_helpers_match_jax():
    for a, b in [("/old/data/videos/a.mp4", "/new/place/videos/a.mp4"),
                 ("C:\\Users\\me\\clip.mp4", "/home/me/clip.mp4"), ("a.mp4", "a.mp4"), ("", "x")]:
        assert t_pathutils.find_changed_subpath(a, b) == j_pathutils.find_changed_subpath(a, b)
        assert t_pathutils.fix_path_separator(a) == j_pathutils.fix_path_separator(a)
    files = [__file__, "/nonexistent/clip.mp4"]
    assert t_pathutils.list_file_missing(files) == j_pathutils.list_file_missing(files) == [False, True]


@pytest.mark.parametrize("confirm", [None, True, False])
def test_prefix_repairs_match_jax(confirm, tmp_path, prefix_stores):
    new = tmp_path / "moved" / "videos"
    new.mkdir(parents=True)
    for name in ("a.mp4", "b.mp4"):
        (new / name).write_bytes(b"")
    old_prefix, new_prefix = "/lab/old/videos", str(new)
    results = {}
    for name, mod in (("torch", t_pathutils), ("jax", j_pathutils)):
        filenames = [f"{old_prefix}/a.mp4", f"{old_prefix}/c.mp4", "/else/b.mp4", f"{old_prefix}/b.mp4"]
        missing = mod.list_file_missing(filenames)
        callback = None if confirm is None else (lambda: confirm)
        mod.filenames_prefix_change(filenames, old_prefix, new_prefix, missing, callback)
        results[name] = (filenames, missing, os.path.exists(prefix_stores[name]))
    assert results["torch"] == results["jax"]
    if confirm is not False:
        # Each package repairs with the store the other wrote.
        for reader, writer in ((t_pathutils, "jax"), (j_pathutils, "torch")):
            shutil.copy(prefix_stores[writer], reader._PREFIX_STORE)
            filenames = [f"{old_prefix}/b.mp4", "/else/x.mp4"]
            reader.fix_paths_with_saved_prefix(filenames)
            assert filenames == [f"{new_prefix}/b.mp4", "/else/x.mp4"]


# --------------------------------------------------------------------------- #
# Re-tracking and track cleaning
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    """``raw.slp`` predicted by the port's sleap-track with the trained pair
    (untracked), as the file both packages re-track."""
    tmp = tmp_path_factory.mktemp("retrack")
    shutil.copy(RAW, tmp / RAW.name)
    out = str(tmp / "predicted.slp")
    ttrack.main([str(tmp / RAW.name), "-m", str(RUNS / "minimal_instance.UNet.centroid"),
                 "-m", str(RUNS / "minimal_instance.UNet.centered_instance"), "--cpu",
                 "--verbosity", "none", "--peak_threshold", "0.05", "-o", out])
    return tmp, out


def _tracks(path):
    labels = jread(path)
    return [[(inst.track and inst.track.name, inst.numpy(), getattr(inst, "tracking_score", 0.0))
             for inst in lf.instances] for lf in sorted(labels.labeled_frames, key=lambda f: f.frame_idx)]


def _assert_same_tracks(got_path, want_path):
    got, want = _tracks(got_path), _tracks(want_path)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [x[0] for x in a] == [y[0] for y in b]
        for x, y in zip(a, b):
            _same(x[1], y[1])
            assert abs(x[2] - y[2]) <= TRACK_SCORE_TOL
    return got


@pytest.mark.parametrize("flags", [[], ["--tracking.tracker", "simple", "--frames", "1-6"],
                                   ["--tracking.max_tracks", "2", "--tracking.match", "hungarian"]],
                         ids=["flow", "simple frames", "flow max tracks"])
def test_retrack_main_matches_jax(flags, predictions):
    tmp, src = predictions
    tag = "-".join(flags).replace(".", "_") or "flow"
    j_out, t_out = str(tmp / f"{tag}.jax.slp"), str(tmp / f"{tag}.torch.slp")
    j_tracker.main([src, "-o", j_out, *flags])
    t_tracker.main([src, "-o", t_out, "--cpu", *flags])
    tracked = _assert_same_tracks(t_out, j_out)
    assert all(name is not None for frame in tracked for name, _, _ in frame)
    assert len({name for frame in tracked for name, _, _ in frame}) >= 2


def test_trackcleaner_matches_jax(predictions, capsys):
    tmp, src = predictions
    tracked = str(tmp / "to_clean.slp")
    t_tracker.main([src, "-o", tracked, "--cpu"])
    outs = []
    for tag, mod in (("jax", j_trackcleaner), ("torch", t_trackcleaner)):
        out = str(tmp / f"cleaned.{tag}.slp")
        mod.main([tracked, "-c", "1", "-o", out])
        assert f"Saved: {out}" in capsys.readouterr().out
        outs.append(out)
    cleaned = _assert_same_tracks(outs[1], outs[0])
    assert max(len(frame) for frame in cleaned) == 1
    assert t_trackcleaner.fit_tracks(tracked, 1) == tracked + ".cleaned.slp"
