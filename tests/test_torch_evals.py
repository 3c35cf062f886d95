"""The port's ``evals.py`` against the JAX package's, on the same ``.slp``
files read by each package's own reader.

Crafted labels hold NaN nodes, predictions that match nothing, tied
scores, ground-truth frames without user instances, frames with no
prediction, a file whose videos pair with nothing, and two videos that pair
by basename from another folder, in the other order.

Tolerances: every function on the crafted files is held exact (the port
runs the same numpy operations in the same order). ``evaluate_model`` on the
trained ``minimal_instance`` centered-instance folder (the ground-truth
centroid mode) runs each package's network on the CPU, whose convolutions
sum in another order: distances within 1e-3 px, OKS within 1e-4, every count
and index equal. ``load_metrics`` is held exact both ways.
"""

from __future__ import annotations

import os
import shutil
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sleap_tpu import evals as jevals
from sleap_tpu.inference import predictors as jpredictors
from sleap_tpu.io.slp import read_labels as jread
from sleap_tpu_torch import evals as tevals
from sleap_tpu_torch import load_metrics
from sleap_tpu_torch.core.instance import Instance, LabeledFrame, PredictedInstance
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.inference import predictors as tpredictors
from sleap_tpu_torch.io import hdf5
from sleap_tpu_torch.io.slp import read_labels as tread
from sleap_tpu_torch.io.slp import write_labels
from sleap_tpu_torch.io.video import Video

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
INSTANCE = REPO / ".convergence_runs" / "minimal_instance.UNet.centered_instance"
PKG = REPO / "tests" / "torch_data" / "pkg.slp"
DIST_TOL, OKS_TOL = 1e-3, 1e-4
# The trained folder's maps peak below the default threshold of 0.2 on the
# fixture's blobs (chip_smoke.py phase 4g drives them at 0.05 too).
THRESHOLD = 0.05


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _skeleton() -> Skeleton:
    skeleton = Skeleton("four")
    for name in "abcd":
        skeleton.add_node(name)
    skeleton.add_edge("a", "b")
    skeleton.add_edge("b", "c")
    return skeleton


def _pred(skeleton, points, score, point_score=0.9):
    return PredictedInstance.from_arrays(points, np.full(len(points), point_score), score, skeleton)


@pytest.fixture(scope="module")
def crafted(tmp_path_factory):
    """Ground truth, predictions and a file that pairs with nothing."""
    tmp = tmp_path_factory.mktemp("evals")
    rng = np.random.default_rng(0)
    sk = _skeleton()
    base = np.array([[0.0, 0.0], [20.0, 4.0], [26.0, 24.0], [4.0, 18.0]])

    def animal(x, y):
        return base + [x, y]

    def near(points, px=0.6):
        return points + rng.normal(0, px, points.shape)

    def video(path):
        """A small HDF5 video: JAX's ``compute_dists`` takes each video's
        length, so the file must be there."""
        path.parent.mkdir(exist_ok=True)
        with hdf5.Writer(str(path)) as f:
            f.create_dataset("video", data=np.zeros((8, 4, 4, 1), np.uint8), compression=None)
        return Video.from_filename(str(path), dataset="video")

    gt_videos = [video(tmp / "gt" / f"cam{i}.h5") for i in range(2)]
    pr_videos = [video(tmp / "pr" / f"cam{i}.h5") for i in range(2)]
    a, b, c = animal(10, 10), animal(100, 40), animal(60, 120)
    a_nan = a.copy()
    a_nan[2] = np.nan
    gt, pr = [], []
    # cam0 frame 0: a NaN ground-truth node; a tie of scores; a far prediction with the best score.
    gt.append(LabeledFrame(gt_videos[0], 0, [Instance(sk, a_nan), Instance(sk, b)]))
    pr.append(LabeledFrame(pr_videos[0], 0, [_pred(sk, near(b), 0.9), _pred(sk, near(a), 0.9),
                                              _pred(sk, animal(400, 400), 0.95)]))
    # cam0 frame 1: no prediction there.
    gt.append(LabeledFrame(gt_videos[0], 1, [Instance(sk, c)]))
    # cam0 frame 2: one ground truth unmatched; a prediction with a NaN node.
    p = near(c)
    p[1] = np.nan
    gt.append(LabeledFrame(gt_videos[0], 2, [Instance(sk, a), Instance(sk, c)]))
    pr.append(LabeledFrame(pr_videos[0], 2, [_pred(sk, p, 0.5)]))
    # cam0 frame 3: predictions only in the ground truth (skipped with user_labels_only).
    gt.append(LabeledFrame(gt_videos[0], 3, [_pred(sk, a, 0.7)]))
    pr.append(LabeledFrame(pr_videos[0], 3, [_pred(sk, near(a), 0.7)]))
    # cam0 frame 4: a user instance beside a prediction in the ground truth.
    gt.append(LabeledFrame(gt_videos[0], 4, [Instance(sk, b), _pred(sk, near(c), 0.8)]))
    pr.append(LabeledFrame(pr_videos[0], 4, [_pred(sk, near(c), 0.4),
                                              _pred(sk, near(b, 2.0), 0.3)]))
    # cam1 frame 5: two equal-score predictions for one ground truth.
    gt.append(LabeledFrame(gt_videos[1], 5, [Instance(sk, c)]))
    pr.append(LabeledFrame(pr_videos[1], 5, [_pred(sk, near(c, 1.5), 0.6),
                                              _pred(sk, near(c), 0.6)]))
    # cam1 frame 6: predictions only, every node found by two of them.
    gt.append(LabeledFrame(gt_videos[1], 6, [Instance(sk, a), Instance(sk, b), Instance(sk, c)]))
    pr.append(LabeledFrame(pr_videos[1], 6, [_pred(sk, near(c), 0.2), _pred(sk, near(a), 0.8),
                                              _pred(sk, near(b, 1.0), 0.55)]))

    paths = {"gt": tmp / "gt.slp", "pr": tmp / "pr.slp", "none": tmp / "none.slp"}
    write_labels(str(paths["gt"]), Labels(gt, videos=gt_videos))
    # The predictions list their videos in the other order.
    write_labels(str(paths["pr"]), Labels(pr, videos=pr_videos[::-1]))
    other = video(tmp / "pr" / "other.h5")
    write_labels(str(paths["none"]), Labels([LabeledFrame(other, 0, [_pred(sk, a, 0.9)])]))
    return {k: str(v) for k, v in paths.items()}


def _read(paths, *names):
    """Each file as (the port's Labels, the JAX package's Labels)."""
    return [(tread(paths[n], video_search=False), jread(paths[n], video_search=False))
            for n in names]


def _same(got, want, what=""):
    """Equal values of the same type: arrays elementwise (NaN equal to NaN),
    lists and scalars as they are."""
    assert type(got).__name__ == type(want).__name__, (what, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _same(g, w, what)
    elif isinstance(want, (float, np.floating)) and np.isnan(want):
        assert np.isnan(got), what
    else:
        assert got == want, what


def _same_metrics(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        _same(got[key], want[key], key)


def _pairs_key(pairs):
    return [(g.numpy(), p.numpy(), float(oks)) for g, p, oks in pairs]


def test_instance_area_and_oks_match_jax():
    rng = np.random.default_rng(1)
    gt = rng.uniform(0, 60, (5, 7, 2))
    pr = gt[[1, 0, 3]] + rng.normal(0, 2, (3, 7, 2))
    gt[0, 2] = np.nan
    pr[1, 4] = np.nan
    _same(tevals.compute_instance_area(gt), jevals.compute_instance_area(gt))
    _same(tevals.compute_instance_area(gt[1]), jevals.compute_instance_area(gt[1]))
    for kwargs in ({}, {"scale": 150.0}, {"stddev": 0.08, "use_cocoeval": False},
                   {"stddev": np.linspace(0.02, 0.1, 7)}):
        _same(tevals.compute_oks(gt, pr, **kwargs), jevals.compute_oks(gt, pr, **kwargs))
    _same(tevals.compute_oks(gt[2], pr[0]), jevals.compute_oks(gt[2], pr[0]))


def test_frame_pairs_match_jax(crafted):
    (tgt, jgt), (tpr, jpr), (tnone, jnone) = _read(crafted, "gt", "pr", "none")

    def key(pairs):
        return [(os.path.basename(g.video.filename), g.frame_idx, p.video.filename, p.frame_idx)
                for g, p in pairs]

    for user_only in (True, False):
        got = key(tevals.find_frame_pairs(tgt, tpr, user_only))
        assert got == key(jevals.find_frame_pairs(jgt, jpr, user_only))
    assert [f for _, f, _, _ in key(tevals.find_frame_pairs(tgt, tpr))] == [0, 2, 4, 5, 6]
    assert tevals.find_frame_pairs(tgt, tnone) == [] == jevals.find_frame_pairs(jgt, jnone)
    assert tevals.evaluate(tgt, tnone) == {} == jevals.evaluate(jgt, jnone)


@pytest.mark.parametrize("threshold", [0, 0.5])
@pytest.mark.parametrize("user_only", [True, False])
def test_instance_matching_matches_jax(crafted, threshold, user_only):
    (tgt, jgt), (tpr, jpr) = _read(crafted, "gt", "pr")
    tpairs = tevals.find_frame_pairs(tgt, tpr, user_only)
    jpairs = jevals.find_frame_pairs(jgt, jpr, user_only)
    for (tg, tp), (jg, jp) in zip(tpairs, jpairs):
        got = tevals.match_instances(tg, tp, threshold=threshold, user_labels_only=user_only)
        want = jevals.match_instances(jg, jp, threshold=threshold, user_labels_only=user_only)
        _same(_pairs_key(got[0]), _pairs_key(want[0]))
        _same([i.numpy() for i in got[1]], [i.numpy() for i in want[1]])
    got = tevals.match_frame_pairs(tpairs, scale=300.0, threshold=threshold,
                                   user_labels_only=user_only)
    want = jevals.match_frame_pairs(jpairs, scale=300.0, threshold=threshold,
                                    user_labels_only=user_only)
    _same(_pairs_key(got[0]), _pairs_key(want[0]))
    _same([i.numpy() for i in got[1]], [i.numpy() for i in want[1]])
    if threshold == 0 and user_only:
        # The far prediction is unmatched; each tie goes to the earlier prediction.
        assert len(got[0]) == 8 and len(got[1]) == 1


def test_metric_functions_match_jax(crafted):
    (tgt, jgt), (tpr, jpr) = _read(crafted, "gt", "pr")
    tframes = tevals.find_frame_pairs(tgt, tpr)
    tpos, tneg = tevals.match_frame_pairs(tframes)
    jpos, jneg = jevals.match_frame_pairs(jevals.find_frame_pairs(jgt, jpr))
    frames = {id(i): lf for lf, _ in tframes for i in lf.instances}
    tdists, jdists = tevals.compute_dists(tpos, frames), jevals.compute_dists(jpos)
    _same(tdists["dists"], jdists["dists"])
    assert tdists["frame_idxs"] == jdists["frame_idxs"] == [0, 0, 2, 4, 5, 6, 6, 6]
    assert [os.path.basename(p) for p in tdists["video_paths"]] == \
        [os.path.basename(p) for p in jdists["video_paths"]]
    assert tevals.compute_dists(tpos)["frame_idxs"] == [-1] * len(tpos)
    _same_metrics(tevals.compute_visibility_conf(tpos), jevals.compute_visibility_conf(jpos))
    _same_metrics(tevals.compute_dist_metrics(tdists), jevals.compute_dist_metrics(jdists))
    _same_metrics(tevals.compute_pck_metrics(tdists["dists"]),
                  jevals.compute_pck_metrics(jdists["dists"]))
    _same_metrics(tevals.compute_pck_metrics(tdists["dists"], np.array([0.5, 2.0])),
                  jevals.compute_pck_metrics(jdists["dists"], np.array([0.5, 2.0])))
    toks = np.array([o for _, _, o in tpos])
    for name, scores in (("oks_voc", toks), ("pck_voc", np.linspace(1, 0, len(tpos)))):
        _same_metrics(
            tevals.compute_generalized_voc_metrics(tpos, tneg, scores, name=name),
            jevals.compute_generalized_voc_metrics(jpos, jneg, scores, name=name))
    # No detections at all.
    _same_metrics(tevals.compute_generalized_voc_metrics([], tneg, np.array([])),
                  jevals.compute_generalized_voc_metrics([], jneg, np.array([])))


def test_evaluate_matches_jax(crafted):
    (tgt, jgt), (tpr, jpr) = _read(crafted, "gt", "pr")
    got, want = tevals.evaluate(tgt, tpr), jevals.evaluate(jgt, jpr)
    assert 0 < got["oks.mOKS"] < 1 and 0 < got["oks_voc.mAP"] < 1
    _same_metrics({k: v for k, v in got.items() if k != "dist.video_paths"},
                  {k: v for k, v in want.items() if k != "dist.video_paths"})
    assert got["dist.video_paths"] == want["dist.video_paths"]
    kwargs = dict(oks_stddev=0.05, oks_scale=500.0, match_threshold=0.3, user_labels_only=False)
    _same_metrics(tevals.evaluate(tgt, tpr, **kwargs), jevals.evaluate(jgt, jpr, **kwargs))


def _with_threshold(monkeypatch, cls):
    """Have ``Predictor.from_model_paths`` use ``THRESHOLD``."""
    original = cls.from_model_paths.__func__

    def from_model_paths(klass, *args, **kwargs):
        return original(klass, *args, peak_threshold=THRESHOLD, **kwargs)

    monkeypatch.setattr(cls, "from_model_paths", classmethod(from_model_paths))


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """``evaluate_model`` of both packages on the trained centered-instance
    folder (each on its own copy), in ground-truth-centroid mode, on the
    fixture's frames with ground truth near the model's own points."""
    tmp = tmp_path_factory.mktemp("evaluate_model")
    mp = pytest.MonkeyPatch()
    _with_threshold(mp, tpredictors.Predictor)
    _with_threshold(mp, jpredictors.Predictor)
    try:
        fixture = tread(str(PKG), device="cpu")
        first = tpredictors.Predictor.from_model_paths(str(INSTANCE), device="cpu")
        seeds = first.predict(fixture)
        rng = np.random.default_rng(2)
        frames = []
        for lf in seeds:
            insts = []
            for k, inst in enumerate(lf.instances):
                pts = inst.numpy() + rng.normal(0, 0.4, (2, 2))
                if (lf.frame_idx, k) == (3, 1):
                    pts[0] = np.nan  # a NaN ground-truth node
                insts.append(Instance(inst.skeleton, pts))
            frames.append(LabeledFrame(lf.video, lf.frame_idx, insts))
        gt_path = tmp / "gt.slp"
        write_labels(str(gt_path), Labels(frames))
        out = {}
        for name, evals, read in (("port", tevals, tread), ("jax", jevals, jread)):
            folder = tmp / name
            shutil.copytree(INSTANCE, folder)
            kwargs = {"device": "cpu"} if name == "port" else {}
            labels = read(str(gt_path), **kwargs)
            _, metrics = evals.evaluate_model(None, labels, str(folder), split_name="val",
                                              **kwargs)
            out[name] = (str(folder), metrics)
        return out
    finally:
        mp.undo()


def test_evaluate_model_matches_jax(scored):
    (tfolder, got), (jfolder, want) = scored["port"], scored["jax"]
    assert os.path.exists(os.path.join(tfolder, "labels_pr.val.slp"))
    assert sorted(got) == sorted(want)
    assert len(got["dist.frame_idxs"]) >= 14 and got["oks.mOKS"] > 0.5
    for key in want:
        g, w = got[key], want[key]
        if key in ("dist.dists", "dist.avg") or key.startswith("dist.p"):
            np.testing.assert_allclose(g, w, rtol=0, atol=DIST_TOL, err_msg=key)
        elif key in ("oks.mOKS", "oks_voc.match_scores"):
            np.testing.assert_allclose(g, w, rtol=0, atol=OKS_TOL, err_msg=key)
        elif key == "dist.video_paths":
            assert [os.path.basename(p) for p in g] == [os.path.basename(p) for p in w]
        else:
            _same(g, w, key)


def test_load_metrics_both_ways(scored):
    (tfolder, got), (jfolder, want) = scored["port"], scored["jax"]
    for folder, metrics in ((tfolder, got), (jfolder, want)):
        _same_metrics(load_metrics(folder), metrics)
        _same_metrics(tevals.load_metrics(os.path.join(folder, "metrics.val.npz")), metrics)
        _same_metrics(jevals.load_metrics(folder, split="val"), metrics)


def test_foreign_metrics_load_without_their_package(tmp_path, monkeypatch):
    """A metrics file whose pickle names ``sleap.*`` classes that are not
    installed (an upstream SLEAP file) loads in both packages, as stubs."""
    module = types.ModuleType("sleap.instance")

    class PointArray(np.ndarray):
        pass

    class Instance:
        def __init__(self):
            self.frame_idx = 7
            self.points = np.arange(4.0).reshape(2, 2).view(PointArray)

    for cls in (PointArray, Instance):
        cls.__module__, cls.__qualname__ = "sleap.instance", cls.__name__
        setattr(module, cls.__name__, cls)
    parent = types.ModuleType("sleap")
    parent.instance = module
    monkeypatch.setitem(sys.modules, "sleap", parent)
    monkeypatch.setitem(sys.modules, "sleap.instance", module)
    metrics = {
        "oks.mOKS": np.float64(0.75),
        "vis.tp": np.int64(12),
        "dist.dists": np.array([[0.5, np.nan]]).view(PointArray),
        "dist.frame_idxs": [7],
        "instances": [Instance()],
    }
    path = tmp_path / "metrics.val.npz"
    np.savez_compressed(path, metrics=metrics)
    monkeypatch.delitem(sys.modules, "sleap")
    monkeypatch.delitem(sys.modules, "sleap.instance")

    got = load_metrics(str(tmp_path), split="val")
    want = jevals.load_metrics(str(path))
    for out in (got, want):
        assert sorted(out) == sorted(metrics)
        assert out["oks.mOKS"] == 0.75 and out["vis.tp"] == 12 and out["dist.frame_idxs"] == [7]
        np.testing.assert_array_equal(np.asarray(out["dist.dists"]), [[0.5, np.nan]])
        assert type(out["dist.dists"]).__name__ == "PointArray"
        inst = out["instances"][0]
        assert type(inst).__name__ == "Instance" and inst.frame_idx == 7
        np.testing.assert_array_equal(np.asarray(inst.points), [[0, 1], [2, 3]])
    assert "sleap" not in sys.modules
