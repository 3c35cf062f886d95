"""The port's data model (``sleap_tpu_torch.core``) against the JAX
package's (``sleap_tpu.core``): the same seeded project (two videos, two
skeletons, tracks, user and predicted instances with ``from_predicted``
links, suggestions) is built in both packages, the same call is made on
each, and the return values and the whole project after the call must be
equal exactly (points bitwise, NaN equal to NaN). One case a public method
of ``Labels``, ``LabeledFrame``, ``Instance``, ``PredictedInstance``,
``InstancesList``, ``Skeleton``, ``Track`` and ``RangeList``; ``numpy()``,
``to_dict()`` and the ``.slp`` each package writes (read back by the JAX
reader) too; the conflict-aware merge; skeleton JSON of both styles, each
package reading what the other writes."""

from __future__ import annotations

import contextlib
import io
import json
import types

import numpy as np
import pytest

from sleap_tpu.core import instance as j_instance
from sleap_tpu.core import labels as j_labels
from sleap_tpu.core import rangelist as j_rangelist
from sleap_tpu.core import skeleton as j_skeleton
from sleap_tpu.io import video as j_video
from sleap_tpu_torch.core import instance as t_instance
from sleap_tpu_torch.core import labels as t_labels
from sleap_tpu_torch.core import rangelist as t_rangelist
from sleap_tpu_torch.core import skeleton as t_skeleton
from sleap_tpu_torch.io import video as t_video


def _package(inst, lab, skel, vid, rl):
    return types.SimpleNamespace(
        Instance=inst.Instance, PredictedInstance=inst.PredictedInstance, Track=inst.Track,
        LabeledFrame=inst.LabeledFrame, InstancesList=inst.InstancesList, make_point=inst.make_point,
        make_pred_point=inst.make_pred_point, empty_points=inst.empty_points, Labels=lab.Labels,
        SuggestionFrame=lab.SuggestionFrame, Skeleton=skel.Skeleton, Node=skel.Node,
        EdgeType=skel.EdgeType, load_template=skel.load_template, Video=vid.Video,
        DummyVideo=vid.DummyVideo, RangeList=rl.RangeList, unify=lab._unify_skeletons)


JAX = _package(j_instance, j_labels, j_skeleton, j_video, j_rangelist)
TORCH = _package(t_instance, t_labels, t_skeleton, t_video, t_rangelist)


# --------------------------------------------------------------------------- #
# A seeded project, built the same way in either package
# --------------------------------------------------------------------------- #


def make_skeletons(P):
    fly = P.Skeleton("fly")
    fly.add_nodes(["head", "thorax", "abdomen", "wingL", "wingR"])
    fly.add_edges([("head", "thorax"), ("thorax", "abdomen"), ("thorax", "wingL"), ("thorax", "wingR")])
    fly.add_symmetry("wingL", "wingR")
    mouse = P.Skeleton("mouse")
    mouse.add_nodes(["nose", "tail"])
    mouse.add_edge("nose", "tail")
    return fly, mouse


def make_project(P, seed: int = 0, two_skeletons: bool = True):
    """Frames 0-9 of clip_a (fly skeleton) with tracked predictions, user
    instances corrected from some of them, NaN and invisible points, an
    empty frame and an untracked prediction; frames of clip_b on the mouse
    skeleton (the fly too with ``two_skeletons`` False); suggestions."""
    rng = np.random.default_rng(seed)
    fly, mouse = make_skeletons(P)
    other = mouse if two_skeletons else fly
    va = P.Video(P.DummyVideo(filename="clip_a.mp4", height=64, width=64, frames=30))
    vb = P.Video(P.DummyVideo(filename="clip_b.mp4", height=64, width=64, frames=12))
    tracks = [P.Track(0, "t0"), P.Track(1, "t1"), P.Track(3, "t2"), P.Track(0, "unused")]

    def pred(skel, track, score=None):
        xy = rng.uniform(0, 64, (skel.n_nodes, 2))
        xy[rng.uniform(size=skel.n_nodes) < 0.15] = np.nan
        conf = rng.uniform(size=skel.n_nodes)
        return P.PredictedInstance.from_arrays(xy, conf, float(rng.uniform()) if score is None else score,
                                               skel, track=track, tracking_score=float(rng.uniform()))

    def user(skel, track, from_predicted=None):
        xy = rng.uniform(0, 64, (skel.n_nodes, 2))
        xy[rng.uniform(size=skel.n_nodes) < 0.15] = np.nan
        inst = P.Instance(skel, xy, track=track, from_predicted=from_predicted)
        if skel.n_nodes > 2:
            inst.points["visible"][1] = False  # a labeled but invisible point
        return inst

    lfs = []
    for fi in (0, 1, 2, 3, 5, 8, 9):
        insts = [pred(fly, tracks[0]), pred(fly, tracks[1])]
        if fi in (1, 5):
            insts.append(user(fly, tracks[0], from_predicted=insts[0]))
        if fi == 3:
            insts.append(user(fly, None))
        if fi == 8:
            insts.append(pred(fly, None))
        if fi == 9:
            insts.append(pred(fly, tracks[2]))
        lfs.append(P.LabeledFrame(va, fi, insts))
    lfs.append(P.LabeledFrame(va, 12, []))
    for fi in (1, 4, 7):
        insts = [user(other, tracks[2])] if fi != 4 else [pred(other, tracks[2]), user(other, None)]
        lfs.append(P.LabeledFrame(vb, fi, insts))
    suggestions = [P.SuggestionFrame(va, 2, 0), P.SuggestionFrame(va, 4, 0), P.SuggestionFrame(vb, 0, 1),
                   P.SuggestionFrame(vb, 7, 1), P.SuggestionFrame(va, 11, 1)]
    return P.Labels(labeled_frames=lfs, videos=[va, vb], tracks=tracks, suggestions=suggestions,
                    provenance={"model": "seeded", "n": 3})


def _is(obj, *names) -> bool:
    return any(t.__name__ in names for t in type(obj).__mro__)


def _nan(x):
    if isinstance(x, float) and np.isnan(x):
        return "nan"
    if isinstance(x, (list, tuple)):
        return [_nan(v) for v in x]
    return x


def summary(L):
    """The whole project as plain values: videos, skeletons, tracks,
    suggestions, provenance and every frame's instances (class, skeleton,
    track, points bitwise, scores, ``from_predicted`` position, frame
    back-reference)."""
    vid = {id(v): i for i, v in enumerate(L.videos)}
    sk = {id(s): i for i, s in enumerate(L.skeletons)}
    tr = {id(t): i for i, t in enumerate(L.tracks)}
    where = {id(inst): (fi, j) for fi, lf in enumerate(L.labeled_frames) for j, inst in enumerate(lf.instances)}
    frames = []
    for lf in L.labeled_frames:
        insts = []
        for inst in lf.instances:
            insts.append((
                type(inst).__name__, sk.get(id(inst.skeleton), inst.skeleton.name),
                None if inst.track is None else tr.get(id(inst.track), inst.track.name),
                _nan(inst.points.tolist()), _nan(float(getattr(inst, "score", 0.0))),
                _nan(float(getattr(inst, "tracking_score", 0.0))),
                None if inst.from_predicted is None else where.get(id(inst.from_predicted), "outside"),
                inst.frame is lf,
            ))
        frames.append((vid.get(id(lf.video), lf.video.filename), lf.frame_idx, insts))
    return {
        "videos": [v.filename for v in L.videos],
        "skeletons": [(s.name, s.node_names, [tuple(e) for e in s.edge_names],
                       [tuple(p) for p in s.symmetry_names]) for s in L.skeletons],
        "tracks": [(t.name, t.spawned_on) for t in L.tracks],
        "suggestions": [(vid.get(id(s.video), "?"), s.frame_idx, s.group) for s in L.suggestions],
        "provenance": L.provenance,
        "frames": frames,
    }


def norm(x, L):
    """A return value as plain values, objects named by their place in
    ``L``."""
    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return _nan(float(x))
    if isinstance(x, np.ndarray):
        if x.dtype.names:
            return ("points", _nan(x.tolist()))
        return ("array", x.shape, x.dtype.str, _nan(x.astype("f8").tolist()) if x.dtype.kind == "f" else x.tolist())
    if isinstance(x, np.void):
        return ("point", _nan(x.tolist()))
    if _is(x, "Labels"):
        return ("labels", summary(x))
    if _is(x, "LabeledFrame"):
        return ("frame", x.video.filename, x.frame_idx, len(x.instances),
                any(x is lf for lf in L.labeled_frames))
    if _is(x, "Instance"):
        for fi, lf in enumerate(L.labeled_frames):
            for j, inst in enumerate(lf.instances):
                if inst is x:
                    return ("instance", fi, j)
        return ("free instance", type(x).__name__, _nan(x.points.tolist()))
    if _is(x, "Track"):
        return ("track", x.name, x.spawned_on)
    if _is(x, "Video"):
        return ("video", x.filename)
    if _is(x, "Skeleton"):
        return ("skeleton", x.name, x.node_names)
    if _is(x, "Node"):
        return ("node", x.name, x.weight)
    if _is(x, "SuggestionFrame"):
        return ("suggestion", x.video.filename, x.frame_idx, x.group)
    if _is(x, "RangeList"):
        return ("ranges", [tuple(r) for r in x.list])
    if isinstance(x, dict):
        return sorted((json.dumps(norm(k, L), default=str), norm(v, L)) for k, v in x.items())
    if isinstance(x, (list, tuple)) or hasattr(x, "__next__"):
        return [norm(v, L) for v in x]
    raise TypeError(f"cannot normalise {type(x)}")


def run(op, P, **kw):
    """Build the project in package ``P``, call ``op``; return (normalised
    value or raised exception type, project summary, printed text)."""
    L = make_project(P, **kw)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            value = norm(op(L, P), L)
    except Exception as e:  # the same exception type is part of the contract
        value = ("raised", type(e).__name__)
    return value, summary(L), out.getvalue()


def assert_same(op, **kw):
    mine, ref = run(op, TORCH, **kw), run(op, JAX, **kw)
    assert mine[0] == ref[0], "return values differ"
    assert mine[1] == ref[1], "projects differ after the call"
    assert mine[2] == ref[2], "printed output differs"


# --------------------------------------------------------------------------- #
# Labels: one case a public method
# --------------------------------------------------------------------------- #


def _new_frame(L, P, video=1, idx=10):
    skel = L.skeletons[min(1, len(L.skeletons) - 1)] if video == 1 else L.skeletons[0]
    return P.LabeledFrame(L.videos[video], idx, [P.Instance(skel, np.arange(2 * skel.n_nodes, dtype="f8")
                                                            .reshape(-1, 2))])


def clone(inst, P):
    """A detached copy of an instance (``copy.deepcopy`` of an instance in a
    frame recurses without end in the JAX package)."""
    if inst.predicted:
        return P.PredictedInstance(inst.skeleton, inst.points.copy(), track=inst.track, score=inst.score,
                                   tracking_score=inst.tracking_score)
    return P.Instance(inst.skeleton, inst.points.copy(), track=inst.track)


def raises(fn):
    """Whether ``fn()`` raises (the empty skeleton's arborescence test
    raises networkx's own exception in the JAX package)."""
    try:
        fn()
    except Exception:
        return "raised"
    return "returned"


def _complex_merge(L, P):
    new = make_project(P, seed=1)
    # a frame matching the base exactly, so only the rest conflicts
    same = new.labeled_frames[0]
    same.instances = [clone(i, P) for i in L.labeled_frames[0].instances]
    for inst in same.instances:
        inst.track = None
    merged, extra_base, extra_new = P.Labels.complex_merge_between(L, new)
    return merged, extra_base, extra_new


def _finish_merge(L, P):
    _, extra_base, extra_new = _complex_merge(L, P)
    P.Labels.finish_complex_merge(L, extra_new)
    return len(extra_base), len(extra_new)


LABELS_OPS = {
    "len": lambda L, P: len(L),
    "iter": lambda L, P: list(L),
    "reversed": lambda L, P: list(reversed(L)),
    "getitem_int": lambda L, P: L[3],
    "getitem_negative": lambda L, P: L[-1],
    "getitem_out_of_range": lambda L, P: L[100],
    "getitem_slice": lambda L, P: L[1:6:2],
    "getitem_list": lambda L, P: L[[0, 4, 2]],
    "getitem_array": lambda L, P: L[np.array([1, 2])],
    "getitem_video": lambda L, P: L[L.videos[1]],
    "getitem_video_frame": lambda L, P: L[L.videos[0], 5],
    "getitem_video_frames": lambda L, P: L[L.videos[0], [5, 6, 8]],
    "getitem_missing_frame": lambda L, P: L[L.videos[0], 29],
    "get_raise_errors": lambda L, P: L.get((L.videos[0], 29), raise_errors=True),
    "get_secondary_key": lambda L, P: L.get(L.videos[1], 4),
    "setitem": lambda L, P: L.__setitem__(0, _new_frame(L, P)),
    "delitem": lambda L, P: L.__delitem__(2),
    "contains_frame": lambda L, P: L.labeled_frames[3] in L,
    "contains_video": lambda L, P: L.videos[1] in L,
    "contains_skeleton": lambda L, P: L.skeletons[1] in L,
    "contains_node": lambda L, P: L.skeletons[0].nodes[2] in L,
    "contains_pair": lambda L, P: [(L.videos[0], 5) in L, (L.videos[0], 6) in L],
    "contains_other": lambda L, P: "x" in L,
    "insert": lambda L, P: L.insert(1, _new_frame(L, P)),
    "insert_duplicate": lambda L, P: L.insert(0, P.LabeledFrame(L.videos[0], 5, [])),
    "append": lambda L, P: L.append(_new_frame(L, P, idx=11)),
    "extend": lambda L, P: L.extend([_new_frame(L, P, idx=10), _new_frame(L, P, idx=1)]),
    "index": lambda L, P: L.index(L.labeled_frames[4]),
    "count": lambda L, P: L.count(L.labeled_frames[4]),
    "pop": lambda L, P: L.pop(),
    "remove": lambda L, P: L.remove(L.labeled_frames[2]),
    "extend_from": lambda L, P: L.extend_from(make_project(P, seed=2)),
    "extend_from_unify": lambda L, P: L.extend_from(make_project(P, seed=2), unify=True),
    "extend_from_empty": lambda L, P: L.extend_from([]),
    "find": lambda L, P: L.find(L.videos[0]),
    "find_frames": lambda L, P: L.find(L.videos[0], [9, 5, 6]),
    "find_return_new": lambda L, P: L.find(L.videos[0], [5, 6], return_new=True),
    "find_first": lambda L, P: L.find_first(L.videos[1]),
    "find_last": lambda L, P: L.find_last(L.videos[0]),
    "frames": lambda L, P: list(L.frames(L.videos[0], from_frame_idx=4)),
    "frames_reverse": lambda L, P: list(L.frames(L.videos[0], from_frame_idx=4, reverse=True)),
    "user_labeled_frames": lambda L, P: L.user_labeled_frames,
    "predicted_frames": lambda L, P: L.predicted_frames,
    "all_instances": lambda L, P: L.all_instances,
    "user_instances": lambda L, P: L.user_instances,
    "predicted_instances": lambda L, P: L.predicted_instances,
    "labels": lambda L, P: L.labels,
    "skeleton": lambda L, P: L.skeleton,
    "video": lambda L, P: L.video,
    "has_missing_videos": lambda L, P: L.has_missing_videos,
    "instance_count": lambda L, P: [L.instance_count(L.videos[0], 5), L.instance_count(L.videos[0], 6)],
    "get_track_occupancy": lambda L, P: L.get_track_occupancy(L.videos[0]),
    "get_track_count": lambda L, P: L.get_track_count(L.videos[0]),
    "user_labeled_frame_inds": lambda L, P: L.user_labeled_frame_inds,
    "get_labeled_frame_count": lambda L, P: [L.get_labeled_frame_count(v, f) for v in (None, L.videos[1])
                                             for f in ("", "user", "predicted")],
    "get_frame_count": lambda L, P: L.get_frame_count(filter="user"),
    "get_labeled_frame_count_bad": lambda L, P: L.get_labeled_frame_count(filter="x"),
    "max_user_instances": lambda L, P: L.max_user_instances,
    "min_user_instances": lambda L, P: L.min_user_instances,
    "is_multi_instance": lambda L, P: L.is_multi_instance,
    "add_video": lambda L, P: L.add_video(P.Video(P.DummyVideo(filename="clip_c.mp4"))),
    "remove_video": lambda L, P: L.remove_video(L.videos[0]),
    "add_track": lambda L, P: L.add_track(L.videos[0], P.Track(7, "new")),
    "instances": lambda L, P: list(L.instances(video=L.videos[1], skeleton=L.skeletons[1])),
    "has_frame": lambda L, P: [L.has_frame(L.labeled_frames[2]), L.has_frame(video=L.videos[0], frame_idx=6),
                               L.has_frame(video=L.videos[0], frame_idx=5, use_cache=False)],
    "has_frame_bad": lambda L, P: L.has_frame(),
    "add_instance": lambda L, P: L.add_instance(L.labeled_frames[1], P.Instance(
        L.skeletons[0], np.ones((5, 2)), track=L.tracks[0])),
    "add_instance_new_frame": lambda L, P: L.add_instance(P.LabeledFrame(L.videos[0], 20), P.Instance(
        L.skeletons[0], np.ones((5, 2)), track=P.Track(9, "new"))),
    "remove_instance": lambda L, P: L.remove_instance(L.labeled_frames[1], L.labeled_frames[1].instances[0]),
    "remove_track": lambda L, P: L.remove_track(L.tracks[1]),
    "remove_all_tracks": lambda L, P: L.remove_all_tracks(),
    "remove_unused_tracks": lambda L, P: L.remove_unused_tracks(),
    "find_track_occupancy": lambda L, P: L.find_track_occupancy(L.videos[0], L.tracks[0], (1, 6)),
    "find_track_occupancy_int": lambda L, P: L.find_track_occupancy(L.videos[0], 2),
    "track_swap": lambda L, P: L.track_swap(L.videos[0], L.tracks[1], L.tracks[0], (0, 6)),
    "track_swap_pseudo": lambda L, P: L.track_swap(L.videos[0], L.tracks[2], 2, (0, 10)),
    "track_set_instance": lambda L, P: L.track_set_instance(
        L.labeled_frames[0], L.labeled_frames[0].instances[0], L.tracks[1]),
    "track_set_instance_new": lambda L, P: L.track_set_instance(
        L.labeled_frames[4], L.labeled_frames[4].instances[1], P.Track(2, "fresh")),
    "make_video_callback": lambda L, P: P.Labels.make_video_callback(["a", "b"]),
    "complex_merge_between": _complex_merge,
    "finish_complex_merge": _finish_merge,
    "merge_nodes": lambda L, P: L.merge_nodes("wingL", "wingR"),
    "copy": lambda L, P: (lambda c: (c.labeled_frames[0].instances.pop(), c.remove_track(c.tracks[0]), c)[2])(L.copy()),
    "add_suggestion": lambda L, P: [L.add_suggestion(L.videos[0], 7), L.add_suggestion(L.videos[0], 2)],
    "remove_suggestion": lambda L, P: [L.remove_suggestion(L.videos[1], 0), L.remove_suggestion(L.videos[1], 3)],
    "clear_suggestions": lambda L, P: L.clear_suggestions(),
    "get_suggestions": lambda L, P: L.get_suggestions(),
    "set_suggestions": lambda L, P: L.set_suggestions([P.SuggestionFrame(L.videos[1], 3)]),
    "append_suggestions": lambda L, P: L.append_suggestions([P.SuggestionFrame(L.videos[1], 3, 2)]),
    "find_suggestion": lambda L, P: [L.find_suggestion(L.videos[0], 4), L.find_suggestion(L.videos[0], 5)],
    "get_video_suggestions": lambda L, P: [L.get_video_suggestions(L.videos[0]),
                                           L.get_video_suggestions(L.videos[1], user_labeled=False)],
    "unlabeled_suggestions": lambda L, P: L.unlabeled_suggestions,
    "get_unlabeled_suggestion_inds": lambda L, P: L.get_unlabeled_suggestion_inds(),
    "get_next_suggestion": lambda L, P: [L.get_next_suggestion(L.videos[v], f, d) for v, f, d in
                                         ((0, 2, 1), (0, 3, 1), (0, 3, -1), (0, 20, 1), (1, 0, -1), (1, 9, 1))],
    "get_next_suggestion_bad": lambda L, P: L.get_next_suggestion(L.videos[0], 2, 0),
    "remove_frame": lambda L, P: L.remove_frame(L.labeled_frames[5]),
    "remove_frames": lambda L, P: L.remove_frames(L.labeled_frames[1:4]),
    "remove_empty_frames": lambda L, P: L.remove_empty_frames(),
    "remove_empty_instances": lambda L, P: (L.labeled_frames[2].instances[0].points.__setitem__(
        "visible", False), L.remove_empty_instances(keep_empty_frames=False)),
    "remove_user_instances": lambda L, P: L.remove_user_instances(),
    "remove_user_instances_new_labels": lambda L, P: L.remove_user_instances(
        new_labels=P.Labels([P.LabeledFrame(L.videos[0], 1)])),
    "remove_predictions": lambda L, P: L.remove_predictions(),
    "remove_predictions_new_labels": lambda L, P: L.remove_predictions(
        new_labels=P.Labels([P.LabeledFrame(L.videos[0], 5), P.LabeledFrame(L.videos[1], 4)])),
    "remove_untracked_instances": lambda L, P: L.remove_untracked_instances(),
    "remove_untracked_keep_empty": lambda L, P: L.remove_untracked_instances(remove_empty_frames=False),
    "merge_matching_frames": lambda L, P: (L.labeled_frames.append(P.LabeledFrame(
        L.videos[0], 5, [P.Instance(L.skeletons[0], np.ones((5, 2)))])), L.merge_matching_frames()),
    "merge": lambda L, P: L.merge(make_project(P, seed=3)),
    "extract": lambda L, P: L.extract([4, 0, 9]),
    "extract_copy": lambda L, P: L.extract([4, 0], copy=True),
    "split": lambda L, P: L.split(0.3, seed=5),
    "split_int": lambda L, P: L.split(4, copy=False, seed=1),
    "with_user_labels_only": lambda L, P: L.with_user_labels_only(),
    "with_user_labels_only_tracked": lambda L, P: L.with_user_labels_only(user_instances_only=False,
                                                                          with_track_only=True),
    "to_dict": lambda L, P: L.to_dict(),
    "to_dict_skip_labels": lambda L, P: L.to_dict(skip_labels=True),
    "numpy_two_skeletons": lambda L, P: L.numpy(),
    "repr": lambda L, P: repr(L),
}


@pytest.mark.parametrize("name", sorted(LABELS_OPS))
def test_labels_method_matches_jax(name):
    assert_same(LABELS_OPS[name])


NUMPY_CASES = {
    "default": dict(),
    "labeled_range": dict(all_frames=False),
    "untracked": dict(untracked=True),
    "confidence": dict(return_confidence=True),
    "second_video": dict(video=1, all_frames=False, return_confidence=True),
    "video_object": dict(untracked=True, all_frames=False),
}


@pytest.mark.parametrize("name", sorted(NUMPY_CASES))
def test_labels_numpy_matches_jax(name):
    kw = NUMPY_CASES[name]

    def op(L, P):
        args = dict(kw)
        if name == "video_object":
            args["video"] = L.videos[1]
        return L.numpy(**args)

    assert_same(op, two_skeletons=False)


def test_labels_numpy_without_videos_raises_as_jax():
    for P in (TORCH, JAX):
        with pytest.raises(IndexError, match="no videos"):
            P.Labels().numpy()


def test_describe_prints_what_jax_prints():
    assert_same(lambda L, P: L.describe(), two_skeletons=False)


def test_complex_merge_reports_the_conflicts():
    mine, ref = run(_complex_merge, TORCH), run(_complex_merge, JAX)
    assert mine == ref
    merged, extra_base, extra_new = mine[0]
    assert extra_base and extra_new, "the seeded projects must conflict"


def test_slp_written_by_each_package_reads_back_the_same(tmp_path):
    """Each package's ``save``, read back by the JAX reader."""
    from sleap_tpu.io import slp as jslp

    for P, name in ((TORCH, "mine.slp"), (JAX, "ref.slp")):
        make_project(P).save(str(tmp_path / name))
    mine = jslp.read_labels(str(tmp_path / "mine.slp"), video_search=False)
    ref = jslp.read_labels(str(tmp_path / "ref.slp"), video_search=False)
    assert summary(mine) == summary(ref)


def test_load_file_of_jax_slp_equals_the_jax_reading(tmp_path):
    """Scores are float32 on disk, so the file is compared with itself read
    by each package."""
    make_project(JAX).save(str(tmp_path / "ref.slp"))
    mine = TORCH.Labels.load_file(str(tmp_path / "ref.slp"), video_search=False, device="cpu")
    ref = JAX.Labels.load_file(str(tmp_path / "ref.slp"), video_search=False)
    assert summary(mine) == summary(ref)


def test_labels_is_a_mutable_sequence():
    from collections.abc import MutableSequence

    assert isinstance(make_project(TORCH), MutableSequence)


# --------------------------------------------------------------------------- #
# LabeledFrame, InstancesList, Instance, PredictedInstance, Track
# --------------------------------------------------------------------------- #


FRAME_OPS = {
    "len_getitem": lambda L, P: (len(L[1]), L[1][2]),
    "setitem": lambda L, P: L[1].__setitem__(0, P.Instance(L.skeletons[0], np.ones((5, 2)))),
    "delitem": lambda L, P: L[1].__delitem__(0),
    "index": lambda L, P: L[1].index(L[1].instances[2]),
    "insert": lambda L, P: L[1].insert(1, P.Instance(L.skeletons[0], np.ones((5, 2)))),
    "insert_instance": lambda L, P: L[1].insert_instance(P.Instance(L.skeletons[0], np.ones((5, 2))), 0),
    "remove_instance": lambda L, P: L[1].remove_instance(L[1].instances[1]),
    "iter": lambda L, P: list(L[4]),
    "instances_setter": lambda L, P: setattr(L[1], "instances", L[1].instances[::-1]),
    "user_instances": lambda L, P: L[1].user_instances,
    "predicted_instances": lambda L, P: L[1].predicted_instances,
    "training_instances": lambda L, P: [lf.training_instances for lf in L],
    "has_user_instances": lambda L, P: [lf.has_user_instances for lf in L],
    "has_predicted_instances": lambda L, P: [lf.has_predicted_instances for lf in L],
    "has_tracked_instances": lambda L, P: [lf.has_tracked_instances for lf in L],
    "tracked_instances": lambda L, P: [lf.tracked_instances for lf in L],
    "n_user_instances": lambda L, P: [lf.n_user_instances for lf in L],
    "n_predicted_instances": lambda L, P: [lf.n_predicted_instances for lf in L],
    "n_tracked_instances": lambda L, P: [lf.n_tracked_instances for lf in L],
    "unused_predictions": lambda L, P: [lf.unused_predictions for lf in L],
    "instances_to_show": lambda L, P: [lf.instances_to_show for lf in L],
    "numpy": lambda L, P: [lf.numpy() for lf in L],
    "remove_untracked": lambda L, P: [lf.remove_untracked() for lf in L],
    "remove_empty_instances": lambda L, P: (L[0].instances[1].points.__setitem__("visible", False),
                                            L[0].remove_empty_instances()),
    "complex_frame_merge_clean": lambda L, P: P.LabeledFrame.complex_frame_merge(L[1], P.LabeledFrame(
        L.videos[0], 1, [clone(L[1].instances[0], P), P.Instance(L.skeletons[0], np.ones((5, 2)))])),
    "complex_frame_merge_conflict": lambda L, P: P.LabeledFrame.complex_frame_merge(L[1], P.LabeledFrame(
        L.videos[0], 1, [P.PredictedInstance.from_arrays(np.ones((5, 2)), np.ones(5), 1.0, L.skeletons[0])])),
    "complex_merge_between": lambda L, P: P.LabeledFrame.complex_merge_between(L, [
        P.LabeledFrame(L.videos[0], 1, [P.Instance(L.skeletons[0], np.zeros((5, 2)))]),
        P.LabeledFrame(L.videos[0], 15, [P.Instance(L.skeletons[0], np.zeros((5, 2)))])]),
    "repr": lambda L, P: repr(L[12].instances) if False else len(repr(L[0])) > 0,
    "list_append_bad": lambda L, P: L[1].instances.append("not an instance"),
    "list_pop_clears_frame": lambda L, P: (lambda i: i.frame is None)(L[1].instances.pop(0)),
    "list_remove": lambda L, P: L[1].instances.remove(L[1].instances[0]),
    "list_clear": lambda L, P: L[1].instances.clear(),
    "list_extend": lambda L, P: L[12].instances.extend([P.Instance(L.skeletons[0], np.ones((5, 2)))]),
    "list_copy": lambda L, P: type(L[1].instances.copy()).__name__,
    "list_labeled_frame": lambda L, P: L[1].instances.labeled_frame is L[1],
    "list_set_labeled_frame": lambda L, P: (setattr(L[1].instances, "labeled_frame", L[2]),
                                            [i.frame is L[2] for i in L[1].instances]),
}


@pytest.mark.parametrize("name", sorted(FRAME_OPS))
def test_labeled_frame_method_matches_jax(name):
    assert_same(FRAME_OPS[name])


INSTANCE_OPS = {
    "points": lambda L, P: L[1].instances[2].points,
    "getitem_name": lambda L, P: L[1].instances[2]["thorax"],
    "getitem_node": lambda L, P: L[1].instances[2][L.skeletons[0].nodes[3]],
    "getitem_int": lambda L, P: L[1].instances[0][4],
    "getitem_list": lambda L, P: L[1].instances[0][["head", "wingR"]],
    "setitem": lambda L, P: L[1].instances[2].__setitem__("head", (1.5, np.nan)),
    "setitem_point": lambda L, P: L[1].instances[2].__setitem__("head", P.make_point(3.0, 4.0, False)),
    "contains": lambda L, P: [n in L[1].instances[2] for n in ("head", "thorax", "nope")],
    "len": lambda L, P: len(L[1].instances[2]),
    "nodes": lambda L, P: L[1].instances[2].nodes,
    "n_visible_points": lambda L, P: [i.n_visible_points for i in L.all_instances],
    "numpy": lambda L, P: [i.numpy() for i in L.all_instances],
    "numpy_invisible": lambda L, P: [i.numpy(invisible_as_nan=False) for i in L.all_instances],
    "get_points_array": lambda L, P: [L[1].instances[2].get_points_array(invisible_as_nan=True),
                                      L[1].instances[0].get_points_array(full=True),
                                      L[1].instances[2].get_points_array(copy=False)],
    "points_array": lambda L, P: [i.points_array for i in L.all_instances],
    "transform_points_2x3": lambda L, P: L[1].instances[2].transform_points(
        np.array([[0.5, -0.2, 3.0], [0.1, 1.5, -2.0]])),
    "transform_points_3x3": lambda L, P: L[1].instances[0].transform_points(
        np.array([[0.5, -0.2, 3.0], [0.1, 1.5, -2.0], [0.0, 0.0, 1.0]])),
    "transform_points_2x2": lambda L, P: L[1].instances[0].transform_points(np.array([[0.0, 1.0], [1.0, 0.0]])),
    "centroid": lambda L, P: [i.centroid for i in L.all_instances],
    "bounding_box": lambda L, P: [i.bounding_box for i in L.all_instances],
    "midpoint": lambda L, P: [i.midpoint for i in L.all_instances],
    "video_frame_idx": lambda L, P: [(i.video, i.frame_idx) for i in L.all_instances],
    "free_instance_video": lambda L, P: (P.Instance(L.skeletons[0]).video, P.Instance(L.skeletons[0]).frame_idx),
    "from_numpy": lambda L, P: P.Instance.from_numpy(np.array([[1.0, 2.0], [np.nan, 1.0]]), L.skeletons[1],
                                                     track=L.tracks[0]),
    "from_pointsarray": lambda L, P: P.Instance.from_pointsarray(np.array([[1.0, 2.0], [3, 1.0]]), L.skeletons[1]),
    "from_dict": lambda L, P: P.Instance(L.skeletons[0], {"head": (1.0, 2.0), L.skeletons[0].nodes[2]: (5, 6),
                                                          "wingL": P.make_pred_point(7, 8, score=0.5)}),
    "from_dict_bad_node": lambda L, P: P.Instance(L.skeletons[0], {"nope": (1.0, 2.0)}),
    "too_many_points": lambda L, P: P.Instance(L.skeletons[1], P.empty_points(5)),
    "no_skeleton": lambda L, P: P.Instance(None),
    "fill_missing": lambda L, P: (np.random.seed(4), L[1].instances[2].fill_missing(max_x=50.0, max_y=40.0)),
    "fill_missing_empty": lambda L, P: (np.random.seed(4), P.Instance(L.skeletons[0]).fill_missing()),
    "matches": lambda L, P: [[a.matches(b) for b in L[1].instances] + [a.matches(clone(a, P))]
                             for a in L[1].instances],
    "scores": lambda L, P: [i.scores for i in L.predicted_instances],
    "points_and_scores_array": lambda L, P: [i.points_and_scores_array for i in L.predicted_instances],
    "predicted_from_numpy": lambda L, P: P.PredictedInstance.from_numpy(
        np.array([[1.0, 2.0], [np.nan, 1.0]]), np.array([0.5, np.nan]), 0.7, L.skeletons[1]),
    "predicted_from_pointsarray": lambda L, P: P.PredictedInstance.from_pointsarray(
        np.array([[1.0, 2.0], [4, 1.0]]), np.array([0.5, 0.1]), 0.7, L.skeletons[1], tracking_score=0.2),
    "from_instance": lambda L, P: P.PredictedInstance.from_instance(L[1].instances[2], 0.25),
    "skeleton_grows": lambda L, P: (L.skeletons[0].add_node("leg"), [i.points for i in L.all_instances]),
    "skeleton_shrinks": lambda L, P: (L.skeletons[0].delete_node("abdomen"), [i.points for i in L.all_instances]),
    "skeleton_relabels": lambda L, P: (L.skeletons[0].relabel_nodes({"head": "front"}),
                                       [i["front"] for i in L[1].instances]),
    "repr_kinds": lambda L, P: [type(i).__name__ for i in L.all_instances],
    "make_point": lambda L, P: [P.make_point(), P.make_point(1.0, 2.0, False, True)],
    "make_pred_point": lambda L, P: [P.make_pred_point(), P.make_pred_point(1.0, 2.0, True, False, 0.5)],
    "empty_points": lambda L, P: [P.empty_points(3), P.empty_points(2, predicted=True)],
    "track_matches": lambda L, P: [[a.matches(b) for b in L.tracks + [P.Track(0, "t0")]] for a in L.tracks],
    "isinstance": lambda L, P: [isinstance(i, P.Instance) for i in L.all_instances],
}


@pytest.mark.parametrize("name", sorted(INSTANCE_OPS))
def test_instance_method_matches_jax(name):
    assert_same(INSTANCE_OPS[name])


def test_predicted_instance_is_an_instance_in_both_packages():
    """``PredictedInstance`` subclasses ``Instance`` in the port as in the
    JAX package, so ``isinstance`` and ``type(...) is`` agree, and the
    user-instance filters (``type(...) is Instance``, ``.predicted``) still
    pick the same instances."""
    for P in (TORCH, JAX):
        skel = make_skeletons(P)[1]
        user = P.Instance(skel, np.ones((2, 2)))
        pred = P.PredictedInstance.from_arrays(np.ones((2, 2)), np.ones(2), 1.0, skel)
        assert issubclass(P.PredictedInstance, P.Instance)
        assert [isinstance(user, P.Instance), isinstance(pred, P.Instance),
                isinstance(user, P.PredictedInstance), isinstance(pred, P.PredictedInstance)] == \
            [True, True, False, True]
        assert [type(user) is P.Instance, type(pred) is P.Instance] == [True, False]
        assert [user.predicted, pred.predicted] == [False, True]
    mine, ref = make_project(TORCH), make_project(JAX)
    assert norm(mine.user_instances, mine) == norm(ref.user_instances, ref)
    assert [[type(i) is TORCH.Instance for i in lf] for lf in mine] == \
        [[type(i) is JAX.Instance for i in lf] for lf in ref]


# --------------------------------------------------------------------------- #
# Skeleton
# --------------------------------------------------------------------------- #


def _skel_state(s):
    return (s.name, s.node_names, [tuple(e) for e in s.edge_names], [tuple(p) for p in s.symmetry_names],
            s.edge_inds, s.symmetric_inds, s.flip_idx(), s.n_nodes, s.n_edges, s.to_dict())


SKELETON_OPS = {
    "state": lambda s, P: None,
    "add_node_dup": lambda s, P: s.add_node("head"),
    "add_node_bad": lambda s, P: s.add_node(3),
    "add_nodes": lambda s, P: s.add_nodes(["a", "b"]),
    "delete_node": lambda s, P: s.delete_node("thorax"),
    "delete_node_missing": lambda s, P: s.delete_node("nope"),
    "relabel_node": lambda s, P: s.relabel_node("wingL", "lw"),
    "relabel_nodes_clash": lambda s, P: s.relabel_nodes({"wingL": "head"}),
    "relabel_nodes_swap": lambda s, P: s.relabel_nodes({"wingL": "wingR", "wingR": "wingL"}),
    "add_edge_dup": lambda s, P: s.add_edge("head", "thorax"),
    "add_edge_missing": lambda s, P: s.add_edge("head", "nope"),
    "add_edge_nodes": lambda s, P: s.add_edge(s.nodes[4], s.nodes[0]),
    "delete_edge": lambda s, P: (s.delete_edge("thorax", "abdomen"), s.add_edge("abdomen", "head")),
    "delete_edge_missing": lambda s, P: s.delete_edge("abdomen", "thorax"),
    "clear_edges": lambda s, P: s.clear_edges(),
    "has_edge": lambda s, P: [s.has_edge("head", "thorax"), s.has_edge("thorax", "head"),
                              s.has_edge("wingL", "wingR"), s.has_edge("x", "head")],
    "edge_to_index": lambda s, P: [s.edge_to_index("thorax", "wingL"), s.edge_to_index("wingL", "thorax")],
    "edges_full": lambda s, P: [(a.name, b.name, k, sorted(d.items())) for a, b, k, d in s.edges_full],
    "find_neighbors": lambda s, P: [s.find_neighbors(n) for n in ("thorax", "head", "nope")],
    "root_nodes": lambda s, P: s.root_nodes,
    "is_arborescence": lambda s, P: [s.is_arborescence, (s.add_edge("abdomen", "wingL"), s.is_arborescence)[1]],
    "is_arborescence_forest": lambda s, P: (s.add_node("extra"), s.is_arborescence)[1],
    "is_arborescence_empty": lambda s, P: raises(lambda: P.Skeleton().is_arborescence),
    "node_to_index": lambda s, P: [s.node_to_index("abdomen"), s.node_to_index(s.nodes[3])],
    "find_node": lambda s, P: [s.find_node("wingR"), s.find_node(s.nodes[1]), s.find_node("x")],
    "has_nodes": lambda s, P: [s.has_node("head"), s.has_nodes(["head", "wingL"]), s.has_nodes(["head", "x"])],
    "contains": lambda s, P: ["head" in s, "x" in s],
    "get_symmetry": lambda s, P: [s.get_symmetry("wingL"), s.get_symmetry(s.nodes[4]), s.get_symmetry("head")],
    "add_symmetry_taken": lambda s, P: s.add_symmetry("head", "wingL"),
    "add_symmetry_self": lambda s, P: s.add_symmetry("head", "head"),
    "delete_symmetry": lambda s, P: (s.delete_symmetry("wingR", "wingL"), s.add_symmetry("head", "abdomen")),
    "delete_symmetry_missing": lambda s, P: s.delete_symmetry("head", "abdomen"),
    "matches": lambda s, P: [s.matches(make_skeletons(P)[0]), s.matches(make_skeletons(P)[1])],
    "to_json": lambda s, P: json.loads(s.to_json()),
    "to_json_indexed": lambda s, P: json.loads(s.to_json({n: i + 10 for i, n in enumerate(s.nodes)})),
    "from_names_and_edge_inds": lambda s, P: _skel_state(P.Skeleton.from_names_and_edge_inds(
        ["a", "b", "c"], [(0, 1), (1, 2)], name="abc")),
    "node_from_names": lambda s, P: [P.Node.from_names(["a", "b"]), P.Node("a").matches(P.Node("a", 1.0)),
                                     P.Node("a").matches(P.Node("a", 2.0))],
    "edge_type": lambda s, P: [P.EdgeType.BODY, P.EdgeType.SYMMETRY],
    "repr": lambda s, P: repr(s),
}


@pytest.mark.parametrize("name", sorted(SKELETON_OPS))
def test_skeleton_method_matches_jax(name):
    def call(P):
        s = make_skeletons(P)[0]
        try:
            value = norm(SKELETON_OPS[name](s, P), None)
        except Exception as e:
            value = ("raised", type(e).__name__)
        return value, _skel_state(s)

    assert call(TORCH) == call(JAX)


@pytest.mark.parametrize("style", ["jsonpickle", "indexed"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_skeleton_json_both_styles_both_directions(style, direction, tmp_path):
    src, dst = (JAX, TORCH) if direction == "jax_to_port" else (TORCH, JAX)
    skel = make_skeletons(src)[0]
    skel.delete_edge("thorax", "abdomen")
    skel.add_edge("abdomen", "thorax")  # insertion order differs from node order
    if style == "indexed":
        node_list_src = list(skel.nodes)[::-1]
        text = skel.to_json({n: i for i, n in enumerate(node_list_src)})
        node_list = [dst.Node(n.name, n.weight) for n in node_list_src]
        back = dst.Skeleton.from_json(text, node_list)
        assert all(any(n is m for m in node_list) for n in back.nodes)
    else:
        path = str(tmp_path / "skel.json")
        skel.save_json(path)
        back = dst.Skeleton.load_json(path)
    assert _skel_state(back)[:9] == _skel_state(skel)[:9]
    assert back.to_dict() == skel.to_dict()
    assert dst.Skeleton.from_dict(json.loads(back.to_json())).to_dict() == skel.to_dict()


@pytest.mark.parametrize("name", ["bees", "flies13", "fly32", "gerbils", "mice_hc", "mice_of"])
def test_load_template_matches_jax(name):
    assert _skel_state(TORCH.load_template(name)) == _skel_state(JAX.load_template(name))


def test_load_template_missing_raises_as_jax():
    for P in (TORCH, JAX):
        with pytest.raises(FileNotFoundError, match="available"):
            P.load_template("nope")


def test_load_mat_matches_jax(tmp_path):
    from scipy.io import savemat

    names = np.empty((3, 1), dtype=object)
    for i, n in enumerate(["head", "body", "tail"]):
        names[i, 0] = np.array([n])
    path = str(tmp_path / "skel.mat")
    savemat(path, {"nodeNames": names, "edges": np.array([[1, 2], [2, 3]])})
    assert _skel_state(TORCH.Skeleton.load_mat(path)) == _skel_state(JAX.Skeleton.load_mat(path))


def test_graph_and_body_graph_are_the_jax_networkx_graphs():
    a, b = make_skeletons(TORCH)[0], make_skeletons(JAX)[0]
    for get in (lambda s: s.graph, lambda s: s.body_graph):
        ga, gb = get(a), get(b)
        assert [n.name for n in ga.nodes] == [n.name for n in gb.nodes]
        ea = [(u.name, v.name, k, sorted(d.items())) for u, v, k, d in ga.edges(keys=True, data=True)]
        eb = [(u.name, v.name, k, sorted(d.items())) for u, v, k, d in gb.edges(keys=True, data=True)]
        assert ea == eb and ga.graph == gb.graph


def test_graph_without_networkx_names_the_package(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "networkx", None)
    skel = make_skeletons(TORCH)[0]
    assert skel.is_arborescence and skel.edges  # the queries need nothing
    with pytest.raises(ImportError, match="networkx"):
        skel.graph


# --------------------------------------------------------------------------- #
# RangeList and Video
# --------------------------------------------------------------------------- #


RANGE_OPS = {
    "insert": lambda r: r.insert((8, 12)),
    "insert_adjacent": lambda r: r.insert((5, 7)),
    "insert_empty": lambda r: r.insert((4, 4)),
    "insert_range": lambda r: r.insert(range(30, 33)),
    "insert_list": lambda r: r.insert_list([(40, 41), (0, 1)]),
    "add": lambda r: r.add(7),
    "remove": lambda r: r.remove((3, 22)),
    "cut": lambda r: r.cut(3),
    "cut_range": lambda r: r.cut_range((3, 21)),
    "join": lambda r: type(r).join([[(1, 2)], [(2, 5), (9, 10)]]),
    "properties": lambda r: (r.is_empty, r.start, type(r)().is_empty, type(r)().start),
    "list_setter": lambda r: setattr(r, "list", [[1, 3]]),
    "repr": lambda r: repr(r),
}


@pytest.mark.parametrize("name", sorted(RANGE_OPS))
def test_rangelist_matches_jax(name):
    results = []
    for P in (TORCH, JAX):
        r = P.RangeList([(2, 5), (10, 20)])
        results.append((norm(RANGE_OPS[name](r), None), r.list))
    assert results[0] == results[1]


def test_video_members_match_jax(tmp_path):
    import h5py

    frames = np.random.default_rng(0).integers(0, 255, (4, 6, 5, 1), dtype=np.uint8)
    path = str(tmp_path / "v.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("box", data=frames)
    out = []
    for P, kw in ((TORCH, {"device": "cpu"}), (JAX, {})):
        v = P.Video.from_hdf5("box", path, **kw)
        w = P.Video.from_hdf5("box", path, **kw)
        idxs, got = v.get_frames_safely([0, 9, 2])
        backend = v.backend
        n = P.Video.from_numpy(frames)
        entry = [v.matches(w), v.matches(n), json.loads(v.to_json()), v.last_frame_idx, idxs, got,
                 backend.dtype, backend.source_video_available, n.backend.dtype, n.backend.test_frame,
                 n.last_frame_idx, P.Video(P.DummyVideo(filename="d", height=3, width=2)).backend.test_frame.shape]
        backend.reset()
        n.backend.reset()
        entry.append(v.get_frame(1))
        out.append(entry)
    for a, b in zip(*out):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_in_memory_videos_match_only_themselves():
    """The JAX package's in-memory videos all compare equal once read (their
    filename becomes "numpy_video"), so its Labels registers one of them;
    the port's ``Video.matches`` and registries keep them apart (ROADMAP.md
    queue 3, item 5)."""
    frames = np.zeros((2, 4, 4, 1), np.uint8)
    ja, jb = JAX.Video.from_numpy(frames), JAX.Video.from_numpy(frames.copy())
    ta, tb = TORCH.Video.from_numpy(frames), TORCH.Video.from_numpy(frames.copy())
    for v in (ja, jb, ta, tb):
        v.get_frame(0)
    assert ja.matches(jb) and not ta.matches(tb) and ta.matches(ta)
    skel = make_skeletons(TORCH)[1]
    labels = TORCH.Labels([TORCH.LabeledFrame(v, 0, [TORCH.Instance(skel, np.ones((2, 2)))]) for v in (ta, tb)])
    assert len(labels.videos) == 2
    jskel = make_skeletons(JAX)[1]
    jlabels = JAX.Labels([JAX.LabeledFrame(v, 0, [JAX.Instance(jskel, np.ones((2, 2)))]) for v in (ja, jb)])
    assert len(jlabels.videos) == 1
