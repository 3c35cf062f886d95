"""The port's tracking (``sleap_tpu_torch.tracking``) against the JAX
package's, on the CPU.

Instance streams are made with numpy from seeds and built into each
package's own instances and frames. Components: every similarity, scalar
and batched (OKS with per-node errors, score weighting and each
normalization), the three matchers, ``FrameMatches`` with a robust
quantile, culling, single-break repair and the Kalman tracker's
second-best suppression, all equal to JAX's (the same numpy arithmetic).
Trackers: ``make_tracker_by_name`` over every tracker x similarity x match
and the options around them, on rendered frames with two animals that
cross and a third that appears: the same track per instance per frame,
tracking scores within 1e-5 (flow moves points by ~1e-5 px more or less
than JAX's, see ``test_torch_optical_flow.py``) and the same spawned
tracks. End to end: ``load_model(..., tracker="flow")`` of the trained
top-down, bottom-up and single-instance folders against JAX's on a
moving-blob clip: the same track per instance and the same
``Labels.tracks``.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import sleap_tpu
import sleap_tpu_torch
from sleap_tpu.core import instance as jinst
from sleap_tpu.core.skeleton import Skeleton as JSkeleton
from sleap_tpu.io.video import Video as JVideo
from sleap_tpu.tracking import components as jc
from sleap_tpu.tracking import kalman as jk
from sleap_tpu.tracking import tracker as jt
from sleap_tpu_torch.core import instance as tinst
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton as TSkeleton
from sleap_tpu_torch.io.video import Video as TVideo
from sleap_tpu_torch.tracking import components as tc
from sleap_tpu_torch.tracking import kalman as tk
from sleap_tpu_torch.tracking import tracker as tt

torch.set_num_threads(1)

SCORE_TOL = 1e-5
RUNS = Path(__file__).resolve().parent.parent / ".convergence_runs"


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


N_NODES = 3


def skeletons():
    out = []
    for cls in (JSkeleton, TSkeleton):
        sk = cls("chain")
        for i in range(N_NODES):
            sk.add_node(f"n{i}")
        sk.add_edge("n0", "n1")
        sk.add_edge("n1", "n2")
        out.append(sk)
    return out


JSK, TSK = skeletons()


def both(points, confs, score):
    """The same predicted instance in each package: (jax, port)."""
    return (jinst.PredictedInstance.from_arrays(points, confs, score, JSK),
            tinst.PredictedInstance.from_arrays(points, confs, score, TSK))


def random_instances(rng, n, nan_rate=0.15, spread=6.0):
    """n instances of N_NODES points around a few centres, some points NaN."""
    out = []
    for _ in range(n):
        centre = rng.uniform(10, 50, 2)
        pts = centre + rng.normal(0, spread, (N_NODES, 2))
        pts[rng.uniform(size=N_NODES) < nan_rate] = np.nan
        out.append(both(pts, rng.uniform(0.2, 1.0, N_NODES), float(rng.uniform(0.5, 3))))
    return out


def shifted_both(rng, n):
    """Non-predicted candidates (flow-shifted instances), float32 points."""
    out = []
    for _ in range(n):
        pts = (rng.uniform(10, 50, 2) + rng.normal(0, 6.0, (N_NODES, 2))).astype("f4")
        pts[rng.uniform(size=N_NODES) < 0.15] = np.nan
        out.append((jt.ShiftedInstance(pts, JSK, None, 0), tt.ShiftedInstance(pts, TSK, None, 0)))
    return out


# --------------------------------------------------------------------------- #
# Components
# --------------------------------------------------------------------------- #

OKS_OPTIONS = [
    dict(),
    dict(keypoint_errors=[2.0, 4.0, 8.0]),
    dict(keypoint_errors=3.0, score_weighting=True),
    dict(keypoint_errors=[2.0, 4.0, 8.0], score_weighting=True, normalization_keypoints="ref"),
    dict(score_weighting=True, normalization_keypoints="union"),
]
SIMILARITIES = ["instance", "normalized_instance", "centroid", "iou"] + [
    f"oks{i}" for i in range(len(OKS_OPTIONS))]


def similarity(pkg, name):
    if name.startswith("oks"):
        return pkg.factory_object_keypoint_similarity(**OKS_OPTIONS[int(name[3:])])
    return {"instance": pkg.instance_similarity,
            "normalized_instance": pkg.normalized_instance_similarity,
            "centroid": pkg.centroid_distance, "iou": pkg.instance_iou}[name]


@pytest.mark.parametrize("name", SIMILARITIES)
def test_similarities_match_jax(name):
    rng = np.random.default_rng(0)
    refs = random_instances(rng, 6) + shifted_both(rng, 3)
    queries = random_instances(rng, 5) + shifted_both(rng, 2)
    jfn, tfn = similarity(jc, name), similarity(tc, name)
    with np.errstate(all="ignore"):
        for (jr, tr) in refs:
            for (jq, tq) in queries:
                np.testing.assert_array_equal(tfn(tr, tq), jfn(jr, jq))
                if name == "normalized_instance":
                    np.testing.assert_array_equal(tfn(tr, tq, img_hw=(60, 80)),
                                                  jfn(jr, jq, img_hw=(60, 80)))
        got = tfn.batch_fn([t for _, t in refs], [t for _, t in queries])
        want = jfn.batch_fn([j for j, _ in refs], [j for j, _ in queries])
    assert got.shape == (9, 7)
    np.testing.assert_array_equal(got, want)


def test_matchers_match_jax():
    rng = np.random.default_rng(1)
    for shape in ((4, 4), (3, 5), (6, 2), (1, 3)):
        for _ in range(5):
            cost = rng.uniform(-1, 0, shape)
            cost[rng.uniform(size=shape) < 0.2] = np.inf
            for name in ("greedy_matching", "hungarian_matching", "first_choice_matching"):
                got = [tuple(map(int, m)) for m in getattr(tc, name)(cost)]
                want = [tuple(map(int, m)) for m in getattr(jc, name)(cost)]
                assert got == want, (name, cost)


@pytest.mark.parametrize("robust", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("batched", [True, False])
def test_frame_matches_match_jax(robust, batched):
    """Candidates of 3 tracks (2-3 instances each) against 4 new instances;
    the batched similarity and the scalar loop (an unlisted callable)."""
    rng = np.random.default_rng(2)
    tracks = [(jinst.Track(name=f"t{i}"), tinst.Track(name=f"t{i}")) for i in range(3)]
    cands = []
    for k, n in enumerate((3, 2, 3)):
        for j, t in random_instances(rng, n, spread=2.0):
            j.track, t.track = tracks[k]
            cands.append((j, t))
    untracked = random_instances(rng, 4, spread=2.0)
    jfn, tfn = jc.instance_similarity, tc.instance_similarity
    if not batched:
        jfn = lambda a, b: jc.instance_similarity(a, b)  # noqa: E731
        tfn = lambda a, b: tc.instance_similarity(a, b)  # noqa: E731
    out = []
    for k, (pkg, fn) in enumerate(((jc, jfn), (tc, tfn))):
        out.append(pkg.FrameMatches.from_candidate_instances(
            untracked_instances=[u[k] for u in untracked],
            candidate_instances=[c[k] for c in cands],
            similarity_function=fn, matching_function=pkg.greedy_matching,
            robust_best_instance=robust,
        ))
    want, got = out
    np.testing.assert_array_equal(got.cost_matrix, want.cost_matrix)
    assert [(untracked_index(m.instance, untracked, 1), m.track.name, m.score, m.is_first_choice)
            for m in got.matches] == [
        (untracked_index(m.instance, untracked, 0), m.track.name, m.score, m.is_first_choice)
        for m in want.matches]
    assert len(got.matches) >= 2
    assert [untracked_index(i, untracked, 1) for i in got.unmatched_instances] == [
        untracked_index(i, untracked, 0) for i in want.unmatched_instances]


def untracked_index(inst, pairs, side):
    return next(k for k, p in enumerate(pairs) if p[side] is inst)


def frame_stream(seed, n_frames=12, per_frame=(3, 4)):
    """Frames of instances with tracks named per animal in each package
    (jax frames, port frames); a track breaks and a new one starts."""
    rng = np.random.default_rng(seed)
    jtracks = {n: jinst.Track(name=n) for n in ("a", "b", "c", "d")}
    ttracks = {n: tinst.Track(name=n) for n in ("a", "b", "c", "d")}
    jv, tv = JVideo.from_numpy(np.zeros((1, 8, 8, 1), np.uint8)), TVideo.from_numpy(
        np.zeros((1, 8, 8, 1), np.uint8))
    jframes, tframes = [], []
    for f in range(n_frames):
        # b is lost at frame 5, and d starts at frame 6.
        names = ["a", "b", "c"] if f < 5 else ["a", "c"] if f == 5 else ["a", "d", "c"]
        n = int(rng.integers(*per_frame)) if f % 3 == 0 else len(names)
        insts = random_instances(rng, n, nan_rate=0.1, spread=4.0)
        if f % 3 == 0 and n > 1:  # an overlapping duplicate, for NMS
            pts = np.nan_to_num(insts[0][1].numpy()) + 0.5
            insts[-1] = both(pts, np.full(N_NODES, 0.3), 0.1)
        for k, (j, t) in enumerate(insts):
            name = names[k % len(names)]
            j.track, t.track = jtracks[name], ttracks[name]
        jframes.append(jinst.LabeledFrame(video=jv, frame_idx=f, instances=[j for j, _ in insts]))
        tframes.append(tinst.LabeledFrame(video=tv, frame_idx=f, instances=[t for _, t in insts]))
    return jframes, tframes


def frame_summary(frames):
    return [[(inst.track.name if inst.track else None, inst.score,
              np.nan_to_num(inst.numpy()).tobytes()) for inst in lf.instances] for lf in frames]


@pytest.mark.parametrize("iou", [None, 0.2])
def test_cull_instances_matches_jax(iou):
    jframes, tframes = frame_stream(3)
    jc.cull_instances(jframes, 2, iou)
    tc.cull_instances(tframes, 2, iou)
    assert frame_summary(tframes) == frame_summary(jframes)
    assert max(len(lf.instances) for lf in tframes) == 2
    for jf, tf in zip(jframes, tframes):
        got = tc.cull_frame_instances(list(tf.instances), 1, iou)
        want = jc.cull_frame_instances(list(jf.instances), 1, iou)
        assert [i.score for i in got] == [i.score for i in want]


def test_connect_single_track_breaks_matches_jax():
    jframes, tframes = frame_stream(4, per_frame=(3, 4))
    before = frame_summary(tframes)
    jc.connect_single_track_breaks(jframes, 3)
    tc.connect_single_track_breaks(tframes, 3)
    assert frame_summary(tframes) == frame_summary(jframes)
    assert frame_summary(tframes) != before  # "d" became "b" from frame 6


def test_nms_matches_jax():
    rng = np.random.default_rng(5)
    boxes = np.sort(rng.uniform(0, 20, (8, 4)).reshape(8, 2, 2), axis=1).transpose(0, 2, 1)
    boxes = boxes.reshape(8, 4)[:, [0, 2, 1, 3]]
    scores = rng.uniform(size=8)
    for thr in (0.0, 0.1, 0.3):
        assert tc.nms_fast(boxes, scores, thr) == jc.nms_fast(boxes, scores, thr)


def test_remove_second_bests_matches_jax():
    rng = np.random.default_rng(6)
    for shape in ((3, 3), (4, 2), (2, 5)):
        for thresh in (0.05, 0.3):
            cost = rng.uniform(0, 1, shape)
            cost[rng.uniform(size=shape) < 0.2] = np.nan
            for invalid in (np.nan, np.inf):
                np.testing.assert_array_equal(
                    tk.remove_second_bests_from_cost_matrix(cost, thresh, invalid),
                    jk.remove_second_bests_from_cost_matrix(cost, thresh, invalid))


# --------------------------------------------------------------------------- #
# Trackers on rendered frames
# --------------------------------------------------------------------------- #

HW, N_FRAMES = 96, 14
# (first frame, start xy, velocity xy per frame): a and b cross near frame 7,
# c appears at frame 5.
ANIMALS = [(0, (18.0, 40.0), (4.2, 0.6)), (0, (78.0, 48.0), (-4.0, -0.4)),
           (5, (44.0, 80.0), (1.0, -1.6))]


def render_stream(seed=0, channels=1):
    """(frames uint8 (T, HW, HW, C), per-frame list of (points, confs,
    score)) for animals of 3 nodes 5 px apart, drawn as sigma-2.5 blobs on
    a smooth seeded background; points carry 0.4 px noise, a few are NaN,
    and the instances of a frame come in a seeded order."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HW, 0:HW]
    spec = np.fft.fft2(rng.standard_normal((HW, HW)))
    f = np.fft.fftfreq(HW)
    spec *= np.exp(-2 * (np.pi * 3.0) ** 2 * (f[:, None] ** 2 + f[None, :] ** 2))
    bg = np.real(np.fft.ifft2(spec))
    bg = 40 * (bg - bg.min()) / (bg.max() - bg.min())
    frames, insts = [], []
    for t in range(N_FRAMES):
        img = bg.copy()
        frame_insts = []
        for a, (t0, start, vel) in enumerate(ANIMALS):
            if t < t0:
                continue
            head = np.array(start) + np.array(vel) * (t - t0)
            direction = np.array(vel) / np.linalg.norm(vel)
            nodes = head - np.arange(N_NODES)[:, None] * 5.0 * direction
            for x, y in nodes:
                img += 150 * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 2.5**2))
            pts = nodes + rng.normal(0, 0.4, nodes.shape)
            if (t + a) % 6 == 5:
                pts[2] = np.nan
            confs = rng.uniform(0.5, 1.0, N_NODES)
            frame_insts.append((pts, confs, float(np.nansum(confs))))
        frame_insts = [frame_insts[i] for i in rng.permutation(len(frame_insts))]
        frames.append(np.clip(img, 0, 255))
        insts.append(frame_insts)
    frames = np.stack(frames).astype(np.uint8)[..., None]
    if channels == 3:  # BGR frames: the tracker takes their luma
        frames = np.concatenate([frames, np.clip(frames * 0.9, 0, 255).astype(np.uint8),
                                 frames // 2], axis=-1)
    return frames, insts


def stream_frames(frames, insts):
    """Each package's labeled frames over its own video of ``frames``."""
    jv, tv = JVideo.from_numpy(frames), TVideo.from_numpy(frames)
    jframes, tframes = [], []
    for t, frame_insts in enumerate(insts):
        pairs = [both(*inst) for inst in frame_insts]
        jframes.append(jinst.LabeledFrame(video=jv, frame_idx=t, instances=[p[0] for p in pairs]))
        tframes.append(tinst.LabeledFrame(video=tv, frame_idx=t, instances=[p[1] for p in pairs]))
    return jframes, tframes


def tracked(frames):
    return [[(inst.track.name if inst.track else None, inst.tracking_score)
             for inst in lf.instances] for lf in frames]


def assert_same_tracking(tframes, jframes):
    got, want = tracked(tframes), tracked(jframes)
    assert [[n for n, _ in f] for f in got] == [[n for n, _ in f] for f in want]
    np.testing.assert_allclose([s for f in got for _, s in f], [s for f in want for _, s in f],
                               atol=SCORE_TOL, rtol=0)


def spawned(tracker):
    tracker = getattr(tracker, "init_tracker", tracker)
    return [(t.name, t.spawned_on) for t in tracker.spawned_tracks]


TRACKERS = ["flow", "simple", "flowmaxtracks", "simplemaxtracks"]
TRACKER_SIMILARITIES = ["instance", "normalized_instance", "centroid", "iou", "object_keypoint"]
MATCHES = ["greedy", "hungarian"]
MATRIX = [(tr, sim, m, {}) for tr in TRACKERS for sim in TRACKER_SIMILARITIES for m in MATCHES]
OPTIONS = [
    ("flow", "instance", "greedy", dict(img_scale=0.5, channels=3)),
    ("flow", "instance", "greedy", dict(kf_init_frame_count=5, kf_node_indices=[0, 1],
                                        target_instance_count=3)),
    ("flow", "iou", "hungarian", dict(target_instance_count=2, pre_cull_to_target=True,
                                      pre_cull_iou_threshold=0.3)),
    ("simple", "instance", "greedy", dict(clean_instance_count=2, clean_iou_threshold=0.3)),
    ("flow", "centroid", "greedy", dict(target_instance_count=3,
                                        post_connect_single_breaks=True, track_window=2)),
    ("flow", "object_keypoint", "first_choice", dict(robust=0.5, oks_errors=[3.0, 3.0, 6.0],
                                                     oks_score_weighting=True)),
]


def case_id(case):
    tracker, sim, match, opts = case
    return "-".join([tracker, sim, match] + sorted(k for k in opts if k != "channels"))


@pytest.mark.parametrize("case", MATRIX + OPTIONS, ids=case_id)
def test_make_tracker_by_name_matches_jax(case):
    tracker, sim, match, opts = case
    opts = dict(opts)
    frames, insts = render_stream(channels=opts.pop("channels", 1))
    if tracker.endswith("maxtracks"):
        opts["max_tracks"] = 3
    jframes, tframes = stream_frames(frames, insts)
    jtracker = jt.Tracker.make_tracker_by_name(tracker=tracker, similarity=sim, match=match,
                                               **opts)
    ttracker = tt.Tracker.make_tracker_by_name(tracker=tracker, similarity=sim, match=match,
                                               device="cpu", **opts)
    jt.run_tracker(jframes, jtracker)
    tt.run_tracker(tframes, ttracker)
    assert_same_tracking(tframes, jframes)
    assert spawned(ttracker) == spawned(jtracker)
    n_tracked = sum(inst.track is not None for lf in tframes for inst in lf.instances)
    assert n_tracked >= sum(map(len, insts)) // 2


def test_flow_candidates_match_jax():
    """The flow-shifted candidates of every frame (``save_shifted_instances``):
    the same shifted instances, points within 1e-3 px."""
    frames, insts = render_stream(seed=1)
    jframes, tframes = stream_frames(frames, insts)
    kw = dict(tracker="flow", save_shifted_instances=True)
    jtracker = jt.Tracker.make_tracker_by_name(**kw)
    ttracker = tt.Tracker.make_tracker_by_name(device="cpu", **kw)
    jt.run_tracker(jframes, jtracker)
    tt.run_tracker(tframes, ttracker)
    got, want = ttracker.candidate_maker.shifted_instances, jtracker.candidate_maker.shifted_instances
    assert list(got) == list(want) and len(got) >= 20
    for key in want:
        assert [s.track.name for s in got[key]] == [s.track.name for s in want[key]]
        for g, w in zip(got[key], want[key]):
            assert g.points_array.dtype == w.points_array.dtype == np.float32
            np.testing.assert_array_equal(np.isnan(g.points_array), np.isnan(w.points_array))
            np.testing.assert_allclose(np.nan_to_num(g.points_array),
                                       np.nan_to_num(w.points_array), atol=1e-3, rtol=0)
            assert g.frame_t == w.frame_t
            np.testing.assert_allclose(g.shift_score, w.shift_score, rtol=1e-4, atol=1e-4)


def test_flow_shift_instances_and_precomputed_candidates_match_jax():
    """The JAX signature of one pair's flow shift, and a tracker whose
    candidates come from a ``shift_fn`` built on it."""
    frames, insts = render_stream(seed=5)
    jframes, tframes = stream_frames(frames, insts)
    got = tt.FlowCandidateMaker.flow_shift_instances(
        tframes[3].instances, frames[3], frames[4], frame_t=3, device="cpu")
    want = jt.FlowCandidateMaker.flow_shift_instances(
        jframes[3].instances, frames[3], frames[4], frame_t=3)
    assert len(got) == len(want) == len(insts[3])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.points_array, w.points_array, atol=1e-3, rtol=0)
        assert g.frame_t == w.frame_t == 3

    def shift_fn(pkg, frame_list, **kw):
        return lambda ref_t, t, ref_instances: pkg.FlowCandidateMaker.flow_shift_instances(
            ref_instances, frame_list[ref_t].image, frame_list[t].image, frame_t=ref_t, **kw)

    jtracker = jt.Tracker(candidate_maker=jt.PrecomputedFlowCandidateMaker(
        shift_fn=shift_fn(jt, jframes)))
    ttracker = tt.Tracker(candidate_maker=tt.PrecomputedFlowCandidateMaker(
        shift_fn=shift_fn(tt, tframes, device="cpu")))
    jt.run_tracker(jframes, jtracker)
    tt.run_tracker(tframes, ttracker)
    assert_same_tracking(tframes, jframes)
    assert spawned(ttracker) == spawned(jtracker)


def test_flow_shift_pairs_of_two_frame_sizes_match_jax():
    """A window holding frames of two sizes (mixed-size videos): one
    batched call per size, each pair as JAX shifts it."""
    frames, insts = render_stream(seed=6)
    jframes, tframes = stream_frames(frames, insts)
    small = np.ascontiguousarray(frames[:, :80, :88])
    refs = [(2, frames[2]), (3, small[3]), (4, frames[4])]
    pairs = [(t, tt.FlowImage.from_frame(img, 1.0, 3, "cpu"), tframes[t].instances)
             for t, img in refs]
    got = tt.flow_shift_pairs(pairs, tt.FlowImage.from_frame(frames[5], 1.0, 3, "cpu"))
    for (t, img), shifted in zip(refs, got):
        want = jt.FlowCandidateMaker.flow_shift_instances(
            jframes[t].instances, img, frames[5], frame_t=t)
        assert [s.track for s in shifted] == [None] * len(want) and len(want) >= 1
        for g, w in zip(shifted, want):
            np.testing.assert_array_equal(np.isnan(g.points_array), np.isnan(w.points_array))
            np.testing.assert_allclose(np.nan_to_num(g.points_array),
                                       np.nan_to_num(w.points_array), atol=1e-3, rtol=0)


def test_flow_queue_builds_each_pyramid_once(monkeypatch):
    """Every frame with instances becomes one pyramid, reused by the later
    frames of its window."""
    frames, insts = render_stream(seed=2)
    _, tframes = stream_frames(frames, insts)
    built = []
    real = tt.build_pyramid
    monkeypatch.setattr(tt, "build_pyramid", lambda *a: built.append(1) or real(*a))
    tracker = tt.Tracker.make_tracker_by_name(tracker="flow", device="cpu")
    tt.run_tracker(tframes, tracker)
    assert len(built) == N_FRAMES
    assert all(isinstance(item.img_t, tt.FlowImage) for item in tracker.track_matching_queue)


def test_retrack_labels_in_memory():
    frames, insts = render_stream(seed=3)
    _, tframes = stream_frames(frames, insts)
    labels = Labels(labeled_frames=tframes[::-1])
    tt.retrack(labels, tt.Tracker.make_tracker_by_name(tracker="simple"))
    names = [t.name for t in labels.tracks]
    assert names == sorted(names, key=lambda n: int(n.split("_")[1])) and len(names) >= 3
    assert all(inst.track in labels.tracks for lf in labels for inst in lf.instances)


def test_none_tracker_leaves_instances_untracked():
    frames, insts = render_stream(seed=4)
    _, tframes = stream_frames(frames, insts)
    tracker = tt.Tracker.make_tracker_by_name(tracker="none")
    tt.run_tracker(tframes, tracker)
    assert all(inst.track is None for lf in tframes for inst in lf.instances)
    with pytest.raises(ValueError, match="Unknown tracker"):
        tt.Tracker.make_tracker_by_name(tracker="sort")


# --------------------------------------------------------------------------- #
# End to end: load_model(..., tracker="flow")
# --------------------------------------------------------------------------- #


def blob_clip(n, hw, seed, sigma=14.0):
    """uint8 noise frames with two bright blobs moving on straight paths
    that stay apart."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    frames = rng.uniform(0, 30, (n, hw, hw, 1))
    starts = np.array([[0.3, 0.3], [0.7, 0.65]]) * hw
    vel = np.array([[1.0, 0.5], [-0.8, 0.4]]) * hw / 96
    for i in range(n):
        for (cx, cy), (vx, vy) in zip(starts, vel):
            cx, cy = cx + vx * i, cy + vy * i
            frames[i] += 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))[..., None]
    return np.clip(frames, 0, 255).astype(np.uint8)


E2E = {
    "top-down": ([RUNS / "minimal_instance.UNet.centroid",
                  RUNS / "minimal_instance.UNet.centered_instance"], 384, dict(max_instances=2)),
    "bottom-up": ([RUNS / "minimal_instance.UNet.bottomup"], 128, dict(max_instances=2)),
    "single-instance": ([RUNS / "minimal_robot.UNet.single_instance"], 160, {}),
}


@pytest.mark.parametrize("path", list(E2E))
def test_load_model_with_flow_tracker_matches_jax(path):
    folders, hw, kw = E2E[path]
    folders = [str(f) for f in folders]
    frames = blob_clip(8, hw, seed=0, sigma=14.0 * hw / 384 if path != "single-instance" else 10.0)
    common = dict(peak_threshold=0.05, batch_size=4, tracker="flow", **kw)
    want = sleap_tpu.load_model(folders, **common).predict(frames)
    pred = sleap_tpu_torch.load_model(folders, device="cpu", **common)
    assert pred.tracker.candidate_maker.device == pred.device == torch.device("cpu")
    got = pred.predict(frames)
    assert type(got) is Labels
    assert [len(lf.instances) for lf in got] == [len(lf.instances) for lf in want]
    assert sum(len(lf.instances) for lf in got) >= len(frames)
    assert [[i.track.name for i in lf.instances] for lf in got] == [
        [i.track.name for i in lf.instances] for lf in want]
    assert [t.name for t in got.tracks] == [t.name for t in want.tracks]
    assert all(i.track is not None for lf in got for i in lf.instances)
