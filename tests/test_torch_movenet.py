"""The port's MoveNet predictor (``sleap_tpu_torch.inference.movenet``)
against the JAX package's, on the CPU, with the same injected model: a
callable with MoveNet's contract whose output is an exact function of the
int32 image it is given, so equal points mean equal preprocessing (the
port resizes with ``resize_linear_uint8``, JAX with ``cv2.resize``). Both
predictors see bitwise equal inputs and give exactly equal points, scores
and NaNs, on frames that need no resize (the coordinate round trip), a
scaled RGB video, odd sizes and gray frames. Also: the offline
``NotImplementedError`` of ``from_trained_models`` and of
``load_model("movenet-...")``, the skeleton, and a SavedModel round trip
through both packages (skipped where tensorflow is absent).
"""

import importlib.util

import numpy as np
import pytest

from sleap_tpu.data.providers import VideoReader as JaxVideoReader
from sleap_tpu.inference import movenet as jmovenet
from sleap_tpu.inference.predictors import load_model as jax_load_model
from sleap_tpu.io.video import Video as JaxVideo
from sleap_tpu_torch.data.providers import VideoReader
from sleap_tpu_torch.inference import movenet
from sleap_tpu_torch.inference.predictors import load_model
from sleap_tpu_torch.io.video import Video


class ContentModel:
    """MoveNet's contract: int32 (1, S, S, 3) in, (1, 1, 17, 3) normalized
    [y, x, score] out, each an exact function of the pixels; records what it
    was given."""

    def __init__(self, size):
        self.size = size
        self.seen = []

    def __call__(self, images):
        assert images.shape == (1, self.size, self.size, 3) and images.dtype == np.int32
        self.seen.append(images.copy())
        img = images[0].astype(np.int64)
        rows = []
        for k in range(17):
            y = (int((img[..., k % 3] * (k + 1)).sum()) % 997) / 997.0
            x = (int(img[(k * 7) % self.size].sum()) % 991) / 991.0
            score = (int(img[:, (k * 11) % self.size].sum()) % 100) / 100.0
            rows.append([y, x, score])
        return np.asarray(rows, np.float32).reshape(1, 1, 17, 3)


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, shape, np.uint8)


def _predict_both(frames, name="lightning", threshold=0.2):
    size = movenet.MOVENET_MODELS[name]["image_size"]
    port_model, jax_model = ContentModel(size), ContentModel(size)
    pred = movenet.MoveNetPredictor.from_trained_models(name, model_path=port_model, peak_threshold=threshold,
                                                        device="cpu")
    jpred = jmovenet.MoveNetPredictor.from_trained_models(name, model_path=jax_model, peak_threshold=threshold)
    got = pred.predict(VideoReader(video=Video.from_numpy(frames)))
    want = jpred.predict(JaxVideoReader(video=JaxVideo.from_numpy(frames)))
    assert len(port_model.seen) == len(jax_model.seen) == len(frames)
    for a, b in zip(port_model.seen, jax_model.seen):
        np.testing.assert_array_equal(a, b)
    return got, want


def _assert_labels_equal(got, want):
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    n_instances = 0
    for g, w in zip(got, want):
        assert len(g.instances) == len(w.instances)
        for gi, wi in zip(g.instances, w.instances):
            np.testing.assert_array_equal(gi.numpy(), wi.numpy())
            np.testing.assert_array_equal(gi.scores, wi.scores)
            assert gi.score == wi.score
            assert gi.skeleton.node_names == wi.skeleton.node_names == movenet.COCO_17_NODES
            n_instances += 1
    return n_instances


@pytest.mark.parametrize("shape,name", [
    ((3, 96, 192, 1), "lightning"),   # no resize: scale 1, the coordinate round trip
    ((2, 384, 384, 3), "lightning"),  # scale 0.5
    ((2, 100, 150, 3), "thunder"),    # odd sizes, upscaled
    ((2, 480, 640, 1), "thunder"),    # gray, downscaled
])
def test_predictions_match_jax(shape, name):
    got, want = _predict_both(_frames(shape, seed=sum(shape)), name)
    n = _assert_labels_equal(got, want)
    assert n == shape[0]
    pts = np.array([lf.instances[0].numpy() for lf in got])
    assert np.isnan(pts).any() and np.isfinite(pts).any()  # some scores under the threshold


def test_numpy_frames_match_a_video():
    frames = _frames((3, 120, 160, 3), seed=3)
    pred = movenet.MoveNetPredictor.from_trained_models("lightning", model_path=ContentModel(192), device="cpu")
    from_array = pred.predict(frames)
    from_video = pred.predict(VideoReader(video=Video.from_numpy(frames)))
    assert _assert_labels_equal(from_array, from_video) == 3


def test_points_map_back_to_the_frame():
    """The JAX package's own fixed-output cases: normalized 0.25 in a
    192-pixel canvas is 48 px at scale 1; 0.5 at scale 0.5 is 192 px."""
    def fixed(xy, scores):
        raw = np.concatenate([xy[:, ::-1], scores[:, None]], axis=1)
        return lambda images: raw.reshape(1, 1, 17, 3).astype(np.float32)

    scores = np.full(17, 0.9)
    scores[5] = 0.05
    pred = movenet.MoveNetPredictor.from_trained_models(
        "lightning", model_path=fixed(np.full((17, 2), 0.25), scores), device="cpu")
    pts = pred.predict(np.zeros((2, 96, 192, 1), np.uint8))[0].instances[0].numpy()
    np.testing.assert_array_equal(pts[0], [48.0, 48.0])
    assert np.isnan(pts[5]).all()
    pred = movenet.MoveNetPredictor.from_trained_models(
        "lightning", model_path=fixed(np.full((17, 2), 0.5), np.ones(17)), device="cpu")
    pts = pred.predict(np.zeros((1, 384, 384, 3), np.uint8))[0].instances[0].numpy()
    np.testing.assert_array_equal(pts, np.full((17, 2), 192.0))


def test_offline_errors_match_jax():
    with pytest.raises(NotImplementedError) as got:
        movenet.MoveNetPredictor.from_trained_models("thunder")
    with pytest.raises(NotImplementedError) as want:
        jmovenet.MoveNetPredictor.from_trained_models("thunder")
    assert str(got.value) == str(want.value) and "offline" in str(got.value)
    for name in ("movenet-thunder", "movenet-lightning"):
        with pytest.raises(NotImplementedError) as got:
            load_model(name, device="cpu")
        with pytest.raises(NotImplementedError) as want:
            jax_load_model(name)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Unknown MoveNet"):
        movenet.MoveNetPredictor.from_trained_models("blazing", model_path=ContentModel(192))


def test_load_model_routes_movenet_with_a_local_model(monkeypatch):
    seen = {}
    monkeypatch.setattr(movenet, "load_local_movenet", lambda path: seen.setdefault(path, ContentModel(256)))
    pred = load_model("movenet-thunder:/models/movenet", device="cpu", peak_threshold=0.3)
    assert type(pred) is movenet.MoveNetPredictor and list(seen) == ["/models/movenet"]
    assert pred.model_name == "thunder" and pred.image_size == 256 and pred.peak_threshold == 0.3
    assert pred.batch_size == 1 and not pred.is_grayscale and str(pred.device) == "cpu"


def test_skeleton_matches_jax():
    skel, jskel = movenet.movenet_skeleton(), jmovenet.movenet_skeleton()
    assert skel.node_names == jskel.node_names == jmovenet.COCO_17_NODES
    assert skel.edge_inds == jskel.edge_inds and len(skel.edges) == 18
    assert movenet.COCO_17_EDGES == jmovenet.COCO_17_EDGES and movenet.MOVENET_MODELS == jmovenet.MOVENET_MODELS


@pytest.mark.skipif(importlib.util.find_spec("tensorflow") is None, reason="tensorflow is not installed")
def test_saved_model_round_trip_matches_jax(tmp_path):
    """A tiny ``tf.Module`` with MoveNet's ``serving_default`` signature,
    saved and loaded through both packages' ``load_local_movenet``."""
    import tensorflow as tf

    class Tiny(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec([1, 192, 192, 3], tf.int32)])
        def serve(self, images):
            f = tf.cast(images, tf.float32)
            rows = tf.reduce_mean(f, axis=[2, 3])[0, :17] / 255.0
            cols = tf.reduce_mean(f, axis=[1, 3])[0, :17] / 255.0
            score = tf.reduce_max(f, axis=[1, 2])[0, 0] / 255.0 * tf.ones([17])
            return {"output_0": tf.reshape(tf.stack([rows, cols, score], axis=-1), [1, 1, 17, 3])}

    module = Tiny()
    path = str(tmp_path / "movenet")
    tf.saved_model.save(module, path, signatures={"serving_default": module.serve})
    frames = _frames((2, 150, 200, 3), seed=9)
    got = movenet.MoveNetPredictor.from_trained_models("lightning", model_path=path, device="cpu").predict(
        VideoReader(video=Video.from_numpy(frames)))
    want = jmovenet.MoveNetPredictor.from_trained_models("lightning", model_path=path).predict(
        JaxVideoReader(video=JaxVideo.from_numpy(frames)))
    assert _assert_labels_equal(got, want) == 2
