"""The port's six pipeline builders (``sleap_tpu_torch.data.pipelines``)
against the JAX package's, on the CPU, on a seeded project of 3 frames at
64^2 (two tracked animals a frame):

- ``make_training_pipeline`` with augmentation off: the same batches in the
  same order (the example order comes from ``np.random.default_rng(seed)``
  in both), keys, shapes and ``n_valid`` as JAX's; instances exact, full
  frames within 2^-24 (JAX's jit turns the division by 255 into a product
  by its reciprocal, a float32 ulp below 1 apart), crops and every
  ground-truth map within 1e-5;
- with augmentation on (rotation, translation, scale): keys and shapes as
  without, and the points follow the image: each confidence map peaks on
  its node's blob in the augmented image (the random streams differ from
  JAX's, so values are not compared);
- ``make_base_pipeline`` and ``make_viz_pipeline``: the same frames and
  instances in batches of the optimization batch size and of one;
- ``trainer_cls`` names the same trainer.
"""

import jax
import numpy as np
import pytest
import torch

from sleap_tpu import config as jcfg
from sleap_tpu.core.instance import Instance as JaxInstance
from sleap_tpu.core.instance import LabeledFrame as JaxLabeledFrame
from sleap_tpu.core.instance import Track as JaxTrack
from sleap_tpu.core.labels import Labels as JaxLabels
from sleap_tpu.core.skeleton import Skeleton as JaxSkeleton
from sleap_tpu.data import pipelines as jpipelines
from sleap_tpu.data.providers import LabelsReader as JaxLabelsReader
from sleap_tpu.io.video import Video as JaxVideo
from sleap_tpu_torch import config as cfg
from sleap_tpu_torch.core.instance import Instance, LabeledFrame, Track
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.data import pipelines
from sleap_tpu_torch.data.providers import LabelsReader
from sleap_tpu_torch.io.video import Video

torch.set_num_threads(1)

GT_TOL = 1e-5
IMG_TOL = 2.0**-24
SIZE = 64


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def labels_pair(n_frames=3, seed=0, blobs=False):
    """The same project in both packages: uint8 frames (noise, or dark
    with a bright blob on each node), two animals a frame on tracks A and
    B, three nodes in a chain."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(10, 28, (n_frames, 3, 2)), rng.uniform(36, 54, (n_frames, 3, 2))], axis=1)
    if blobs:
        yy, xx = np.mgrid[0:SIZE, 0:SIZE]
        frames = np.zeros((n_frames, SIZE, SIZE, 1))
        for i in range(n_frames):
            for x, y in pts[i].reshape(-1, 2):
                frames[i, :, :, 0] += 250 * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * 1.5**2))
        frames = np.clip(frames, 0, 255).astype(np.uint8)
    else:
        frames = rng.integers(0, 255, (n_frames, SIZE, SIZE, 1), np.uint8)
    out = []
    for skel_cls, inst_cls, lf_cls, labels_cls, video_cls, track_cls in (
            (Skeleton, Instance, LabeledFrame, Labels, Video, Track),
            (JaxSkeleton, JaxInstance, JaxLabeledFrame, JaxLabels, JaxVideo, JaxTrack)):
        skel = skel_cls.from_names_and_edge_inds(["a", "b", "c"], [(0, 1), (1, 2)], name="S")
        video = video_cls.from_numpy(frames)
        tracks = [track_cls(0, "A"), track_cls(0, "B")]
        out.append(labels_cls([lf_cls(video=video, frame_idx=i,
                                      instances=[inst_cls(skeleton=skel, points=pts[i, j], track=tracks[j])
                                                 for j in range(2)])
                               for i in range(n_frames)]))
    return out, pts


def _builder(package, head, augment=False):
    """The same builder in each package: batch 2, stride-2 heads, crops of
    32 for the top-down ones."""
    c = cfg if package == "torch" else jcfg
    mod = pipelines if package == "torch" else jpipelines
    opt = c.OptimizationConfig()
    opt.batch_size = 2
    if augment:
        aug = opt.augmentation_config
        aug.rotate, aug.rotation_min_angle, aug.rotation_max_angle = True, -30.0, 30.0
        aug.translate, aug.translate_min, aug.translate_max = True, -4, 4
        aug.scale, aug.scale_min, aug.scale_max = True, 0.9, 1.1
    data = c.DataConfig(preprocessing=c.PreprocessingConfig(pad_to_stride=2))
    if head in ("centered_instance", "multi_class_topdown"):
        data.instance_cropping = c.InstanceCroppingConfig(crop_size=32)
    cm = dict(output_stride=2, sigma=2.0)
    heads = {
        "single_instance": lambda: mod.SingleInstanceConfmapsPipeline(
            single_instance_confmap_head=c.SingleInstanceConfmapsHeadConfig(**cm)),
        "centroid": lambda: mod.CentroidConfmapsPipeline(
            centroid_confmap_head=c.CentroidsHeadConfig(anchor_part="b", **cm)),
        "centered_instance": lambda: mod.TopdownConfmapsPipeline(
            instance_confmap_head=c.CenteredInstanceConfmapsHeadConfig(**cm)),
        "multi_instance": lambda: mod.BottomUpPipeline(
            confmaps_head=c.MultiInstanceConfmapsHeadConfig(**cm),
            pafs_head=c.PartAffinityFieldsHeadConfig(output_stride=2, sigma=3.0)),
        "multi_class_bottomup": lambda: mod.BottomUpMultiClassPipeline(
            confmaps_head=c.MultiInstanceConfmapsHeadConfig(**cm),
            class_maps_head=c.ClassMapsHeadConfig(output_stride=2, sigma=3.0)),
        "multi_class_topdown": lambda: mod.TopDownMultiClassPipeline(
            instance_confmap_head=c.CenteredInstanceConfmapsHeadConfig(**cm),
            class_vectors_head=c.ClassVectorsHeadConfig(num_fc_layers=1)),
    }
    builder = heads[head]()
    builder.data_config, builder.optimization_config = data, opt
    if package == "torch":
        builder.device = "cpu"
    return builder


HEADS = ["single_instance", "centroid", "centered_instance", "multi_instance", "multi_class_bottomup",
         "multi_class_topdown"]


@pytest.mark.parametrize("head", HEADS)
def test_training_pipeline_matches_jax(head):
    (labels, jlabels), _ = labels_pair()
    got = list(_builder("torch", head).make_training_pipeline(labels))
    want = list(_builder("jax", head).make_training_pipeline(JaxLabelsReader(labels=jlabels)))
    assert [n for _, n in got] == [n for _, n in want]
    assert sum(n for _, n in got) == (6 if head in ("centered_instance", "multi_class_topdown") else 3)
    for (g, _), (w, _) in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape, k
        crops = head in ("centered_instance", "multi_class_topdown")
        np.testing.assert_allclose(g["image"], w["image"], rtol=0, atol=GT_TOL if crops else IMG_TOL)
        np.testing.assert_array_equal(g["instances"], w["instances"])
        for k in set(w) - {"image", "instances"}:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=GT_TOL, err_msg=k)
            assert np.abs(w[k]).max() > 0.1, k  # the maps hold something


def _blob_at(img, x, y):
    """The image's value at the nearest pixel to (x, y)."""
    yi = int(np.clip(round(y), 0, img.shape[0] - 1))
    xi = int(np.clip(round(x), 0, img.shape[1] - 1))
    return img[yi, xi, 0]


@pytest.mark.parametrize("head", ["single_instance", "multi_instance", "centered_instance"])
def test_augmented_points_follow_the_image(head):
    (labels, _), _ = labels_pair(n_frames=4, seed=1, blobs=True)
    plain = list(_builder("torch", head).make_training_pipeline(labels))
    augmented = list(_builder("torch", head, augment=True).make_training_pipeline(labels))
    assert [n for _, n in plain] == [n for _, n in augmented]
    key = {"single_instance": "SingleInstanceConfmapsHead", "multi_instance": "MultiInstanceConfmapsHead",
           "centered_instance": "CenteredInstanceConfmapsHead"}[head]
    moved = False
    for (p, _), (a, _) in zip(plain, augmented):
        assert sorted(p) == sorted(a) and all(p[k].shape == a[k].shape for k in p)
        moved |= not np.array_equal(p["image"], a["image"])
        for img, cms in zip(a["image"], a[key]):
            for c in range(cms.shape[-1]):
                if cms[..., c].max() < 0.5:  # a node carried out of the frame
                    continue
                y, x = np.unravel_index(np.argmax(cms[..., c]), cms.shape[:2])
                # The map's peak (stride 2) sits on a bright blob of the image.
                assert _blob_at(img, 2 * x + 0.5, 2 * y + 0.5) > 0.3, (head, c)
    assert moved


@pytest.mark.parametrize("which", ["base", "viz"])
def test_base_and_viz_pipelines_match_jax(which):
    (labels, jlabels), _ = labels_pair()
    port = getattr(_builder("torch", "single_instance"), f"make_{which}_pipeline")(LabelsReader(labels=labels))
    ref = getattr(_builder("jax", "single_instance"), f"make_{which}_pipeline")(JaxLabelsReader(labels=jlabels))
    got, want = list(port), list(ref)
    assert [n for _, n in got] == [n for _, n in want] == ([2, 1] if which == "base" else [1, 1, 1])
    for (g, _), (w, _) in zip(got, want):
        for k in ("image", "frame_ind", "video_ind"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("head", HEADS)
def test_trainer_cls_matches_jax(head):
    assert _builder("torch", head).trainer_cls.__name__ == _builder("jax", head).trainer_cls.__name__


def test_training_pipelines_need_labels_and_run_on_the_card_by_default():
    with pytest.raises(ValueError, match="labeled data"):
        _builder("torch", "centroid").make_training_pipeline([{"image": np.zeros((4, 4, 1))}])
    assert pipelines.Pipeline(provider=None).device == torch.device("cuda")
    assert pipelines.CentroidConfmapsPipeline().device == torch.device("cuda")
