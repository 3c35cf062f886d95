"""Multiclass (supervised identity) inference: the port against the JAX
package on the CPU.

- ``ops/identity.py`` against ``sleap_tpu.ops.identity`` on crafted cases;
- both predictors at small widths (filters 8, 2-3 nodes, 2-3 classes,
  seeded params), with and without an offset head;
- the trained ``min_tracks_2node`` folder with the ``minimal_instance``
  centroid folder, the port reading both checkpoints itself;
- bf16 maps and class vectors from the JAX bf16 network through the port's
  post-processing (the kernels' plain versions here).

Tolerances: points within 0.01 px and values within 1e-4 (f32 convs sum in
another order in each framework), class probabilities within 1e-5; masks,
assignments and track names equal. Identity ops on equal inputs: exact.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.config import (
    BackboneConfig,
    CentroidsHeadConfig,
    CenteredInstanceConfmapsHeadConfig,
    ClassMapsHeadConfig,
    ClassVectorsHeadConfig,
    DataConfig,
    HeadsConfig,
    InstanceCroppingConfig,
    ModelConfig,
    MultiClassBottomUpConfig,
    MultiClassTopDownConfig,
    MultiInstanceConfmapsHeadConfig,
    PreprocessingConfig,
    TrainingJobConfig,
    UNetConfig,
)
from sleap_tpu.inference import multiclass as jm
from sleap_tpu.inference import predictors as jp
from sleap_tpu.models.model import Model as JaxModel
from sleap_tpu.ops import identity as ji
from sleap_tpu.ops import peak_finding as jpf
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.inference import multiclass as tm
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.models.model import Model
from sleap_tpu_torch.models.params import state_dict_from_flax
from sleap_tpu_torch.ops import identity as ti
from sleap_tpu_torch.ops import peak_finding as tpf

torch.set_num_threads(1)

RUNS = Path(__file__).resolve().parent.parent / ".convergence_runs"
CENTROID = str(RUNS / "minimal_instance.UNet.centroid")
MULTICLASS = str(RUNS / "min_tracks_2node.UNet.topdown_multiclass")
PT_TOL = 0.01
VAL_TOL = 1e-4
PROB_TOL = 1e-5
KEYS = ("points", "point_vals", "class_probs")


@pytest.fixture(autouse=True)
def _highest_precision():
    """Full-f32 matmuls and convs on the JAX side, for this file only."""
    with jax.default_matmul_precision("highest"):
        yield


def _frames(n, hw, seed, blobs=3, sigma=8.0):
    """uint8 noise frames with bright planted Gaussian blobs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    frames = rng.uniform(0, 30, (n, hw, hw, 1))
    for i in range(n):
        for _ in range(blobs):
            cy, cx = rng.uniform(hw * 0.2, hw * 0.8, 2)
            frames[i] += 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))[..., None]
    return np.clip(frames, 0, 255).astype(np.uint8)


def _merged(examples):
    return {k: np.concatenate([ex[k][: ex["n_valid"]] for ex in examples]).astype(np.float32)
            for k in KEYS}


def _assert_close_nan(a, b, atol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=atol, rtol=0)


def _assert_outputs_match(got, want, min_points):
    got, want = _merged(got), _merged(want)
    _assert_close_nan(got["points"], want["points"], PT_TOL)
    _assert_close_nan(got["point_vals"], want["point_vals"], VAL_TOL)
    _assert_close_nan(got["class_probs"], want["class_probs"], PROB_TOL)
    assert np.isfinite(got["points"][..., 0]).sum() >= min_points


def _assert_labels_match(got, want, classes):
    assert type(got) is Labels
    assert [t.name for t in got.tracks] == list(classes)
    assert [len(lf.instances) for lf in got] == [len(lf.instances) for lf in want]
    n = 0
    for lg, lw in zip(got, want):
        for ig, iw in zip(lg.instances, lw.instances):
            assert ig.track is got.tracks[list(classes).index(iw.track.name)]
            _assert_close_nan(ig.numpy(), iw.numpy(), PT_TOL)
            np.testing.assert_allclose(ig.score, iw.score, atol=VAL_TOL)
            np.testing.assert_allclose(ig.tracking_score, iw.tracking_score, atol=PROB_TOL)
            n += 1
    assert n > 0


# --------------------------------------------------------------------------- #
# Identity ops on crafted cases
# --------------------------------------------------------------------------- #


def _vector_case(name):
    """(peaks (S, K, C, 2), vals (S, K, C), class probs (S, K, n), mask (S, K))."""
    rng = np.random.RandomState(0)
    S, K, C, n = 2, 3, 2, 3
    probs = rng.dirichlet(np.ones(n), (S, K)).astype(np.float32)
    mask = np.ones((S, K), bool)
    if name == "equal_probs":
        probs[:] = 1.0 / n
    elif name == "nan_probs":
        probs[0, 1, 2] = np.nan
        probs[1, :, 0] = np.nan
    elif name == "fewer_peaks_than_classes":
        K = 2
        probs = probs[:, :K]
        mask = mask[:, :K]
    elif name == "masked_peaks":
        mask[0, 0] = mask[1, 2] = False
    elif name == "argmax_not_assigned":
        # Both crops prefer class 0; the assignment gives one of them another
        # class, which is not its most probable one, so it is dropped.
        probs = np.array([[[0.7, 0.2, 0.1], [0.6, 0.3, 0.1], [0.5, 0.1, 0.4]]] * S, np.float32)
    peaks = rng.uniform(0, 50, (S, K, C, 2)).astype(np.float32)
    vals = rng.uniform(0.2, 1, (S, K, C)).astype(np.float32)
    return peaks, vals, probs, mask


CASES = ["equal_probs", "nan_probs", "fewer_peaks_than_classes", "masked_peaks",
         "argmax_not_assigned"]


@pytest.mark.parametrize("case", CASES)
def test_classify_peaks_from_vectors_matches_jax(case):
    peaks, vals, probs, mask = _vector_case(case)
    want = ji.classify_peaks_from_vectors(*map(jnp.asarray, (peaks, vals, probs, mask)))
    got = ti.classify_peaks_from_vectors(*map(torch.from_numpy, (peaks, vals, probs, mask)))
    for g, w in zip(got, want):
        _assert_close_nan(g.numpy(), np.asarray(w), 0.0)
    if case == "argmax_not_assigned":
        assert np.isnan(got[0][:, 1:].numpy()).all()  # only class 0 kept
        assert np.isfinite(got[0][:, 0].numpy()).all()


@pytest.mark.parametrize("case", CASES)
def test_classify_peaks_from_maps_matches_jax(case):
    """The class maps at the peaks (stride 4, half-way points rounding to
    even) carry the crafted probabilities of :func:`_vector_case`."""
    peaks_v, vals_v, probs, mask = _vector_case(case)
    S, K, n = probs.shape
    C, Hs, Ws, stride = 2, 6, 7, 4
    class_maps = np.random.RandomState(1).uniform(0, 0.05, (S, Hs, Ws, n)).astype(np.float32)
    peaks = np.full((S, C, K, 2), np.nan, np.float32)
    for s in range(S):
        for c in range(C):
            for k in range(K):
                y, x = (k + 2 * c) % Hs, (3 * k + c) % Ws
                class_maps[s, y, x] = probs[s, k]
                peaks[s, c, k] = (x * stride + (2.0 if k == 1 else 0.3), y * stride - 0.4)
    mask_m = np.broadcast_to(mask[:, None], (S, C, K)).copy()
    peaks[~mask_m] = np.nan
    vals = np.where(mask_m, np.transpose(vals_v, (0, 2, 1)), 0).astype(np.float32)
    args = (class_maps, peaks, vals, mask_m)
    want = ji.classify_peaks_from_maps(*map(jnp.asarray, args), class_maps_stride=stride)
    got = ti.classify_peaks_from_maps(*map(torch.from_numpy, args), class_maps_stride=stride)
    for g, w in zip(got, want):
        _assert_close_nan(g.numpy(), np.asarray(w), 0.0)
    assert got[0].shape == (S, n, C, 2)


# --------------------------------------------------------------------------- #
# Seeded small models
# --------------------------------------------------------------------------- #

NODES = ["head", "thorax", "tail"]
CLASSES = ["female", "male", "pup"]
UNET = dict(max_stride=16, output_stride=4, filters=8, filters_rate=2.0, up_interpolate=True)


def _pair(heads, seed, crop_size=None, input_scaling=1.0, bf16=False):
    """The same seeded model as a JAX ``TrainedModel`` and the port's."""
    model_cfg = ModelConfig(backbone=BackboneConfig(unet=UNetConfig(**UNET)), heads=heads)
    cfg = TrainingJobConfig(
        model=model_cfg,
        data=DataConfig(
            preprocessing=PreprocessingConfig(input_scaling=input_scaling, pad_to_stride=16),
            instance_cropping=InstanceCroppingConfig(crop_size=crop_size),
        ),
    )
    jmodel = JaxModel.from_config(model_cfg)
    hw = crop_size or 64
    module, variables = jmodel.init(jax.random.PRNGKey(seed), (hw, hw, 1))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for name in params:  # larger, non-negative confmaps: peaks above threshold
        if "Confmaps" in name:
            params[name]["kernel"] = np.abs(params[name]["kernel"]) * 20
        elif name == "ClassMapsHead":  # class maps far from 0.5
            params[name]["kernel"] = params[name]["kernel"] * 500
    if bf16:
        module = jmodel.make_flax_module(compute_dtype=jnp.bfloat16)
    jtm = jp.TrainedModel(config=cfg, model=jmodel, module=module,
                          variables={"params": params}, input_channels=1)
    model = Model.from_config(model_cfg)
    tmod = model.make_module(1, torch.bfloat16 if bf16 else torch.float32,
                             (crop_size, crop_size) if crop_size else None)
    tmod.load_state_dict(state_dict_from_flax(tmod, params))
    head = heads.which_oneof
    ttm = tp.TrainedModel(
        module=tmod.eval(), input_scale=input_scaling,
        output_stride=getattr(head, "confmaps", head).output_stride, pad_to_stride=16,
        part_names=list(model.part_names), crop_size=crop_size, classes=list(model.classes),
        class_maps_stride=getattr(getattr(head, "class_maps", None), "output_stride", None),
    )
    return jtm, ttm


def _bottomup_heads(offsets, n_classes=3, class_stride=8):
    return HeadsConfig(multi_class_bottomup=MultiClassBottomUpConfig(
        confmaps=MultiInstanceConfmapsHeadConfig(
            part_names=NODES[:2], output_stride=4, offset_refinement=offsets),
        class_maps=ClassMapsHeadConfig(classes=CLASSES[:n_classes], output_stride=class_stride),
    ))


def _topdown_heads(offsets, global_pool=True):
    return HeadsConfig(multi_class_topdown=MultiClassTopDownConfig(
        confmaps=CenteredInstanceConfmapsHeadConfig(
            part_names=NODES, anchor_part="thorax", output_stride=4, offset_refinement=offsets),
        class_vectors=ClassVectorsHeadConfig(
            classes=CLASSES[:2], num_fc_layers=2, num_fc_units=16, global_pool=global_pool,
            output_stride=16),
    ))


@pytest.mark.parametrize("family", ["bottomup", "topdown"])
def test_multiclass_config_without_classes_raises(family):
    heads = _bottomup_heads(False) if family == "bottomup" else _topdown_heads(False)
    hc = heads.which_oneof
    (hc.class_maps if family == "bottomup" else hc.class_vectors).classes = None
    cfg = ModelConfig(backbone=BackboneConfig(unet=UNetConfig(**UNET)), heads=heads)
    with pytest.raises(ValueError, match="names no classes"):
        Model.from_config(cfg)


@pytest.mark.parametrize("offsets", [False, True])
def test_bottomup_multiclass_matches_jax(offsets):
    jtm, ttm = _pair(_bottomup_heads(offsets), seed=3, input_scaling=0.5)
    jpred = jm.BottomUpMultiClassPredictor(model=jtm, batch_size=2)
    tpred = tm.BottomUpMultiClassPredictor(device=torch.device("cpu"), model=ttm, batch_size=2)
    frames = _frames(3, 128, seed=4)
    _assert_outputs_match(tpred.predict(frames, make_labels=False),
                          jpred.predict(frames, make_labels=False), min_points=3)
    _assert_labels_match(tpred.predict(frames), jpred.predict(frames), CLASSES)


@pytest.mark.parametrize("offsets,global_pool", [(False, True), (True, True), (False, False)])
def test_topdown_multiclass_matches_jax(offsets, global_pool):
    jc, tc = _pair(HeadsConfig(centroid=CentroidsHeadConfig(output_stride=4)), seed=0,
                   input_scaling=0.5)
    ji_, ti_ = _pair(_topdown_heads(offsets, global_pool), seed=5, crop_size=32)
    jpred = jm.TopDownMultiClassPredictor(centroid_model=jc, confmap_model=ji_, batch_size=2,
                                          max_instances=3)
    tpred = tm.TopDownMultiClassPredictor(device=torch.device("cpu"), centroid_model=tc,
                                          confmap_model=ti_, batch_size=2, max_instances=3)
    frames = _frames(3, 128, seed=1)
    _assert_outputs_match(tpred.predict(frames, make_labels=False),
                          jpred.predict(frames, make_labels=False), min_points=3)
    _assert_labels_match(tpred.predict(frames), jpred.predict(frames), CLASSES[:2])


def test_topdown_multiclass_crops_default_to_the_class_count():
    _, tc = _pair(HeadsConfig(centroid=CentroidsHeadConfig(output_stride=4)), seed=0)
    _, ti_ = _pair(_topdown_heads(False), seed=5, crop_size=32)
    pred = tm.TopDownMultiClassPredictor(device=torch.device("cpu"), centroid_model=tc,
                                         confmap_model=ti_)
    assert pred._max_peaks == 2
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        tm.TopDownMultiClassPredictor(device=torch.device("cpu"), centroid_model=None,
                                      confmap_model=ti_)


# --------------------------------------------------------------------------- #
# The trained multiclass folder, read from its checkpoint
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def trained_multiclass():
    jpred = jm.TopDownMultiClassPredictor.from_trained_models(
        centroid_model_path=CENTROID, confmap_model_path=MULTICLASS,
        peak_threshold=0.05, batch_size=2,
    )
    tpred = tp.load_model([CENTROID, MULTICLASS], device="cpu", peak_threshold=0.05,
                          batch_size=2)
    return jpred, tpred, _frames(3, 384, seed=0, blobs=2, sigma=10.0)


def test_trained_multiclass_folder_matches_jax(trained_multiclass):
    jpred, tpred, frames = trained_multiclass
    assert isinstance(tpred, tm.TopDownMultiClassPredictor)
    assert tpred.confmap_model.classes == ["female", "male"]
    with jax.default_matmul_precision("highest"):
        want = jpred.predict(frames, make_labels=False)
    _assert_outputs_match(tpred.predict(frames, make_labels=False), want, min_points=2)


def test_trained_multiclass_labels_match_jax(trained_multiclass):
    jpred, tpred, frames = trained_multiclass
    got, want = tpred.predict(frames), jpred.predict(frames)
    _assert_labels_match(got, want, ["female", "male"])
    assert [lf.frame_idx for lf in got] == [0, 1, 2]


# --------------------------------------------------------------------------- #
# bf16: JAX's bf16 network outputs through the port's post-processing
# --------------------------------------------------------------------------- #


def _to_torch_bf16(x):
    bits = np.asarray(x).view(np.uint16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def test_bf16_class_maps_postprocessed_match_jax():
    """bf16 confmaps and class maps, channels-last as the bf16 head convs
    write them: the port's local peaks (kernel 4's plain version) and class
    assignment give JAX's grid peaks, values and probabilities exactly."""
    jtm, _ = _pair(_bottomup_heads(False, class_stride=4), seed=6, bf16=True)
    imgs = jnp.asarray(_frames(2, 64, seed=7), jnp.float32) / 255.0
    out = jtm.module.apply(jtm.variables, imgs, train=False)
    cms, cls = out["MultiInstanceConfmapsHead"], out["ClassMapsHead"]
    assert cms.dtype == cls.dtype == jnp.bfloat16
    jpk, jpv, jmask = jpf.find_local_peaks(cms, max_peaks=8, threshold=0.2)
    want = ji.classify_peaks_from_maps(cls, jpk * 4.0, jpv, jmask, class_maps_stride=4)
    tcms = _to_torch_bf16(cms)
    tpk, tpv, tmask = tpf.find_local_peaks(tcms, max_peaks=8, threshold=0.2)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask.sum() >= 2
    got = ti.classify_peaks_from_maps(_to_torch_bf16(cls), tpk * 4.0, tpv, tmask,
                                      class_maps_stride=4)
    for g, w in zip(got, want):
        _assert_close_nan(g.float().numpy(), np.asarray(w, np.float32), 0.0)


def test_bf16_class_vectors_postprocessed_match_jax():
    """The bf16 dense head's class vectors through the port's assignment."""
    jtm, ttm = _pair(_topdown_heads(False), seed=8, crop_size=32, bf16=True)
    crops = jnp.asarray(_frames(6, 32, seed=9, blobs=1), jnp.float32) / 255.0
    vecs = jtm.module.apply(jtm.variables, crops, train=False)["ClassVectorsHead"]
    assert vecs.dtype == jnp.bfloat16 and vecs.shape == (6, 2)
    rng = np.random.RandomState(10)
    peaks = rng.uniform(0, 32, (2, 3, 3, 2)).astype(np.float32)
    vals = rng.uniform(0, 1, (2, 3, 3)).astype(np.float32)
    mask = np.array([[True, True, False], [True, True, True]])
    want = ji.classify_peaks_from_vectors(jnp.asarray(peaks), jnp.asarray(vals),
                                          vecs.reshape(2, 3, 2), jnp.asarray(mask))
    got = ti.classify_peaks_from_vectors(torch.from_numpy(peaks), torch.from_numpy(vals),
                                         _to_torch_bf16(vecs).reshape(2, 3, 2),
                                         torch.from_numpy(mask))
    for g, w in zip(got, want):
        _assert_close_nan(g.float().numpy(), np.asarray(w, np.float32), 0.0)
    # The port's own bf16 module gives class vectors of the same form.
    with torch.no_grad():
        tvecs = ttm.module(torch.from_numpy(np.asarray(crops)))["ClassVectorsHead"]
    assert tvecs.dtype == torch.bfloat16 and tuple(tvecs.shape) == (6, 2)
    np.testing.assert_allclose(tvecs.float().sum(-1).numpy(), 1.0, atol=1e-2)
