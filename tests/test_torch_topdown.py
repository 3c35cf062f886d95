"""The port's predictors end to end against the JAX package's, on the same
weights and frames: the trained top-down pair in ``.convergence_runs``, a
shrunken integral-refinement top-down config, and single-instance; and the
shrunken configs in bf16.

Tolerances: points within 0.01 px and values within 1e-4 (f32 convs sum in
another order in each framework; refined points scale that by stride /
input scale); masks and instance counts equal. bf16: the two frameworks
round at other places inside the network, so the test feeds JAX's bf16
maps to the port's post-processing, which must then give the peaks of the
JAX path the TPU runs (the Pallas kernel in interpret mode) exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.config import (
    BackboneConfig,
    CenteredInstanceConfmapsHeadConfig,
    CentroidsHeadConfig,
    DataConfig,
    HeadsConfig,
    InstanceCroppingConfig,
    ModelConfig,
    PreprocessingConfig,
    SingleInstanceConfmapsHeadConfig,
    TrainingJobConfig,
    UNetConfig,
)
from sleap_tpu.inference import predictors as jp
from sleap_tpu.models.model import Model as JaxModel
from sleap_tpu.ops.pallas_peaks import find_global_peaks_integral_pallas
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.models.model import Model
from sleap_tpu_torch.models.params import state_dict_from_flax
from sleap_tpu_torch.ops import peak_finding as tpf

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _highest_precision():
    """Full-f32 matmuls and convs on the JAX side, for this file only."""
    with jax.default_matmul_precision("highest"):
        yield

RUNS = Path(__file__).resolve().parent.parent / ".convergence_runs"
CENTROID = str(RUNS / "minimal_instance.UNet.centroid")
INSTANCE = str(RUNS / "minimal_instance.UNet.centered_instance")
ROBOT = str(RUNS / "minimal_robot.UNet.single_instance")
PT_TOL = 0.01
VAL_TOL = 1e-4


def _frames(n, hw, seed, blobs=2, channels=1):
    """uint8 noise frames with bright planted Gaussian blobs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    frames = rng.uniform(0, 30, (n, hw, hw, channels))
    for i in range(n):
        for _ in range(blobs):
            cy, cx = rng.uniform(hw * 0.2, hw * 0.8, 2)
            frames[i] += 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 10.0**2))[..., None]
    return np.clip(frames, 0, 255).astype(np.uint8)


def _np_params(tm):
    return jax.tree_util.tree_map(np.asarray, tm.variables["params"])


def _merged(examples, keys):
    return {k: np.concatenate([ex[k][: ex["n_valid"]] for ex in examples]) for k in keys}


def _assert_close_nan(a, b, atol):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=atol, rtol=0)


TOPDOWN_KEYS = ("instance_peaks", "instance_peak_vals", "centroids", "centroid_vals", "centroid_mask")


def _assert_topdown_equal(got, want, min_centroids):
    got, want = _merged(got, TOPDOWN_KEYS), _merged(want, TOPDOWN_KEYS)
    np.testing.assert_array_equal(got["centroid_mask"], want["centroid_mask"])
    assert got["centroid_mask"].sum() >= min_centroids
    _assert_close_nan(got["centroids"], want["centroids"], PT_TOL)
    _assert_close_nan(got["instance_peaks"], want["instance_peaks"], PT_TOL)
    np.testing.assert_allclose(got["centroid_vals"], want["centroid_vals"], atol=VAL_TOL)
    np.testing.assert_allclose(got["instance_peak_vals"], want["instance_peak_vals"], atol=VAL_TOL)


# --------------------------------------------------------------------------- #
# The trained top-down pair
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def trained_pair():
    jpred = jp.TopDownPredictor.from_trained_models(
        centroid_model_path=CENTROID, confmap_model_path=INSTANCE,
        peak_threshold=0.05, batch_size=2,
    )
    params = {CENTROID: _np_params(jpred.centroid_model), INSTANCE: _np_params(jpred.confmap_model)}
    tpred = tp.load_model(
        [CENTROID, INSTANCE], device="cpu", params=params, peak_threshold=0.05, batch_size=2
    )
    return jpred, tpred, _frames(2, 384, seed=0)


def test_trained_topdown_outputs_match_jax(trained_pair):
    jpred, tpred, frames = trained_pair
    assert isinstance(tpred, tp.TopDownPredictor)
    _assert_topdown_equal(
        tpred.predict(frames, make_labels=False),
        jpred.predict(frames, make_labels=False),
        min_centroids=1,
    )


def test_trained_topdown_labels_match_jax(trained_pair):
    jpred, tpred, frames = trained_pair
    got, want = tpred.predict(frames), jpred.predict(frames)
    assert type(got) is Labels  # the port's own, not the JAX package's
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    assert [len(lf.instances) for lf in got] == [len(lf.instances) for lf in want]
    assert sum(len(lf.instances) for lf in got) > 0
    for lg, lw in zip(got, want):
        for ig, iw in zip(lg.instances, lw.instances):
            _assert_close_nan(ig.numpy(), iw.numpy(), PT_TOL)
            assert [n.name for n in ig.skeleton.nodes] == [n.name for n in iw.skeleton.nodes]


# --------------------------------------------------------------------------- #
# A shrunken integral-refinement top-down config (s2d 4, 13 nodes, crop 32)
# --------------------------------------------------------------------------- #


def _shrunken_pair(head, input_scaling, seed, bf16=False):
    model_cfg = ModelConfig(
        backbone=BackboneConfig(unet=UNetConfig(
            max_stride=16, output_stride=4, filters=8, filters_rate=2.0,
            up_interpolate=True, space_to_depth=4,
        )),
        heads=head,
    )
    cfg = TrainingJobConfig(
        model=model_cfg,
        data=DataConfig(
            preprocessing=PreprocessingConfig(input_scaling=input_scaling, pad_to_stride=16),
            instance_cropping=InstanceCroppingConfig(crop_size=32),
        ),
    )
    jmodel = JaxModel.from_config(model_cfg)
    module, variables = jmodel.init(jax.random.PRNGKey(seed), (64, 64, 1))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for name in params:  # non-negative heads: maps with peaks above threshold
        if name != "backbone":
            params[name]["kernel"] = np.abs(params[name]["kernel"])
    if bf16:
        module = jmodel.make_flax_module(compute_dtype=jnp.bfloat16)
    jtm = jp.TrainedModel(config=cfg, model=jmodel, module=module,
                          variables={"params": params}, input_channels=1)
    tmod = Model.from_config(model_cfg).make_module(1, torch.bfloat16 if bf16 else torch.float32)
    tmod.load_state_dict(state_dict_from_flax(tmod, params))
    ttm = tp.TrainedModel(
        module=tmod.eval(), input_scale=input_scaling, output_stride=4, pad_to_stride=16,
        part_names=list(getattr(head.which_oneof, "part_names", None) or []), crop_size=32,
    )
    return jtm, ttm


NODES = [f"n{i}" for i in range(13)]
CENTROID_HEAD = HeadsConfig(centroid=CentroidsHeadConfig(output_stride=4))
INSTANCE_HEAD = HeadsConfig(centered_instance=CenteredInstanceConfmapsHeadConfig(
    part_names=NODES, output_stride=4))
SINGLE_HEAD = HeadsConfig(single_instance=SingleInstanceConfmapsHeadConfig(
    part_names=NODES, output_stride=4))


def test_shrunken_integral_topdown_matches_jax():
    jc, tc = _shrunken_pair(CENTROID_HEAD, 0.5, 0)
    ji, ti = _shrunken_pair(INSTANCE_HEAD, 1.0, 1)
    frames = _frames(2, 128, seed=1)
    jpred = jp.TopDownPredictor(centroid_model=jc, confmap_model=ji, max_instances=4, batch_size=2)
    tpred = tp.TopDownPredictor(device=torch.device("cpu"), centroid_model=tc,
                                confmap_model=ti, max_instances=4, batch_size=2)
    _assert_topdown_equal(
        tpred.predict(frames, make_labels=False),
        jpred.predict(frames, make_labels=False),
        min_centroids=4,
    )


def _to_torch_bf16(x):
    bits = np.asarray(x).view(np.uint16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


@pytest.mark.parametrize("head,key", [
    (INSTANCE_HEAD, "CenteredInstanceConfmapsHead"),
    (SINGLE_HEAD, "SingleInstanceConfmapsHead"),
])
def test_bf16_maps_postprocessed_match_pallas(head, key):
    """JAX's bf16 instance (or single-instance) maps, channels-last as the
    bf16 head conv writes them, through the port's global peaks equal the
    Pallas kernel's peaks: values and refined xy exact."""
    jtm, _ = _shrunken_pair(head, 1.0, 2, bf16=True)
    imgs = jnp.asarray(_frames(3, 64, seed=3), jnp.float32) / 255.0
    maps = jtm.module.apply(jtm.variables, imgs, train=False)[key]
    assert maps.dtype == jnp.bfloat16 and maps.shape == (3, 16, 16, 13)
    want_xy, want_v = find_global_peaks_integral_pallas(maps, threshold=0.1, interpret=True)
    got_xy, got_v = tpf.find_global_peaks(_to_torch_bf16(maps), threshold=0.1, refinement="integral")
    found = np.isfinite(got_xy.numpy()).all(axis=-1)
    assert 13 <= found.sum() < found.size  # peaks above and below the threshold
    _assert_close_nan(got_xy.numpy(), np.asarray(want_xy), 0.0)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _assert_same_outputs_form(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], np.ndarray):
                assert (g[k].shape, g[k].dtype) == (w[k].shape, w[k].dtype), k


def test_bf16_topdown_predictor_runs_end_to_end():
    """A bf16 TopDownPredictor (kernels 4, 3, 1 on the card; their plain
    versions here) gives the float32 predictor's outputs in shape and dtype."""
    preds = {}
    for bf16 in (False, True):
        _, tc = _shrunken_pair(CENTROID_HEAD, 0.5, 0, bf16=bf16)
        _, ti = _shrunken_pair(INSTANCE_HEAD, 1.0, 1, bf16=bf16)
        preds[bf16] = tp.TopDownPredictor(device=torch.device("cpu"), centroid_model=tc,
                                          confmap_model=ti, max_instances=4, batch_size=2)
    frames = _frames(2, 128, seed=1)
    got = preds[True].predict(frames, make_labels=False)
    _assert_same_outputs_form(got, preds[False].predict(frames, make_labels=False))
    peaks = _merged(got, ("instance_peaks",))["instance_peaks"]
    assert peaks.dtype == np.float32 and np.isfinite(peaks).any()
    assert type(preds[True].predict(frames)) is Labels


def test_bf16_single_instance_predictor_runs_end_to_end():
    preds = {}
    for bf16 in (False, True):
        _, tm = _shrunken_pair(SINGLE_HEAD, 1.0, 2, bf16=bf16)
        preds[bf16] = tp.SingleInstancePredictor(device=torch.device("cpu"), confmap_model=tm,
                                                 batch_size=2)
    frames = _frames(3, 64, seed=3)
    got = preds[True].predict(frames, make_labels=False)
    _assert_same_outputs_form(got, preds[False].predict(frames, make_labels=False))
    peaks = _merged(got, ("instance_peaks",))["instance_peaks"]
    assert peaks.shape == (3, 13, 2) and np.isfinite(peaks).any()
    assert type(preds[True].predict(frames)) is Labels


# --------------------------------------------------------------------------- #
# Single instance and loading
# --------------------------------------------------------------------------- #


def test_single_instance_matches_jax():
    jpred = jp.SingleInstancePredictor.from_trained_models(ROBOT, batch_size=2, peak_threshold=0.1)
    tpred = tp.load_model(
        ROBOT, device="cpu", params={ROBOT: _np_params(jpred.confmap_model)},
        batch_size=2, peak_threshold=0.1,
    )
    assert isinstance(tpred, tp.SingleInstancePredictor)
    frames = _frames(3, 160, seed=2, blobs=1)
    keys = ("instance_peaks", "instance_peak_vals")
    got = _merged(tpred.predict(frames, make_labels=False), keys)
    want = _merged(jpred.predict(frames, make_labels=False), keys)
    _assert_close_nan(got["instance_peaks"], want["instance_peaks"], PT_TOL)
    np.testing.assert_allclose(got["instance_peak_vals"], want["instance_peak_vals"], atol=VAL_TOL)
    labels = tpred.predict(frames)
    assert [len(lf.instances) for lf in labels] == [
        int(not np.isnan(p).all()) for p in got["instance_peaks"]
    ]


def test_loading_refuses_what_is_not_ported(tmp_path):
    """What still refuses: a folder with no weights at all, and the
    ground-truth-centroid mode of a multiclass top-down folder alone."""
    (tmp_path / "training_config.json").write_text(
        (Path(CENTROID) / "training_config.json").read_text())
    with pytest.raises(FileNotFoundError, match="No weights"):
        tp.load_trained_model(str(tmp_path), "cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        tp.load_model(str(RUNS / "min_tracks_2node.UNet.topdown_multiclass"), device="cpu")
