"""Run folders of the other backbones, end to end: a JAX-written orbax
checkpoint holding ``params`` and ``batch_stats`` is predicted by the JAX
package's predictor and by the port's ``load_model(..., device="cpu")``,
which reads the checkpoint with its own reader.

- top-down: the trained centroid UNet in ``.convergence_runs`` paired with a
  centered-instance folder on a small pretrained-encoder UNet (resnet18,
  ``decoder_filters`` 16, RGB, ImageNet "caffe" preprocessing);
- single-instance: small Hourglass (2 stacks), HRNet (C 4) and LEAP folders.

Weights are seeded (:func:`test_torch_backbones.seeded_variables`: batch-norm
statistics far from 0 and 1). Points agree within 0.05 px and scores within
1e-3; the masks and the NaN patterns (peaks below threshold) agree exactly.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu import config as jc
from sleap_tpu.inference import predictors as jp
from sleap_tpu.models.model import Model as JaxModel
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.io.orbax import read_variables
from test_torch_backbones import seeded_variables

torch.set_num_threads(2)
RUNS = Path(__file__).resolve().parent.parent / ".convergence_runs"
CENTROID = str(RUNS / "minimal_instance.UNet.centroid")
PT_TOL = 0.05
VAL_TOL = 1e-3


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _frames(n, hw, seed):
    """uint8 noise frames with two bright Gaussian blobs each."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    frames = rng.uniform(0, 30, (n, hw, hw, 1))
    for i in range(n):
        for _ in range(2):
            cy, cx = rng.uniform(hw * 0.2, hw * 0.8, 2)
            frames[i] += 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 10.0**2))[..., None]
    return np.clip(frames, 0, 255).astype(np.uint8)


def write_run_folder(path, backbone, heads, preprocessing=None, crop_size=None, seed=0):
    """A run folder as the JAX trainer leaves it: ``training_config.json``
    and ``best_model.ckpt`` (orbax) of seeded variables. Returns them."""
    import orbax.checkpoint as ocp

    pp = preprocessing or jc.PreprocessingConfig()
    cfg = jc.TrainingJobConfig(
        data=jc.DataConfig(preprocessing=pp,
                           instance_cropping=jc.InstanceCroppingConfig(crop_size=crop_size)),
        model=jc.ModelConfig(backbone=jc.BackboneConfig(**backbone), heads=heads),
    )
    os.makedirs(path, exist_ok=True)
    cfg.save_json(os.path.join(path, "training_config.json"))
    model = JaxModel.from_config(cfg.model)
    hw = max(4 * model.maximum_stride, 32)
    c = 3 if pp.ensure_rgb else 1
    module = model.make_flax_module()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, c)), train=False))
    variables = seeded_variables(shapes, seed)
    for name, layer in variables["params"].items():  # non-negative heads: peaks above threshold
        if name not in ("backbone", "backbone_module"):
            layer["kernel"] = np.abs(layer["kernel"])
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(os.path.join(path, "best_model.ckpt")),
               jax.tree_util.tree_map(jnp.asarray, variables), force=True)
    ckptr.wait_until_finished()
    return variables


def jax_trained_model(folder, variables):
    """The JAX package's ``TrainedModel`` of a folder written by
    :func:`write_run_folder`, on the variables it wrote (what its loader
    restores, without the loader's flax init, which runs op by op)."""
    cfg = jc.TrainingJobConfig.load_json(folder)
    model = JaxModel.from_config(cfg.model)
    return jp.TrainedModel(config=cfg, model=model, module=model.make_flax_module(),
                           variables=jax.tree_util.tree_map(jnp.asarray, variables),
                           input_channels=3 if cfg.data.preprocessing.ensure_rgb else 1)


def _merged(examples, keys):
    return {k: np.concatenate([ex[k][: ex["n_valid"]] for ex in examples]) for k in keys}


def _assert_close_nan(a, b, atol):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=atol, rtol=0)


def _assert_outputs_match(got, want, keys, point_keys):
    got, want = _merged(got, keys), _merged(want, keys)
    for k in keys:
        tol = PT_TOL if k in point_keys else VAL_TOL
        if got[k].dtype == bool:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            _assert_close_nan(got[k], want[k], tol)
    return got


NODES = ["a", "b", "c"]


def _single(stride):
    return jc.HeadsConfig(single_instance=jc.SingleInstanceConfmapsHeadConfig(
        part_names=NODES, output_stride=stride))


SINGLE_FOLDERS = {
    "hourglass": ({"hourglass": jc.HourglassConfig(stem_stride=4, max_stride=32, output_stride=4,
                                                   stem_filters=8, filters=8, filter_increase=4,
                                                   stacks=2)}, _single(4)),
    "hrnet": ({"hrnet": jc.HRNetConfig(C=4, stem_filters=8, deconv_filters=8)}, _single(2)),
    "leap": ({"leap": jc.LEAPConfig(max_stride=8, output_stride=2, filters=8)}, _single(2)),
}


@pytest.mark.parametrize("name", list(SINGLE_FOLDERS))
def test_single_instance_folder_matches_jax(name, tmp_path):
    backbone, heads = SINGLE_FOLDERS[name]
    folder = str(tmp_path / name)
    variables = write_run_folder(folder, backbone, heads, seed=1)
    stats = read_variables(os.path.join(folder, "best_model.ckpt"))["batch_stats"]
    assert bool(stats) == (name != "leap")  # the reader returns the running statistics
    frames = _frames(2, 64, seed=2)
    jpred = jp.SingleInstancePredictor(confmap_model=jax_trained_model(folder, variables),
                                       batch_size=2)
    tpred = tp.load_model(folder, device="cpu", batch_size=2)
    assert isinstance(tpred, tp.SingleInstancePredictor)
    assert not tpred.confmap_model.module.training
    got = _assert_outputs_match(tpred.predict(frames, make_labels=False),
                                jpred.predict(frames, make_labels=False),
                                ("instance_peaks", "instance_peak_vals"), ("instance_peaks",))
    assert np.isfinite(got["instance_peaks"]).any()
    labels = tpred.predict(frames)
    assert len(labels) == 2 and all(len(lf.instances) == 1 for lf in labels)


def test_topdown_pretrained_encoder_instance_folder_matches_jax(tmp_path):
    folder = str(tmp_path / "instance")
    variables = write_run_folder(
        folder,
        {"pretrained_encoder": jc.PretrainedEncoderConfig(
            encoder="resnet18", pretrained=False, decoder_filters=16, output_stride=2)},
        jc.HeadsConfig(centered_instance=jc.CenteredInstanceConfmapsHeadConfig(
            part_names=["A", "B"], output_stride=2)),
        preprocessing=jc.PreprocessingConfig(ensure_rgb=True, imagenet_mode="caffe"),
        crop_size=96,
        seed=4,
    )
    frames = _frames(2, 384, seed=0)
    jpred = jp.TopDownPredictor(centroid_model=jp.load_trained_model(CENTROID),
                                confmap_model=jax_trained_model(folder, variables),
                                peak_threshold=0.05, batch_size=2)
    tpred = tp.load_model([CENTROID, folder], device="cpu", peak_threshold=0.05, batch_size=2)
    assert isinstance(tpred, tp.TopDownPredictor)
    assert tpred.confmap_model.imagenet_mode == "caffe" and not tpred.confmap_model.grayscale
    keys = ("instance_peaks", "instance_peak_vals", "centroids", "centroid_vals", "centroid_mask")
    got = _assert_outputs_match(tpred.predict(frames, make_labels=False),
                                jpred.predict(frames, make_labels=False),
                                keys, ("instance_peaks", "centroids"))
    assert got["centroid_mask"].sum() >= 2 and np.isfinite(got["instance_peaks"]).any()


def test_bn_folder_predictions_change_with_the_running_statistics(tmp_path):
    """The checkpoint's ``batch_stats`` reach the module: the same folder
    with its running statistics reset to 0 and 1 predicts otherwise."""
    backbone, heads = SINGLE_FOLDERS["hrnet"]
    folder = str(tmp_path / "hrnet")
    variables = write_run_folder(folder, backbone, heads, seed=1)
    frames = _frames(2, 64, seed=2)
    got = tp.load_model(folder, device="cpu").predict(frames, make_labels=False)
    reset = jax.tree_util.tree_map_with_path(
        lambda p, a: np.zeros_like(a) if p[-1].key == "mean" else np.ones_like(a),
        variables["batch_stats"])
    params = {folder: {"params": variables["params"], "batch_stats": reset}}
    other = tp.load_model(folder, device="cpu", params=params).predict(frames, make_labels=False)
    a = _merged(got, ("instance_peak_vals",))["instance_peak_vals"]
    b = _merged(other, ("instance_peak_vals",))["instance_peak_vals"]
    assert not np.allclose(np.nan_to_num(a), np.nan_to_num(b))
