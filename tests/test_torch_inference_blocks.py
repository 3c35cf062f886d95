"""The port's inference blocks (``sleap_tpu_torch.data.inference``) against
the JAX package's on the CPU, on seeded inputs:

- ``GlobalPeakFinder`` and ``LocalPeakFinder`` on 4 x 32 x 32 x 3 maps of
  planted peaks (the JAX side on its XLA route, the port's on its kernels'
  plain versions): the same peaks, points within 1e-4 px, values within
  1e-5, sample and channel indices equal;
- ``ModelPredictor`` with a narrow UNet (filters 8, max stride 4: two
  levels) whose flax params cross by ``state_dict_from_flax``: maps within
  ``tests/test_torch_topdown.py``'s value tolerance, 1e-4;
- ``MockGlobalPeakFinder`` and ``PredictedCenterInstanceNormalizer``: exact;
- the slice as a whole, a top-down chain of the blocks (centroid model,
  local peaks, unit crops, instance model, global peaks, normalizer) in
  each package: points within 1e-4 px x the strides, values within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu import config as jcfg
from sleap_tpu.data import dataset_ops as jops
from sleap_tpu.data import inference as jblocks
from sleap_tpu.data.resizing import resize_image as jax_resize_image
from sleap_tpu.inference import predictors as jp
from sleap_tpu.models.model import Model as JaxModel
from sleap_tpu.ops.peak_finding import crop_bboxes_unit as jax_crop_bboxes_unit
from sleap_tpu_torch import config as cfg
from sleap_tpu_torch.data import dataset_ops as ops
from sleap_tpu_torch.data import inference as blocks
from sleap_tpu_torch.data.normalization import ensure_float
from sleap_tpu_torch.data.resizing import resize_image
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.models.model import Model
from sleap_tpu_torch.models.params import state_dict_from_flax
from sleap_tpu_torch.ops.peak_finding import crop_bboxes_unit

torch.set_num_threads(1)

XY_TOL = 1e-4
VAL_TOL = 1e-5
MAP_TOL = 1e-4  # tests/test_torch_topdown.py's VAL_TOL


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _maps(seed, n=4, hw=32, channels=3, sigma=1.5):
    """Maps of 1-3 Gaussian peaks a channel at subpixel places, with a
    little noise (small local maxima below the threshold)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    out = rng.uniform(0, 0.05, (n, hw, hw, channels))
    for s in range(n):
        for c in range(channels):
            for _ in range(rng.integers(1, 4)):
                cy, cx = rng.uniform(3, hw - 3, 2)
                amp = rng.uniform(0.3, 1.0)
                out[s, :, :, c] = np.maximum(
                    out[s, :, :, c], amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)))
    return out.astype(np.float32)


def _assert_close_nan(got, want, atol):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), rtol=0, atol=atol)


def _run(block, jblock, ex):
    (got,) = list(block.transform_dataset([dict(ex)]))
    (want,) = list(jblock.transform_dataset([dict(ex)]))
    assert block.input_keys == jblock.input_keys and block.output_keys == jblock.output_keys
    assert sorted(got) == sorted(want)
    return got, want


@pytest.mark.parametrize("kwargs,rank3", [
    ({}, False),
    ({"confmaps_stride": 4, "integral": False, "keep_confmaps": False}, False),
    ({"peak_threshold": 0.6, "integral_patch_size": 3}, False),
    ({"confmaps_stride": 2}, True),
])
def test_global_peak_finder_matches_jax(kwargs, rank3):
    cms = _maps(0)
    ex = {"cms": cms[0] if rank3 else cms}
    keys = dict(confmaps_key="cms", peaks_key="pts", peak_vals_key="vals")
    got, want = _run(blocks.GlobalPeakFinder(**keys, **kwargs, device="cpu"),
                     jblocks.GlobalPeakFinder(**keys, **kwargs), ex)
    assert got["pts"].shape == want["pts"].shape == ((3, 2) if rank3 else (4, 3, 2))
    assert got["pts"].dtype == want["pts"].dtype
    _assert_close_nan(got["pts"], want["pts"], XY_TOL)
    np.testing.assert_allclose(got["vals"], want["vals"], rtol=0, atol=VAL_TOL)
    if kwargs.get("peak_threshold"):
        assert np.isnan(got["pts"]).any() and not np.isnan(got["pts"]).all()


@pytest.mark.parametrize("kwargs,seed", [
    ({}, 1),
    ({"confmaps_stride": 4, "integral": False, "keep_confmaps": False}, 2),
    ({"max_peaks": 1, "peak_threshold": 0.1}, 3),
    ({"max_peaks": 2, "peak_threshold": 0.5}, 4),
])
def test_local_peak_finder_matches_jax(kwargs, seed):
    ex = {"centroid_confidence_maps": _maps(seed)}
    got, want = _run(blocks.LocalPeakFinder(**kwargs, device="cpu"), jblocks.LocalPeakFinder(**kwargs), ex)
    p = "predicted_centroid"
    assert len(got[f"{p}s"]) == len(want[f"{p}s"]) >= 8
    for key in (f"{p}_sample_inds", f"{p}_channel_inds"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype == np.int32
    assert got[f"{p}s"].dtype == want[f"{p}s"].dtype == np.float32
    np.testing.assert_allclose(got[f"{p}s"], want[f"{p}s"], rtol=0, atol=XY_TOL * kwargs.get("confmaps_stride", 1))
    np.testing.assert_allclose(got[f"{p}_confidences"], want[f"{p}_confidences"], rtol=0, atol=VAL_TOL)


def test_mock_global_peak_finder_matches_jax():
    rng = np.random.default_rng(5)
    for keep in (True, False):
        for _ in range(5):
            instances = rng.uniform(0, 60, (3, 4, 2))
            instances[rng.random((3, 4)) < 0.3] = np.nan
            instances[:, 0] = rng.uniform(0, 60, (3, 2))
            ex = {"instances": instances, "centroid": rng.uniform(0, 60, 2), "bbox": rng.uniform(0, 30, 4),
                  "scale": np.array([1.0, 1.0]) * rng.choice([1.0, 0.5]),
                  "instance_confidence_maps": rng.random((8, 8, 4)).astype("f4")}
            got, want = _run(blocks.MockGlobalPeakFinder(keep_confmaps=keep),
                             jblocks.MockGlobalPeakFinder(keep_confmaps=keep), ex)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


def test_normalizer_matches_jax():
    rng = np.random.default_rng(6)
    for _ in range(5):
        ex = {"centroid": rng.uniform(0, 60, 2), "centroid_confidence": np.float32(rng.random()),
              "predicted_center_instance_points": rng.uniform(0, 30, (5, 2)).astype("f4"),
              "predicted_center_instance_confidences": rng.random(5).astype("f4"),
              "scale": rng.choice([1.0, 2.0, 0.5]) * np.ones(2), "bbox": rng.uniform(0, 30, 4)}
        got, want = _run(blocks.PredictedCenterInstanceNormalizer(),
                         jblocks.PredictedCenterInstanceNormalizer(), ex)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


def _model_pair(heads, seed=0, input_scaling=1.0, crop_size=None, hw=32):
    """The same narrow UNet (filters 8, two levels) in both packages:
    JAX's initialized variables, carried to the port's module by
    ``state_dict_from_flax``; non-negative heads."""
    unet = dict(max_stride=4, output_stride=2, filters=8, filters_rate=2.0)
    jmodel_cfg = jcfg.ModelConfig(backbone=jcfg.BackboneConfig(unet=jcfg.UNetConfig(**unet)), heads=heads[1])
    jmodel = JaxModel.from_config(jmodel_cfg)
    module, variables = jmodel.init(jax.random.PRNGKey(seed), (hw, hw, 1))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for name in params:
        if name != "backbone":
            params[name]["kernel"] = np.abs(params[name]["kernel"]) * 20.0
    jtm = jp.TrainedModel(config=jcfg.TrainingJobConfig(model=jmodel_cfg), model=jmodel, module=module,
                          variables={"params": params}, input_channels=1)
    model_cfg = cfg.ModelConfig(backbone=cfg.BackboneConfig(unet=cfg.UNetConfig(**unet)), heads=heads[0])
    tmod = Model.from_config(model_cfg).make_module(1)
    tmod.load_state_dict(state_dict_from_flax(tmod, params))
    ttm = tp.TrainedModel(module=tmod.eval(), input_scale=input_scaling, output_stride=2, pad_to_stride=4,
                          part_names=["a", "b", "c"], crop_size=crop_size)
    return ttm, jtm


def _heads(kind):
    """The same head config in each package (port, JAX)."""
    out = []
    for c in (cfg, jcfg):
        if kind == "centroid":
            out.append(c.HeadsConfig(centroid=c.CentroidsHeadConfig(output_stride=2, sigma=1.5)))
        elif kind == "instance":
            out.append(c.HeadsConfig(centered_instance=c.CenteredInstanceConfmapsHeadConfig(
                part_names=["a", "b", "c"], output_stride=2, sigma=1.5)))
        else:  # two heads: the order of the outputs
            out.append(c.HeadsConfig(multi_instance=c.MultiInstanceConfig(
                confmaps=c.MultiInstanceConfmapsHeadConfig(part_names=["a", "b", "c"], output_stride=2),
                pafs=c.PartAffinityFieldsHeadConfig(edges=[["a", "b"], ["b", "c"]], output_stride=2))))
    return out


def _frames(n, hw, seed, blobs=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    frames = rng.uniform(0, 30, (n, hw, hw, 1))
    for i in range(n):
        for _ in range(blobs):
            cy, cx = rng.uniform(hw * 0.25, hw * 0.75, 2)
            frames[i] += 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0**2))[..., None]
    return np.clip(frames, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind,rank3,out_keys", [
    ("instance", False, "cms"),
    ("instance", True, ["cms", "again"]),
    ("bottomup", False, ["cms", "pafs"]),
])
def test_model_predictor_matches_jax(kind, rank3, out_keys):
    ttm, jtm = _model_pair(_heads(kind))
    frames = _frames(4, 32, seed=7)
    ex = {"img": frames[0] if rank3 else frames}
    got, want = _run(blocks.ModelPredictor(model=ttm, model_input_keys="img", model_output_keys=out_keys,
                                           device="cpu"),
                     jblocks.ModelPredictor(model=jtm, model_input_keys="img", model_output_keys=out_keys), ex)
    for k in ([out_keys] if isinstance(out_keys, str) else out_keys):
        assert got[k].dtype == want[k].dtype == np.float32
        assert got[k].shape == want[k].shape
        assert got[k].shape[:-1] == ((16, 16) if rank3 else (4, 16, 16))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=MAP_TOL, err_msg=k)
        assert want[k].max() > 0.1
    if kind == "bottomup":
        assert got["cms"].shape[-1] == 3 and got["pafs"].shape[-1] == 4


def _chain(pkg, centroid, instance, frames, crop, device="cpu"):
    """The top-down path as blocks: centroid model on frames scaled by
    0.5, local peaks (x the centroid stride / scale), unit crops of the
    frames around the centroids, the instance model, global peaks, and the
    normalizer back to frame coordinates; returns the per-instance examples.
    ``pkg`` is "torch" or "jax"."""
    B, D = (blocks, ops) if pkg == "torch" else (jblocks, jops)
    dev = {"device": device} if pkg == "torch" else {}

    def scaled(ex):
        if pkg == "torch":
            small = resize_image(ensure_float(torch.from_numpy(ex["image"])), 0.5).numpy()
        else:
            small = np.asarray(jax_resize_image(jnp.asarray(ex["image"], jnp.float32) / 255.0, 0.5))
        return {**ex, "centroid_image": small}

    def crops(ex):
        cents = ex["predicted_centroids"]
        top_left = (cents - (crop - 1) / 2.0).astype(np.float32)
        inds = ex["predicted_centroid_sample_inds"]
        if pkg == "torch":
            c = crop_bboxes_unit(torch.from_numpy(ex["image"]), torch.from_numpy(top_left),
                                 torch.from_numpy(inds.astype(np.int64)), (crop, crop))
            c = torch.trunc(c).to(torch.uint8).numpy()
        else:
            c = np.asarray(jnp.trunc(jax_crop_bboxes_unit(jnp.asarray(ex["image"]), jnp.asarray(top_left),
                                                          jnp.asarray(inds), (crop, crop))).astype(jnp.uint8))
        n = len(cents)
        return {"instance_image": c, "centroid": cents, "centroid_confidence": ex["predicted_centroid_confidences"],
                "bbox": np.concatenate([top_left[:, ::-1], top_left[:, ::-1] + crop - 1], axis=1),
                "scale": np.ones((n, 2), np.float32), "frame_ind": ex["frame_ind"][inds]}

    stream = [{"image": frames, "frame_ind": np.arange(len(frames))}]
    for block in (
            D.LambdaMap(scaled),
            B.ModelPredictor(model=centroid, model_input_keys="centroid_image",
                             model_output_keys="centroid_confidence_maps", **dev),
            B.LocalPeakFinder(confmaps_stride=4, peak_threshold=0.2, max_peaks=4, keep_confmaps=False, **dev),
            D.LambdaMap(crops),
            B.ModelPredictor(model=instance, model_input_keys="instance_image", **dev),
            B.GlobalPeakFinder(confmaps_stride=2, peak_threshold=0.2, keep_confmaps=False, **dev),
            D.Unbatcher(),
            B.PredictedCenterInstanceNormalizer()):
        stream = block.transform_dataset(stream)
    return list(stream)


def test_topdown_chain_of_blocks_matches_jax():
    frames = _frames(4, 64, seed=8)
    (tc, jc), (ti, ji) = _model_pair(_heads("centroid"), seed=1), _model_pair(_heads("instance"), seed=2)
    got = _chain("torch", tc, ti, frames, crop=16)
    want = _chain("jax", jc, ji, frames, crop=16)
    assert len(got) == len(want) >= 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["frame_ind"] == w["frame_ind"]
        np.testing.assert_allclose(g["predicted_centroid"], w["predicted_centroid"], rtol=0, atol=XY_TOL * 4)
        _assert_close_nan(g["predicted_instance"], w["predicted_instance"], XY_TOL * 2)
        np.testing.assert_allclose(g["predicted_instance_confidences"], w["predicted_instance_confidences"],
                                   rtol=0, atol=MAP_TOL)
    assert np.isfinite(np.concatenate([g["predicted_instance"] for g in got])).any()


def test_blocks_run_on_the_card_by_default():
    for cls in (blocks.ModelPredictor, blocks.GlobalPeakFinder, blocks.LocalPeakFinder):
        assert cls().device == torch.device("cuda")
