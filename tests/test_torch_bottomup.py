"""The port's bottom-up predictor against the JAX package's, on the same
weights and frames: the trained ``.convergence_runs`` bottom-up folder
(offset head, float32), a shrunken integral-refinement config at K = 8 (the
LAP's DP path) and K = 16 (its shortest-augmenting-path solver), and the
same config in bf16.

Tolerances (float32): points within 0.01 px and values within 1e-4, as for
top-down (convolutions sum in another order in each framework); instance
counts and masks equal; instance scores within 1e-4.

bf16: the two frameworks round at other places inside the network, so head
outputs agree within ``BF16_HEAD_TOL``, 2 bf16 ulps at the maps' largest
values of about 1.7 (measured on this config: 0.0078, one ulp, on about a
third of the entries). Fed the same bf16 maps, everything
after the heads agrees with the JAX computation the TPU runs (kernel 4 in
interpret mode, then line scores, matching, assembly): masks, instance
counts and peak values exact, points within 1e-4 px (integral refinement
divides in another order, times the stride), scores within 1e-6 relative.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.config import (
    BackboneConfig,
    DataConfig,
    HeadsConfig,
    ModelConfig,
    MultiInstanceConfig,
    MultiInstanceConfmapsHeadConfig,
    PartAffinityFieldsHeadConfig,
    PreprocessingConfig,
    TrainingJobConfig,
    UNetConfig,
)
from sleap_tpu.inference import predictors as jp
from sleap_tpu.inference.bottomup import BottomUpPredictor as JaxBottomUp
from sleap_tpu.models.model import Model as JaxModel
from sleap_tpu.ops.pallas_peaks import find_local_peaks_fused_pallas_hwcs
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.inference.bottomup import BottomUpPredictor
from sleap_tpu_torch.models.model import Model
from sleap_tpu_torch.models.params import state_dict_from_flax

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _highest_precision():
    """Full-f32 matmuls and convs on the JAX side, for this file only."""
    with jax.default_matmul_precision("highest"):
        yield


RUNS = Path(__file__).resolve().parent.parent / ".convergence_runs"
BOTTOMUP = str(RUNS / "minimal_instance.UNet.bottomup")
PT_TOL = 0.01
VAL_TOL = 1e-4
BF16_HEAD_TOL = 2 * 2.0**-7
BF16_PT_TOL = 1e-4
NODES = [f"n{i}" for i in range(5)]
EDGES = list(zip(NODES[:-1], NODES[1:]))
KEYS = ("instance_peaks", "instance_peak_vals", "instance_scores")


def _frames(n, hw, seed, blobs=3, sigma=6.0):
    """uint8 noise frames with bright planted Gaussian blobs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    frames = rng.uniform(0, 30, (n, hw, hw, 1))
    for i in range(n):
        for _ in range(blobs):
            cy, cx = rng.uniform(hw * 0.2, hw * 0.8, 2)
            frames[i] += 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))[..., None]
    return np.clip(frames, 0, 255).astype(np.uint8)


def _flat(examples):
    """Per-frame instance arrays of all batches, trimmed to valid frames."""
    return {k: [a for ex in examples for a in ex[k][: ex["n_valid"]]] for k in KEYS}


def _assert_close_nan(a, b, atol):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=atol, rtol=0)


def _assert_bottomup_equal(got, want, min_instances, pt_tol=PT_TOL, val_tol=VAL_TOL):
    got, want = _flat(got), _flat(want)
    assert [len(p) for p in got["instance_peaks"]] == [len(p) for p in want["instance_peaks"]]
    assert sum(len(p) for p in got["instance_peaks"]) >= min_instances
    for g, w in zip(got["instance_peaks"], want["instance_peaks"]):
        _assert_close_nan(g, np.asarray(w, np.float32), pt_tol)
    for g, w in zip(got["instance_peak_vals"], want["instance_peak_vals"]):
        _assert_close_nan(g, np.asarray(w, np.float32), val_tol)
    for g, w in zip(got["instance_scores"], want["instance_scores"]):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=val_tol, rtol=0)


# --------------------------------------------------------------------------- #
# The trained bottom-up folder (offset head)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def trained():
    jpred = JaxBottomUp.from_trained_models(BOTTOMUP, batch_size=2, peak_threshold=0.1)
    params = jax.tree_util.tree_map(np.asarray, jpred.bottomup_model.variables["params"])
    tpred = tp.load_model(BOTTOMUP, device="cpu", params={BOTTOMUP: params},
                          batch_size=2, peak_threshold=0.1)
    return jpred, tpred, params, _frames(3, 128, seed=0, blobs=2, sigma=10.0)


def test_load_trained_bottomup_folder(trained):
    _, tpred, _, _ = trained
    assert isinstance(tpred, BottomUpPredictor)
    tm = tpred.bottomup_model
    assert (tm.output_stride, tm.paf_stride, tm.pad_to_stride) == (2, 4, 8)
    assert tm.part_names == ["A", "B"] and tm.edges == [("A", "B")]
    assert tm.module.compute_dtype == torch.float32
    specs = {h.name: (h.channels, h.output_stride) for h in tm.module.head_specs}
    assert specs == {
        "MultiInstanceConfmapsHead": (2, 2),
        "PartAffinityFieldsHead": (2, 4),
        "OffsetRefinementHead": (4, 2),
    }
    assert tpred.paf_scorer.sorted_edge_inds == (0,)


def test_trained_bottomup_params_carry_heads_by_name(trained):
    _, tpred, params, _ = trained
    state = tpred.bottomup_model.module.state_dict()
    for head in ("MultiInstanceConfmapsHead", "PartAffinityFieldsHead", "OffsetRefinementHead"):
        np.testing.assert_array_equal(
            state[f"heads.{head}.weight"].numpy()[:, :, 0, 0], params[head]["kernel"][0, 0].T
        )
        np.testing.assert_array_equal(state[f"heads.{head}.bias"].numpy(), params[head]["bias"])


def test_trained_bottomup_heads_match_jax(trained):
    jpred, tpred, _, frames = trained
    jtm = jpred.bottomup_model
    want = jtm.module.apply(jtm.variables, jnp.asarray(frames), train=False)
    with torch.inference_mode():
        got = tpred.bottomup_model.module(torch.from_numpy(frames))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0)


def test_trained_bottomup_outputs_match_jax(trained):
    jpred, tpred, _, frames = trained
    _assert_bottomup_equal(
        tpred.predict(frames, make_labels=False),
        jpred.predict(frames, make_labels=False),
        min_instances=2,
    )


def test_trained_bottomup_labels_match_jax(trained):
    jpred, tpred, _, frames = trained
    got, want = tpred.predict(frames), jpred.predict(frames)
    assert type(got) is Labels  # the port's own, not the JAX package's
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    assert [len(lf.instances) for lf in got] == [len(lf.instances) for lf in want]
    assert sum(len(lf.instances) for lf in got) > 0
    for lg, lw in zip(got, want):
        for ig, iw in zip(lg.instances, lw.instances):
            _assert_close_nan(ig.numpy(), iw.numpy(), PT_TOL)
            assert ig.score == pytest.approx(iw.score, abs=VAL_TOL)
            assert [n.name for n in ig.skeleton.nodes] == [n.name for n in iw.skeleton.nodes]
            assert len(ig.skeleton.edges) == len(iw.skeleton.edges) == 1


# --------------------------------------------------------------------------- #
# A shrunken integral-refinement config (s2d 4, 5 nodes in a chain, PAFs at
# twice the confmap stride, up_interpolate)
# --------------------------------------------------------------------------- #


def _shrunken_config():
    model_cfg = ModelConfig(
        backbone=BackboneConfig(unet=UNetConfig(
            max_stride=16, output_stride=4, filters=8, filters_rate=2.0,
            up_interpolate=True, space_to_depth=4,
        )),
        heads=HeadsConfig(multi_instance=MultiInstanceConfig(
            confmaps=MultiInstanceConfmapsHeadConfig(part_names=NODES, output_stride=4, sigma=2.5),
            pafs=PartAffinityFieldsHeadConfig(edges=[list(e) for e in EDGES], output_stride=8,
                                              sigma=5.0),
        )),
    )
    return TrainingJobConfig(
        model=model_cfg,
        data=DataConfig(preprocessing=PreprocessingConfig(input_scaling=1.0, pad_to_stride=16)),
    )


@pytest.fixture(scope="module")
def shrunken():
    """(config, JAX model, numpy params): non-negative head kernels, scaled
    so the maps cross the peak threshold and PAF lines score above
    ``min_line_scores``."""
    cfg = _shrunken_config()
    jmodel = JaxModel.from_config(cfg.model)
    _, variables = jmodel.init(jax.random.PRNGKey(0), (64, 64, 1))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for name in params:
        if name != "backbone":
            scale = 40.0 if name == "PartAffinityFieldsHead" else 3.0
            params[name]["kernel"] = np.abs(params[name]["kernel"]) * scale
    return cfg, jmodel, params


def _pair(shrunken, K, jax_dtype=jnp.float32, torch_dtype=torch.float32):
    cfg, jmodel, params = shrunken
    jtm = jp.TrainedModel(config=cfg, model=jmodel,
                          module=jmodel.make_flax_module(compute_dtype=jax_dtype),
                          variables={"params": params}, input_channels=1)
    tmod = Model.from_config(cfg.model).make_module(1, torch_dtype)
    tmod.load_state_dict(state_dict_from_flax(tmod, params))
    ttm = tp.TrainedModel(module=tmod.eval(), input_scale=1.0, output_stride=4, pad_to_stride=16,
                          part_names=NODES, paf_stride=8, edges=EDGES)
    return (JaxBottomUp(bottomup_model=jtm, max_peaks_per_node=K, batch_size=2),
            BottomUpPredictor(device=torch.device("cpu"), bottomup_model=ttm,
                              max_peaks_per_node=K, batch_size=2))


@pytest.mark.parametrize("K", [8, 16])
def test_shrunken_integral_bottomup_matches_jax(shrunken, K):
    jpred, tpred = _pair(shrunken, K)
    frames = _frames(3, 128, seed=1)
    got = tpred.predict(frames, make_labels=False)
    _assert_bottomup_equal(got, jpred.predict(frames, make_labels=False), min_instances=6)
    assert max(int((~np.isnan(p[:, :, 0])).sum(1).max()) for p in _flat(got)["instance_peaks"]) >= 3


def test_shrunken_bottomup_max_instances_trims_like_jax(shrunken):
    jpred, tpred = _pair(shrunken, 8)
    jpred.max_instances = tpred.max_instances = 2
    frames = _frames(3, 128, seed=1)
    got = tpred.predict(frames, make_labels=False)
    assert max(len(p) for p in _flat(got)["instance_peaks"]) == 2
    _assert_bottomup_equal(got, jpred.predict(frames, make_labels=False), min_instances=4)


def test_multi_instance_model_matches_jax_heads(shrunken):
    cfg, jmodel, params = shrunken
    tmod = Model.from_config(cfg.model).make_module(1)
    tmod.load_state_dict(state_dict_from_flax(tmod, params))
    frames = _frames(2, 96, seed=2)
    want = jmodel.make_flax_module().apply({"params": params}, jnp.asarray(frames), train=False)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(frames))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "MultiInstanceConfmapsHead": (2, 24, 24, 5),
        "PartAffinityFieldsHead": (2, 12, 12, 8),
    }
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------- #
# bf16
# --------------------------------------------------------------------------- #


def _to_torch_bf16(x):
    bits = np.asarray(x).view(np.uint16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def test_bf16_heads_match_jax(shrunken):
    jpred, tpred = _pair(shrunken, 8, jnp.bfloat16, torch.bfloat16)
    frames = _frames(2, 128, seed=3)
    jtm = jpred.bottomup_model
    want = jtm.module.apply(jtm.variables, jnp.asarray(frames), train=False)
    with torch.inference_mode():
        got = tpred.bottomup_model.module(torch.from_numpy(frames))
    for key in want:
        assert want[key].dtype == jnp.bfloat16 and got[key].dtype == torch.bfloat16
        # NHWC maps that are contiguous in memory: the bf16 peak kernel
        # reads them with no copy.
        assert got[key].is_contiguous()
        w = np.asarray(want[key]).astype(np.float32)
        err = np.abs(got[key].float().numpy() - w).max()
        assert err <= BF16_HEAD_TOL, (key, err, np.abs(w).max())


def _jax_group_on_tpu_path(jpred, out, K):
    """The JAX predictor's post-processing as the TPU runs it on bf16 maps:
    kernel 4 (interpret mode), then scores, matching and assembly."""
    scorer = jpred._make_paf_scorer()
    cms = out["MultiInstanceConfmapsHead"]
    pk, v = find_local_peaks_fused_pallas_hwcs(
        jnp.transpose(cms, (1, 2, 3, 0)), max_peaks=K, threshold=jpred.peak_threshold,
        refine=True, interpret=True,
    )
    valid = jnp.isfinite(v)
    peaks = jnp.where(valid[..., None], pk, jnp.nan) * 4.0
    vals = jnp.where(valid, v, 0.0)
    dst, match_scores, _ = scorer.score_and_match(out["PartAffinityFieldsHead"], peaks)
    return scorer.group_batch(peaks, vals, dst, match_scores)


@pytest.mark.parametrize("K", [8, 16])
def test_bf16_postprocessing_on_jax_maps_matches_jax(shrunken, K):
    jpred, tpred = _pair(shrunken, K, jnp.bfloat16, torch.bfloat16)
    frames = _frames(2, 128, seed=4)
    jtm = jpred.bottomup_model
    out = jtm.module.apply(jtm.variables, jnp.asarray(frames), train=False)
    want = {k: np.asarray(v) for k, v in _jax_group_on_tpu_path(jpred, out, K).items()}
    with torch.inference_mode():
        got = tpred.group_heads({k: _to_torch_bf16(v) for k, v in out.items()})
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["instance_valid"], want["instance_valid"])
    assert got["instance_valid"].sum() >= 4
    _assert_close_nan(got["instances"], want["instances"], BF16_PT_TOL)
    np.testing.assert_array_equal(got["instance_peak_vals"], want["instance_peak_vals"])
    np.testing.assert_allclose(got["instance_scores"], want["instance_scores"], rtol=1e-6, atol=0)


def test_bf16_predictor_runs_end_to_end(shrunken):
    _, tpred = _pair(shrunken, 8, jnp.bfloat16, torch.bfloat16)
    _, fpred = _pair(shrunken, 8)
    frames = _frames(2, 128, seed=5)
    got = _flat(tpred.predict(frames, make_labels=False))
    want = _flat(fpred.predict(frames, make_labels=False))
    assert sum(len(p) for p in got["instance_peaks"]) >= 2
    for g, w in zip(got["instance_peaks"], want["instance_peaks"]):
        assert g.dtype == np.float32 and g.shape[1:] == w.shape[1:]


# --------------------------------------------------------------------------- #
# Batching: no size matching, as in the JAX predictor
# --------------------------------------------------------------------------- #


def test_mixed_size_videos_are_not_size_matched(shrunken):
    from sleap_tpu.core.instance import LabeledFrame
    from sleap_tpu.core.labels import Labels
    from sleap_tpu.io.video import Video

    jpred, tpred = _pair(shrunken, 8)
    jpred.batch_size = tpred.batch_size = 1
    small, large = _frames(1, 96, seed=6), _frames(1, 128, seed=7)
    labels = Labels(labeled_frames=[
        LabeledFrame(video=Video.from_numpy(large), frame_idx=0),
        LabeledFrame(video=Video.from_numpy(small), frame_idx=0),
    ])
    assert not tpred.size_matching
    got = tpred.predict(labels, make_labels=False)
    assert [ex["image"].shape[1:3] for ex in got] == [(128, 128), (96, 96)]
    _assert_bottomup_equal(got, jpred.predict(labels, make_labels=False), min_instances=2)


def test_from_trained_models_matches_load_model_and_jax(trained):
    """``from_trained_models`` of the trained folder (its own checkpoint)
    equals ``load_model``'s predictor exactly and JAX's within the file's
    tolerances, with the JAX predictor's config and model names."""
    jpred, _, _, frames = trained
    kw = dict(batch_size=2, peak_threshold=0.1)
    mine = BottomUpPredictor.from_trained_models(BOTTOMUP, device="cpu", **kw)
    loaded = tp.load_model(BOTTOMUP, device="cpu", **kw)
    got, same = _flat(mine.predict(frames, make_labels=False)), _flat(loaded.predict(frames, make_labels=False))
    for key in KEYS:
        for g, s in zip(got[key], same[key]):
            np.testing.assert_array_equal(g, s)
    _assert_bottomup_equal(mine.predict(frames, make_labels=False), jpred.predict(frames, make_labels=False),
                           min_instances=2)
    assert mine.bottomup_config.model.heads.which_oneof_attrib_name == "multi_instance"
    assert mine.bottomup_model.model.head_names == jpred.bottomup_model.model.head_names
    assert mine.bottomup_model.input_channels == jpred.bottomup_model.input_channels
    assert mine.report_rate == jpred.report_rate


def test_visual_predictor_on_the_trained_folder_matches_jax(trained):
    """The trained folder's maps (confidence maps, PAFs and offsets), each
    within 1e-3 of the JAX package's VisualPredictor."""
    from sleap_tpu_torch.inference.predictors import VisualPredictor

    _, _, _, frames = trained
    ref = jp.VisualPredictor.from_trained_models(BOTTOMUP, batch_size=2)
    mine = VisualPredictor.from_trained_models(BOTTOMUP, device="cpu", batch_size=2)
    assert mine.head_specific_output_keys() == ref.head_specific_output_keys() == ["confmaps",
                                                                                    "part_affinity_fields"]
    for g, w in zip(mine.predict(frames), ref.predict(frames)):
        assert sorted(g) == sorted(w) == ["confmaps", "frame_ind", "offsets", "part_affinity_fields",
                                          "video_ind"]
        for key in w:
            np.testing.assert_allclose(g[key], np.asarray(w[key]), atol=1e-3, rtol=0)
