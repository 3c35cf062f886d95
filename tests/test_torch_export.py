"""``sleap-export`` in the port against the JAX package, on the CPU.

- The four kernels as custom ops (``torch.ops.sleap_tpu_torch.*``) pass
  ``torch.library.opcheck`` with the plain versions as CPU kernels.
- Every head type round-trips: the trained ``.convergence_runs`` folders
  (single-instance, the top-down pair, bottom-up at K = 16, the LAP's
  bounded solver, and K = 8, its DP; top-down multiclass) and a seeded
  bottom-up multiclass model. Each loaded program equals the port's
  ``predict`` arrays exactly, and the JAX package's own exported program
  on the same uint8 frames within the port's standing 0.05 px / 1e-3
  (float32 convolutions sum in another order in each framework; the JAX
  side runs at ``jax_default_matmul_precision="highest"``).
- ``Predictor.export_model`` on the JAX test's seeded 2-node UNet, its
  params carried over by the bridge; a seeded batch-norm backbone in eval
  mode; the top-down evaluation modes, which raise; the CLI against the JAX
  CLI.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.cli import export as jcli
from sleap_tpu.inference import export as jexport
from sleap_tpu.inference import multiclass as jm
from sleap_tpu.inference.predictors import Predictor as JaxPredictor
from sleap_tpu_torch.cli import export as tcli
from sleap_tpu_torch.inference import export as texport
from sleap_tpu_torch.inference import multiclass as tm
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.ops import cuda_crops, cuda_peaks
from test_torch_backbone_paths import SINGLE_FOLDERS, write_run_folder
from test_torch_multiclass import CLASSES, _bottomup_heads, _pair

torch.set_num_threads(2)

RUNS = Path(__file__).resolve().parent.parent / ".convergence_runs"
CENTROID = str(RUNS / "minimal_instance.UNet.centroid")
CENTERED = str(RUNS / "minimal_instance.UNet.centered_instance")
PT_TOL = 0.05
VAL_TOL = 1e-3
POINT_KEYS = ("instance_peaks", "centroids", "instances", "points")
INFO_KEYS = {"predictor", "model_paths", "input_shape", "input_dtype", "outputs", "format"}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _frames(shape, seed):
    """uint8 noise frames with two bright Gaussian blobs (sigma 14 px) each."""
    n, hw, _, c = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    frames = rng.uniform(0, 30, (n, hw, hw, 1))
    for i in range(n):
        for _ in range(2):
            cy, cx = rng.uniform(hw * 0.25, hw * 0.75, 2)
            frames[i] += 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 14.0**2))[..., None]
    return np.repeat(np.clip(frames, 0, 255).astype(np.uint8), c, axis=-1)


def _assert_equal_nan(a, b, what):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b), err_msg=what)


def _assert_close_nan(a, b, atol, what):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=atol, rtol=0, err_msg=what)


def _numpy(out):
    return {k: np.asarray(v.float() if v.dtype == torch.bfloat16 else v) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in out.items()}


def _assert_program_is_predict(program_out, pred, frames):
    """The program's arrays, through the predictor's host step, equal one
    batch of ``predict`` exactly."""
    want = pred.predict(frames, make_labels=False)
    assert len(want) == 1
    batch = {"scale": np.ones(len(frames), np.float32)}
    got = pred._postprocess(_numpy(program_out), batch)
    for key in got:
        if isinstance(got[key], list):  # bottom-up: each frame's instances
            for g, w in zip(got[key], want[0][key]):
                _assert_equal_nan(g, w, key)
        else:
            _assert_equal_nan(np.asarray(got[key], np.float64), np.asarray(want[0][key], np.float64),
                              key)


def _assert_program_is_jax(program_out, jax_out):
    got = _numpy(program_out)
    want = {k: np.asarray(v) for k, v in jax_out.items()}
    assert sorted(got) == sorted(want)
    for key in got:
        if got[key].dtype == bool:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            tol = PT_TOL if key in POINT_KEYS else VAL_TOL
            _assert_close_nan(got[key].astype(np.float64), want[key].astype(np.float64), tol, key)


# --------------------------------------------------------------------------- #
# The kernels as custom ops
# --------------------------------------------------------------------------- #


def _op_cases():
    gen = torch.Generator().manual_seed(0)
    maps = torch.rand((2, 16, 12, 3), generator=gen)
    maps_cl = torch.rand((2, 3, 16, 12), generator=gen).permute(0, 2, 3, 1)  # NCHW viewed NHWC
    images = torch.randint(0, 255, (2, 24, 20, 2), dtype=torch.uint8, generator=gen)
    top_left = torch.rand((3, 2), generator=gen) * 30 - 6
    boxes = torch.tensor([0, 1, 1])
    return {
        "global_peaks integral": ("global_peaks", (maps, 0.2, 2)),
        "global_peaks grid, NCHW view": ("global_peaks", (maps_cl, 0.5, -1)),
        "global_peaks bf16": ("global_peaks", (maps.bfloat16(), 0.2, 1)),
        "local_peaks": ("local_peaks", (maps, 4, 0.2, 2)),
        "local_peaks unrefined, NCHW view": ("local_peaks", (maps_cl, 3, 0.5, -1)),
        "local_peaks_hwcs": ("local_peaks_hwcs", (maps.bfloat16(), 4, 0.2, 2)),
        "local_peaks_hwcs unrefined": ("local_peaks_hwcs", (maps.bfloat16(), 2, 0.5, -1)),
        "crop_unit uint8": ("crop_unit", (images, top_left, boxes, 8, 6)),
        "crop_unit float32": ("crop_unit", (images.float(), top_left, boxes, 5, 5)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_custom_op_passes_opcheck(case):
    name, args = _op_cases()[case]
    op = getattr(torch.ops.sleap_tpu_torch, name).default
    torch.library.opcheck(op, args)
    plain = {"global_peaks": cuda_peaks.global_peaks_plain,
             "local_peaks": cuda_peaks.local_peaks_plain,
             "local_peaks_hwcs": cuda_peaks.local_peaks_hwcs_plain}.get(name)
    got = op(*args)
    if plain is None:
        want = cuda_crops.crop_unit_plain(*args[:3], args[3:])
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    else:
        for g, w in zip(got, plain(*args)):
            _assert_equal_nan(g.numpy(), w.numpy(), name)
    for wrapper in (cuda_peaks.global_peaks_cuda, cuda_peaks.local_peaks_cuda,
                    cuda_peaks.local_peaks_hwcs_cuda, cuda_crops.crop_unit_cuda):
        assert wrapper.launches == 0  # a CPU tensor never reaches a kernel


def test_fake_kernels_refuse_what_the_card_cannot_take():
    """Tracing for the card checks the wrappers' limits; for the CPU the
    plain versions take the same inputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        maps = torch.empty((1, 8, 8, 2), device="cuda")
        cases = [
            (lambda: cuda_peaks.local_peaks(maps, 65, 0.2, 2), "max_peaks"),
            (lambda: cuda_peaks.global_peaks(maps.double(), 0.2, 2), "float32 or bfloat16"),
            (lambda: cuda_peaks.local_peaks_hwcs(
                torch.empty((1, 512, 256, 1), dtype=torch.bfloat16, device="cuda"), 4, 0.2, 2),
             "2\\*\\*16"),
            (lambda: cuda_peaks.local_peaks_hwcs(maps.bfloat16(), 4, 0.0, 2), "threshold"),
            (lambda: cuda_crops.crop_unit(
                torch.empty((1, 8, 8, 4097), device="cuda"), maps.new_zeros((1, 2)),
                maps.new_zeros(1, dtype=torch.int64), (4, 4)), "4096 channels"),
        ]
        for fn, match in cases:
            with pytest.raises(ValueError, match=match):
                fn()
        xy, vals = cuda_peaks.local_peaks(maps.cpu(), 65, 0.2, 2)  # the CPU has no MAX_K
        assert xy.shape == (1, 2, 65, 2) and vals.shape == (1, 2, 65)


# --------------------------------------------------------------------------- #
# Round trips on every head type
# --------------------------------------------------------------------------- #

FOLDERS = {
    "single-instance": ([str(RUNS / "minimal_robot.UNet.single_instance")], 160, {}),
    "top-down": ([CENTROID, CENTERED], 384, {}),
    "bottom-up K=16": ([str(RUNS / "minimal_instance.UNet.bottomup")], 128, {}),
    "bottom-up K=8": ([str(RUNS / "minimal_instance.UNet.bottomup")], 128,
                      {"max_peaks_per_node": 8}),
    "top-down multiclass": ([CENTROID, str(RUNS / "min_tracks_2node.UNet.topdown_multiclass")],
                            384, {}),
}


@pytest.mark.parametrize("name", list(FOLDERS))
def test_trained_folder_round_trip(name, tmp_path):
    paths, size, attrs = FOLDERS[name]
    pred = tp.load_model(paths, device="cpu", batch_size=2, peak_threshold=0.05)
    for attr, value in attrs.items():
        setattr(pred, attr, value)
    out = pred.export_model(str(tmp_path / "torch"), image_size=size, model_paths=paths)
    info = json.load(open(os.path.join(out, "info.json")))
    assert INFO_KEYS <= set(info) and info["device"] == "cpu"
    assert info["predictor"] == type(pred).__name__ and info["model_paths"] == paths
    frames = _frames(info["input_shape"], seed=len(name))
    got = texport.load_exported_model(out)(frames)
    _assert_program_is_predict(got, pred, frames)

    jpred = JaxPredictor.from_model_paths(paths, batch_size=2, peak_threshold=0.05)
    for attr, value in attrs.items():
        setattr(jpred, attr, value)
    jout = jexport.export_predictor(jpred, str(tmp_path / "jax"), image_size=size, model_paths=paths)
    assert json.load(open(os.path.join(jout, "info.json")))["input_shape"] == info["input_shape"]
    _assert_program_is_jax(got, jexport.load_exported_model(jout)(frames))
    finite = np.isfinite(_numpy(got)[next(k for k in POINT_KEYS if k in got)])
    assert finite.any(), "the frames must give peaks"


def test_seeded_bottomup_multiclass_round_trip(tmp_path):
    jtm, ttm = _pair(_bottomup_heads(False), seed=3, input_scaling=0.5)
    tpred = tm.BottomUpMultiClassPredictor(device=torch.device("cpu"), model=ttm, batch_size=2)
    jpred = jm.BottomUpMultiClassPredictor(model=jtm, batch_size=2)
    frames = _frames((2, 128, 128, 1), seed=4)
    got = texport.load_exported_model(tpred.export_model(str(tmp_path / "t"), image_size=128))(frames)
    _assert_program_is_predict(got, tpred, frames)
    jout = jexport.export_predictor(jpred, str(tmp_path / "j"), image_size=128)
    _assert_program_is_jax(got, jexport.load_exported_model(jout)(frames))
    assert np.isfinite(_numpy(got)["points"]).any()
    assert got["points"].shape[1] == len(CLASSES)  # one row a class


def test_predictor_export_model_method(tmp_path):
    """The counterpart of the JAX package's test of the same name: the same
    seeded 2-node UNet, its params carried into the port by the bridge, and
    the two exported programs agree."""
    from sleap_tpu.config import (
        BackboneConfig,
        HeadsConfig,
        ModelConfig,
        SingleInstanceConfmapsHeadConfig,
        TrainingJobConfig,
        UNetConfig,
    )
    from sleap_tpu.inference.predictors import SingleInstancePredictor, TrainedModel
    from sleap_tpu.models.model import Model
    from sleap_tpu_torch.models.model import Model as TorchModel
    from sleap_tpu_torch.models.params import state_dict_from_flax

    cfg_m = ModelConfig(
        backbone=BackboneConfig(unet=UNetConfig(max_stride=8, output_stride=4, filters=4)),
        heads=HeadsConfig(single_instance=SingleInstanceConfmapsHeadConfig(
            part_names=["a", "b"], output_stride=4)),
    )
    model = Model.from_config(cfg_m)
    module = model.make_flax_module()
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)), train=False)
    jpred = SingleInstancePredictor(
        confmap_model=TrainedModel(config=TrainingJobConfig(model=cfg_m), model=model,
                                   module=module, variables=variables, input_channels=1),
        batch_size=2,
    )
    tmodel = TorchModel.from_config(cfg_m)
    tmod = tmodel.make_module(1, torch.float32, None)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmod.load_state_dict(state_dict_from_flax(tmod, params))
    tpred = tp.SingleInstancePredictor(
        device=torch.device("cpu"), batch_size=2,
        confmap_model=tp.TrainedModel(module=tmod.eval(), input_scale=1.0, output_stride=4,
                                      pad_to_stride=8, part_names=["a", "b"]),
    )
    fn = texport.load_exported_model(tpred.export_model(str(tmp_path / "exp"), image_size=64))
    res = fn(np.zeros((2, 64, 64, 1), np.uint8))
    assert res["instance_peaks"].shape[0] == 2
    jfn = jexport.load_exported_model(jpred.export_model(str(tmp_path / "jexp"), image_size=64))
    frames = _frames((2, 64, 64, 1), seed=9)
    for x in (np.zeros((2, 64, 64, 1), np.uint8), frames):
        _assert_program_is_jax(fn(x), jfn(x))
        _assert_program_is_predict(fn(x), tpred, x)


def test_batch_norm_backbone_exports_in_eval_mode(tmp_path):
    backbone, heads = SINGLE_FOLDERS["hourglass"]
    folder = str(tmp_path / "hourglass")
    write_run_folder(folder, backbone, heads, seed=1)
    pred = tp.load_model(folder, device="cpu", batch_size=2)
    frames = _frames((2, 64, 64, 1), seed=2)
    got = texport.load_exported_model(pred.export_model(str(tmp_path / "exp"), image_size=64))(frames)
    assert not pred.confmap_model.module.training
    _assert_program_is_predict(got, pred, frames)
    assert np.isfinite(got["instance_peaks"].numpy()).any()


@pytest.mark.parametrize("folder,mode", [(CENTROID, "centroid-only"),
                                         (CENTERED, "ground-truth centroid")])
def test_topdown_evaluation_modes_refuse_to_export(folder, mode, tmp_path):
    pred = tp.load_model(folder, device="cpu")
    with pytest.raises(ValueError, match=mode):
        pred.export_model(str(tmp_path / "exp"), image_size=64)
    assert not os.path.exists(tmp_path / "exp")


def test_loader_refuses_a_program_for_a_missing_device(tmp_path):
    out = tp.load_model(str(RUNS / "minimal_robot.UNet.single_instance"), device="cpu",
                        batch_size=1).export_model(str(tmp_path / "exp"), image_size=32)
    info_path = os.path.join(out, "info.json")
    info = json.load(open(info_path))
    info["device"] = f"cuda:{torch.cuda.device_count()}"
    json.dump(info, open(info_path, "w"))
    with pytest.raises(RuntimeError, match="does not have"):
        texport.load_exported_model(out)


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("argv", [
    ["-m", "a"],
    ["-m", "a", "-m", "b", "-e", "out", "-n", "3", "--batch_size", "2", "--image_size", "96"],
    ["--model", "a", "--export_path", "out", "--max_instances", "1"],
])
def test_cli_parser_matches_jax(argv, monkeypatch):
    calls = {}

    def capture(key):
        def fake(model_path, **kwargs):
            kwargs.pop("device", None)
            calls[key] = (model_path, kwargs)
            return kwargs["save_path"]
        return fake

    monkeypatch.setattr(jexport, "export_model", capture("jax"))
    monkeypatch.setattr(texport, "export_model", capture("torch"))
    jcli.main(argv)
    tcli.main(argv)
    assert calls["torch"] == calls["jax"]
    jax_flags = {"-m", "--model", "-e", "--export_path", "-n", "--max_instances", "--batch_size",
                 "--image_size", "-h", "--help"}
    flags = {s for a in tcli.make_parser()._actions for s in a.option_strings}
    assert flags == jax_flags | {"--cpu"}


def test_cli_exports_on_the_cpu(tmp_path, capsys):
    folder = str(RUNS / "minimal_robot.UNet.single_instance")
    out = str(tmp_path / "cli")
    tcli.main(["-m", folder, "-e", out, "--cpu", "--batch_size", "1", "--image_size", "96"])
    assert f"Exported to: {out}" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "model.pt2"))
    info = json.load(open(os.path.join(out, "info.json")))
    assert INFO_KEYS <= set(info) and info["input_shape"] == [1, 96, 96, 3]
    assert info["format"] == texport.FORMAT and info["device"] == "cpu"
    frames = _frames((1, 96, 96, 3), seed=5)
    pred = tp.load_model(folder, device="cpu", batch_size=1)
    _assert_program_is_predict(texport.load_exported_model(out)(frames), pred, frames)
