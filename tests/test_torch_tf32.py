"""TF32 off in the port's float32 paths, and the refusals of what is not
ported for the backbones other than the UNet.

- :func:`sleap_tpu_torch.precision.ieee_fp32` turns both TF32 flags off
  inside and gives the caller's back on exit, after an exception too, from
  every starting state; the predictors' ``predict``, the trainer's steps
  and ``evals.evaluate_model`` run inside it;
- ``cli.track.main`` and ``cli.train.main`` leave both flags off;
- the ``Trainer`` and a bf16 load refuse every backbone but the UNet with a
  ``NotImplementedError`` naming the ROADMAP item.
"""

import contextlib
import itertools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sleap_tpu_torch import config as c
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.models.model import OTHER_BACKBONES_ITEM, Model
from sleap_tpu_torch.models.params import flax_variables_from_state_dict
from sleap_tpu_torch.precision import disable_tf32, ieee_fp32

REPO = Path(__file__).resolve().parent.parent
CENTROID = str(REPO / ".convergence_runs" / "minimal_instance.UNet.centroid")
STATES = list(itertools.product([False, True], repeat=2))


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _set(flags):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.fixture(autouse=True)
def _keep_flags():
    saved = _flags()
    yield
    _set(saved)


@pytest.mark.parametrize("raises", [False, True])
@pytest.mark.parametrize("state", STATES)
def test_scope_restores_the_callers_flags(state, raises):
    _set(state)
    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with ieee_fp32():
            assert _flags() == (False, False)
            if raises:
                raise RuntimeError("inside")
    assert _flags() == state


@pytest.mark.parametrize("state", STATES)
def test_predict_runs_without_tf32_and_restores_the_flags(state, monkeypatch):
    pred = tp.load_model(CENTROID, device="cpu", peak_threshold=0.05, batch_size=2)
    seen = []
    infer = pred._infer
    monkeypatch.setattr(pred, "_infer", lambda *a: (seen.append(_flags()), infer(*a))[1])
    _set(state)
    frames = np.zeros((2, 64, 64, 1), np.uint8)
    pred.predict(frames)
    assert seen and all(f == (False, False) for f in seen)
    assert _flags() == state


def test_train_step_and_evaluate_model_run_without_tf32(monkeypatch):
    from sleap_tpu_torch import evals
    from sleap_tpu_torch.training.trainer import Trainer

    _set((True, True))
    seen = []
    module = torch.nn.Linear(2, 1)
    fake = types.SimpleNamespace(
        module=module, optimizer=torch.optim.SGD(module.parameters(), lr=0.1),
        compute_loss=lambda batch, gen: (seen.append(_flags()), module(batch).sum())[1])
    Trainer.train_step(fake, torch.ones(1, 2), None)
    Trainer.val_step(fake, torch.ones(1, 2), None)

    class _Pred:
        def predict(self, labels):
            seen.append(_flags())
            raise RuntimeError("stop")

    monkeypatch.setattr(tp.Predictor, "from_model_paths", classmethod(lambda cls, *a, **k: _Pred()))
    with pytest.raises(RuntimeError, match="stop"):
        evals.evaluate_model(None, evals.Labels(), "folder", save=False, device="cpu")
    assert seen == [(False, False)] * 3
    assert _flags() == (True, True)


def test_track_cli_leaves_tf32_off(tmp_path):
    from sleap_tpu_torch.cli import track

    _set((True, True))
    track.main([str(REPO / "tests" / "torch_data" / "raw.slp"), "-m", CENTROID, "--cpu",
                "--verbosity", "none", "--peak_threshold", "0.05", "--frames", "0",
                "-o", str(tmp_path / "out.slp")])
    assert (tmp_path / "out.slp").exists()
    assert _flags() == (False, False)


def test_train_cli_leaves_tf32_off(monkeypatch):
    from sleap_tpu_torch.cli import train

    _set((True, True))
    seen = []
    monkeypatch.setattr(train, "create_trainer_using_cli", lambda args: types.SimpleNamespace(
        train=lambda: seen.append(_flags())))
    train.main(["profile.json", "labels.slp"])
    assert seen == [(False, False)] and _flags() == (False, False)


def test_disable_tf32():
    _set((True, True))
    disable_tf32()
    assert _flags() == (False, False)


# --------------------------------------------------------------------------- #
# What the other backbones refuse
# --------------------------------------------------------------------------- #

BACKBONES = {
    "leap": lambda: c.LEAPConfig(max_stride=8, output_stride=2, filters=4),
    "hourglass": lambda: c.HourglassConfig(stem_stride=4, max_stride=16, output_stride=4,
                                           stem_filters=4, filters=4, filter_increase=4, stacks=1),
    "resnet": lambda: c.ResNetConfig(weights="random", max_stride=8, output_stride=8),
    "pretrained_encoder": lambda: c.PretrainedEncoderConfig(encoder="mobilenet", pretrained=False,
                                                            decoder_filters=4, output_stride=16),
    "hrnet": lambda: c.HRNetConfig(C=2, stem_filters=4, deconv_filters=4),
}


def _config(name):
    os_ = {"leap": 2, "hourglass": 4, "resnet": 8, "pretrained_encoder": 16, "hrnet": 2}[name]
    return c.TrainingJobConfig(model=c.ModelConfig(
        backbone=c.BackboneConfig(**{name: BACKBONES[name]()}),
        heads=c.HeadsConfig(single_instance=c.SingleInstanceConfmapsHeadConfig(
            part_names=["a", "b"], output_stride=os_))))


@pytest.mark.parametrize("name", list(BACKBONES))
def test_trainer_refuses_other_backbones(name):
    from sleap_tpu_torch.training.trainer import SingleInstanceTrainer

    cfg = _config(name)
    model = Model.from_config(cfg.model)
    with pytest.raises(NotImplementedError, match=OTHER_BACKBONES_ITEM):
        SingleInstanceTrainer(config=cfg, data_readers=None, model=model, device="cpu")


@pytest.mark.parametrize("name", list(BACKBONES))
def test_bf16_load_refuses_other_backbones(name, tmp_path):
    cfg = _config(name)
    cfg.save_json(str(tmp_path / "training_config.json"))
    net = Model.from_config(cfg.model).make_module(1)
    variables = flax_variables_from_state_dict(net)
    folder = str(tmp_path)
    with pytest.raises(NotImplementedError, match=OTHER_BACKBONES_ITEM):
        tp.load_trained_model(folder, device="cpu", params=variables, compute_dtype=torch.bfloat16)
    tm = tp.load_trained_model(folder, device="cpu", params=variables)  # float32 loads
    assert not tm.module.training
    assert tm.module.backbone.flax_name == ("backbone" if name in ("leap", "hourglass")
                                            else "backbone_module")
