"""TF32 off in the port's float32 paths, on every backbone.

- :func:`sleap_tpu_torch.precision.ieee_fp32` turns both TF32 flags off
  inside and gives the caller's back on exit, after an exception too, from
  every starting state; the predictors' ``predict``, the trainer's steps
  and ``evals.evaluate_model`` run inside it;
- ``cli.track.main`` and ``cli.train.main`` leave both flags off;
- the ``Trainer`` steps every backbone but the UNet with TF32 off, batch
  norm moving its statistics; a bf16 load of each predicts, its batch norm
  float32. (The two tests keep the names they had when these backbones
  were refused.)
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
from sleap_tpu_torch.models.encoder_decoder import FlaxBatchNorm2d
from sleap_tpu_torch.models.model import Model
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
# The other backbones train and run in bf16
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


def _labels(n=2, size=64):
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.core.skeleton import Skeleton
    from sleap_tpu_torch.io.video import Video

    rng = np.random.default_rng(0)
    skeleton = Skeleton("pair")
    for node in ("a", "b"):
        skeleton.add_node(node)
    video = Video.from_numpy(rng.integers(0, 255, (n, size, size, 1), np.uint8))
    return Labels([LabeledFrame(video, i, [Instance(skeleton, rng.uniform(8, size - 8, (2, 2)))])
                   for i in range(n)])


@pytest.mark.parametrize("name", list(BACKBONES))
def test_trainer_refuses_other_backbones(name):
    """Once a refusal, now the working path: the trainer of each backbone
    takes a train step with TF32 off inside and the caller's flags back
    after, with a finite loss, and its batch norm moves its statistics."""
    from sleap_tpu_torch.training.trainer import SingleInstanceTrainer, Trainer

    cfg = _config(name)
    cfg.optimization.batch_size = 2
    cfg.outputs.save_outputs = False
    labels = _labels()
    trainer = Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                  device="cpu")
    assert isinstance(trainer, SingleInstanceTrainer)
    trainer.setup()
    trainer.make_optimizer()
    seen = []
    hook = trainer.module.register_forward_pre_hook(lambda m, args: seen.append(_flags()))
    bns = [m for m in trainer.module.modules() if isinstance(m, FlaxBatchNorm2d)]
    before = [m.running_mean.clone() for m in bns]
    _set((True, True))
    batch = trainer.to_device(trainer.make_batch(trainer._train_examples[:2], None))
    loss = trainer.train_step(batch, torch.Generator().manual_seed(0))
    hook.remove()
    assert seen == [(False, False)] and _flags() == (True, True)
    assert torch.isfinite(loss)
    assert bool(bns) == (name != "leap")
    assert all(not torch.equal(m.running_mean, b) for m, b in zip(bns, before))


@pytest.mark.parametrize("name", list(BACKBONES))
def test_bf16_load_refuses_other_backbones(name, tmp_path):
    """Once a refusal, now the working path: a bf16 load of each backbone
    keeps its batch norm float32 and everything else bf16, gives maps
    within 5% of the float32 load's largest value (bf16 weights and
    activations), and predicts the float32 load's shapes."""
    cfg = _config(name)
    cfg.save_json(str(tmp_path / "training_config.json"))
    net = Model.from_config(cfg.model).make_module(1)
    variables = flax_variables_from_state_dict(net)
    folder = str(tmp_path)
    tm = tp.load_trained_model(folder, device="cpu", params=variables, compute_dtype=torch.bfloat16)
    assert not tm.module.training
    for mod in tm.module.modules():
        want = torch.float32 if isinstance(mod, FlaxBatchNorm2d) else torch.bfloat16
        assert all(p.dtype == want for p in mod.parameters(recurse=False)), mod
    frames = np.random.default_rng(1).integers(0, 255, (2, 64, 64, 1), np.uint8)
    f32 = tp.load_trained_model(folder, device="cpu", params=variables)  # float32 loads
    with torch.no_grad():
        maps = [m(torch.from_numpy(frames)) for m in (f32.module, tm.module)]
    for key, want in maps[0].items():
        got = maps[1][key]
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert float((got.float() - want).abs().max()) <= 0.05 * float(want.abs().max()), key
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        pred = tp.load_model(folder, device="cpu", params={folder: variables}, compute_dtype=dtype,
                             peak_threshold=0.0, batch_size=2)
        out[dtype] = pred.predict(frames, make_labels=False)[0]
    for key in ("instance_peaks", "instance_peak_vals"):
        assert out[torch.bfloat16][key].shape == out[torch.float32][key].shape
    tm = f32
    assert not tm.module.training
    assert tm.module.backbone.flax_name == ("backbone" if name in ("leap", "hourglass")
                                            else "backbone_module")
