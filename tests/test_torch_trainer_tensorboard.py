"""TensorBoard logs and the first epoch's profile in the port's trainer,
against the JAX trainer, on the CPU (``outputs.tensorboard.write_logs`` and
``profile_graph``).

Each package trains the same config (test_torch_training.py's centroid
model, 2 epochs) with neither flag, with both, and with ``write_logs`` where
``tensorboard`` cannot be imported. The flags change no loss in either
package: the losses of each package's runs are equal. The files they add to
the run folder are the same in both: ``events.out.tfevents.*`` holding
``loss``, ``val_loss`` and ``lr`` each epoch (the port's equal its
``training_log.csv``), and a non-empty ``profile`` folder (a ``torch.profiler``
trace in the port, a JAX profiler trace in the JAX package). Without
``tensorboard`` both log the same warning and train on.
"""

import csv
import logging
import os
import sys

import numpy as np
import pytest

from sleap_tpu.config import TrainingJobConfig as JaxConfig
from sleap_tpu.training.trainer import Trainer as JaxTrainer
from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.training import trainer as tt
from test_torch_training import _config_json, _labels_pair

WARNING = "TensorBoard logging requested but unavailable."


def _train(package, root, name, write_logs=False, profile_graph=False):
    labels, jlabels = _labels_pair(n_frames=6)
    text = _config_json("centroid", epochs=2, batches_per_epoch=2, val_batches_per_epoch=1)
    if package == "torch":
        cfg = TrainingJobConfig.from_json(text)
    else:
        cfg = JaxConfig.from_json(text)
    cfg.outputs.save_outputs = True
    cfg.outputs.runs_folder = str(root / package)
    cfg.outputs.run_name = name
    cfg.outputs.tensorboard.write_logs = write_logs
    cfg.outputs.tensorboard.profile_graph = profile_graph
    if package == "torch":
        trainer = tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                         device="cpu")
    else:
        trainer = JaxTrainer.from_config(cfg, training_labels=jlabels, validation_labels=jlabels)
    trainer.train()
    folder = root / package / name
    with open(folder / "training_log.csv") as f:
        losses = [(float(r["loss"]), float(r["val_loss"])) for r in csv.DictReader(f)]
    return folder, losses


def _scalars(folder):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(folder))
    acc.Reload()
    return {tag: [e.value for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tb")
    return {package: {"plain": _train(package, root, "plain"),
                      "flags": _train(package, root, "flags", True, True)}
            for package in ("torch", "jax")}


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_flags_change_no_loss(runs, package):
    assert runs[package]["flags"][1] == runs[package]["plain"][1]


def test_flags_add_the_same_files_in_both_packages(runs):
    added = {}
    for package, by_name in runs.items():
        plain = set(os.listdir(by_name["plain"][0]))
        files = set(os.listdir(by_name["flags"][0])) - plain
        added[package] = {"events" if f.startswith("events.out.tfevents.") else f for f in files}
        profile = by_name["flags"][0] / "profile"
        assert any(files for _, _, files in os.walk(profile)), f"{package}: an empty profile"
    assert added["torch"] == added["jax"] == {"events", "profile"}


def test_logged_scalars_match_the_training_log(runs):
    got = _scalars(runs["torch"]["flags"][0])
    want = _scalars(runs["jax"]["flags"][0])
    assert sorted(got) == sorted(want) == ["loss", "lr", "val_loss"]
    assert all(len(v) == 2 for v in (*got.values(), *want.values()))
    losses = runs["torch"]["flags"][1]
    np.testing.assert_allclose(got["loss"], [loss for loss, _ in losses], rtol=1e-6)
    np.testing.assert_allclose(got["val_loss"], [val for _, val in losses], rtol=1e-6)
    assert got["lr"] == want["lr"]


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_missing_tensorboard_warns_and_trains(package, tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import raises
    with caplog.at_level(logging.WARNING):
        folder, losses = _train(package, tmp_path, "no_tb", write_logs=True)
    assert WARNING in caplog.text
    assert len(losses) == 2 and not any(f.startswith("events.") for f in os.listdir(folder))
