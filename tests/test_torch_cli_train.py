"""The port's ``sleap-train`` (``sleap_tpu_torch.cli.train``) and
``sleap-inspect`` (``sleap_tpu_torch.info.labels``) against the JAX
package's, on the CPU.

- ``create_trainer_using_cli`` builds the same config (equal as JSON) as the
  JAX CLI for the same flags, profiles and run folders;
- ``--n-devices`` beyond the cards raises, and so does ``--spatial-sharding
  2`` with no cards (it needs two); ``--cpu --n-devices 2`` trains on two
  gloo ranks (spawned, or under ``torchrun``) into one run folder;
  ``--tensorboard`` and ``--zmq`` reach the trainer, which opens the ZMQ
  sockets on the flags' ports;
- ``main([... --cpu])`` trains a shipped profile at a tiny width for one
  epoch on ``tests/torch_data/pkg.slp`` and writes the whole run folder; the
  JAX package's ``evaluate`` of the folder's ``labels_gt``/``labels_pr``
  files, read by its own reader, gives the metrics the port saved (exact),
  and JAX's ``load_metrics`` reads them;
- the port's profiles are byte copies of the JAX package's;
- ``sleap-inspect`` prints the JAX module's lines, letter for letter;
- where the port departs from the JAX trainer on projects of several
  videos (ROADMAP.md, queue 3): the input channels come from all videos,
  and a mixed-size run records the size it matched frames to, which its
  predictors then use.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sleap_tpu import evals as jevals
from sleap_tpu.cli import train as jtrain
from sleap_tpu.info import labels as jinfo
from sleap_tpu.io.slp import read_labels as jread
from sleap_tpu_torch import load_metrics
from sleap_tpu_torch.cli import train as ttrain
from sleap_tpu_torch.info import labels as tinfo

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PROFILES = REPO / "sleap_tpu_torch" / "training_profiles"
JAX_PROFILES = REPO / "sleap_tpu" / "training_profiles"
PKG = str(REPO / "tests" / "torch_data" / "pkg.slp")
RAW = str(REPO / "tests" / "torch_data" / "raw.slp")
RUNS = REPO / ".convergence_runs"


def _config_json(trainer) -> dict:
    return json.loads(trainer.config.to_json())


@pytest.mark.parametrize("profile,flags", [
    ("baseline.centroid.json", []),
    ("baseline_medium_rf.topdown.json", ["--run_name", "r", "--prefix", "p_", "--suffix", "_s"]),
    ("baseline_large_rf.single.json", ["--val_labels", RAW, "--test_labels", RAW]),
    ("baseline_medium_rf.bottomup.json", ["--mixed-precision", "--cpu", "--save_viz"]),
    ("baseline_large_rf.topdown.json", ["--tensorboard", "--zmq", "--controller_port", "7000",
                                        "--publish_port", "7001"]),
    ("baseline_medium_rf.single.json", ["--base_checkpoint", "some/run", "--n-devices", "1",
                                        "--spatial-sharding", "1"]),
    (str(RUNS / "minimal_instance.UNet.centroid"), ["--run_name", "again"]),
])
def test_cli_builds_the_jax_config(profile, flags):
    path = profile if profile.startswith("/") else str(PROFILES / profile)
    args = [path, PKG, *flags]
    got = ttrain.create_trainer_using_cli(args)
    want = jtrain.create_trainer_using_cli(args)
    assert _config_json(got) == _config_json(want)
    assert type(got).__name__ == type(want).__name__
    assert got.device == torch.device("cpu" if "--cpu" in flags else "cuda")


@pytest.mark.parametrize("flags", [["--n-devices", str(max(2, torch.cuda.device_count() + 1))],
                                   ["--spatial-sharding", "2"]])
def test_multi_card_flags_raise(flags):
    """More cards than there are (none here) raises; so does spatial
    sharding, whose bands go on as many cards (``--n-devices`` defaults to
    ``--spatial-sharding``)."""
    with pytest.raises((RuntimeError, ValueError), match="No CUDA device|available"):
        ttrain.create_trainer_using_cli([str(PROFILES / "baseline.centroid.json"), PKG, *flags])


def _tiny_centroid_profile(tmp_path) -> str:
    profile = json.loads((PROFILES / "baseline.centroid.json").read_text())
    profile["model"]["backbone"]["unet"]["filters"] = 4
    profile["optimization"].update({"epochs": 1, "batches_per_epoch": 2, "val_batches_per_epoch": 1,
                                    "batch_size": 3})
    profile["outputs"]["runs_folder"] = str(tmp_path / "models")
    path = tmp_path / "profile.json"
    path.write_text(json.dumps(profile))
    return str(path)


def _assert_one_scored_run_folder(tmp_path, name):
    assert sorted(p.name for p in (tmp_path / "models").iterdir()) == [name]
    folder = tmp_path / "models" / name
    assert {"best_model.pt", "training_config.json", "training_log.csv", "metrics.val.npz",
            "labels_pr.val.slp"} <= {p.name for p in folder.iterdir()}
    assert load_metrics(str(folder), split="val")
    return folder


def test_n_devices_trains_on_two_cpu_ranks(tmp_path):
    """``sleap-train --cpu --n-devices 2`` spawns a second gloo rank and
    writes one run folder, scored as a one-device run's is."""
    ttrain.main([_tiny_centroid_profile(tmp_path), PKG, "--cpu", "--n-devices", "2", "--run_name", "dp"])
    _assert_one_scored_run_folder(tmp_path, "dp")


def test_n_devices_joins_the_group_under_torchrun(tmp_path):
    """Under ``torchrun`` (``python -m torch.distributed.run``) each of the
    two processes joins the group as one rank, and only rank 0 writes the
    run folder; the log holds the losses both ranks agreed on."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr",
         "127.0.0.1", "--master-port", str(port), "-m", "sleap_tpu_torch.cli.train",
         _tiny_centroid_profile(tmp_path), PKG, "--cpu", "--n-devices", "2", "--run_name", "tr"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "rank 1 of 2" in done.stderr and "rank 0 of 2" in done.stderr
    folder = _assert_one_scored_run_folder(tmp_path, "tr")
    assert len((folder / "training_log.csv").read_text().splitlines()) == 2


def test_tensorboard_flag_reaches_the_trainers_refusal(tmp_path):
    """``--tensorboard`` reaches the trainer, which now writes the logs
    (``tests/test_torch_trainer_tensorboard.py``); ``--zmq`` reaches it too,
    which no longer refuses it: ``setup`` binds the progress socket on
    ``--publish_port`` and connects the controller on ``--controller_port``
    (training with them: ``tests/test_torch_callbacks.py``)."""
    zmq = pytest.importorskip("zmq")
    profile = str(PROFILES / "baseline.centroid.json")
    trainer = ttrain.create_trainer_using_cli([profile, PKG, "--cpu", "--tensorboard"])
    assert trainer.config.outputs.tensorboard.write_logs
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    trainer = ttrain.create_trainer_using_cli([
        profile, PKG, "--cpu", "--zmq", "--controller_port", str(ports[0]), "--publish_port", str(ports[1])])
    zmq_cfg = trainer.config.outputs.zmq
    assert zmq_cfg.publish_updates and zmq_cfg.subscribe_to_controller
    assert zmq_cfg.publish_address == f"tcp://127.0.0.1:{ports[1]}"
    trainer.config.outputs.save_outputs = False
    trainer.setup()
    try:
        assert trainer._zmq_controller.socket.getsockopt_string(zmq.LAST_ENDPOINT) == \
            f"tcp://127.0.0.1:{ports[0]}"
        assert trainer._zmq_reporter.socket.getsockopt_string(zmq.LAST_ENDPOINT) == \
            f"tcp://127.0.0.1:{ports[1]}"
    finally:
        trainer._zmq_reporter.close()
        trainer._zmq_controller.close()


@pytest.mark.parametrize("name", sorted(p.name for p in JAX_PROFILES.glob("*.json")))
def test_profiles_are_copies_of_the_jax_ones(name):
    assert (PROFILES / name).read_bytes() == (JAX_PROFILES / name).read_bytes()
    assert sorted(p.name for p in PROFILES.glob("*.json")) == \
        sorted(p.name for p in JAX_PROFILES.glob("*.json"))


@pytest.fixture(scope="module")
def run_folder(tmp_path_factory):
    """The shipped top-down instance profile at filters 4, one epoch of two
    batches, trained on the CPU through ``main``."""
    tmp = tmp_path_factory.mktemp("cli_train")
    cfg = json.loads((PROFILES / "baseline_medium_rf.topdown.json").read_text())
    cfg["model"]["backbone"]["unet"]["filters"] = 4
    cfg["optimization"].update(epochs=1, batches_per_epoch=2, val_batches_per_epoch=1)
    cfg["outputs"]["runs_folder"] = str(tmp)
    profile = tmp / "tiny.json"
    profile.write_text(json.dumps(cfg))
    ttrain.main([str(profile), PKG, "--cpu", "--run_name", "tiny"])
    return tmp / "tiny"


def test_cli_writes_the_whole_run_folder(run_folder):
    files = {p.name for p in run_folder.iterdir()}
    assert {"best_model.pt", "initial_config.json", "training_config.json", "training_log.csv",
            "labels_gt.train.slp", "labels_gt.val.slp", "labels_pr.train.slp",
            "labels_pr.val.slp", "metrics.train.npz", "metrics.val.npz"} <= files


@pytest.mark.parametrize("split", ["train", "val"])
def test_jax_scores_the_ports_files_alike(run_folder, split):
    gt = jread(str(run_folder / f"labels_gt.{split}.slp"))
    pr = jread(str(run_folder / f"labels_pr.{split}.slp"))
    assert len(gt) and len(pr) == len(gt)
    want = jevals.evaluate(gt, pr)
    got = load_metrics(str(run_folder), split=split)
    also = jevals.load_metrics(str(run_folder), split=split)
    assert sorted(got) == sorted(want) == sorted(also)
    for key in want:
        for value in (got[key], also[key]):
            assert type(value).__name__ == type(want[key]).__name__, key
            if isinstance(want[key], np.ndarray) or np.isscalar(want[key]):
                np.testing.assert_array_equal(value, want[key], err_msg=key)
            else:
                assert value == want[key], key


def _printed(capsys, fn, *args, **kwargs) -> str:
    fn(*args, **kwargs)
    return capsys.readouterr().out


@pytest.mark.parametrize("what", ["run_folder", "config", "labels", "predictions"])
def test_inspect_prints_the_jax_lines(run_folder, what, capsys):
    path = {
        "run_folder": str(run_folder),
        "config": str(run_folder / "training_config.json"),
        "labels": PKG,
        "predictions": str(run_folder / "labels_pr.val.slp"),
    }[what]
    for args in ([path], [path, "--verbose"]):
        got = _printed(capsys, tinfo.main, args)
        assert got and got == _printed(capsys, jinfo.main, args)
    if what == "run_folder":
        assert "  epochs trained: 1" in got and "  head: centered_instance" in got


@pytest.mark.parametrize("channels", [(1, 1), (3, 3), (1, 3)])
def test_trainer_takes_the_channels_of_several_videos(channels):
    """A project of several videos trains on their common channel count
    (the JAX trainer reads ``labels.video``, which raises for two videos);
    videos that differ in channels raise, asking for a conversion."""
    from sleap_tpu_torch.config import TrainingJobConfig
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.core.skeleton import Skeleton
    from sleap_tpu_torch.io.video import Video
    from sleap_tpu_torch.training.trainer import Trainer

    skeleton = Skeleton("pair")
    skeleton.add_node("a")
    skeleton.add_node("b")
    lfs = []
    for k, c in enumerate(channels):
        video = Video.from_numpy(np.zeros((2, 32 + 16 * k, 32, c), np.uint8))
        lfs += [LabeledFrame(video, i, [Instance(skeleton, np.array([[8.0, 8.0], [12.0, 9.0]]))])
                for i in range(2)]
    cfg = TrainingJobConfig.load_json(str(PROFILES / "baseline.centroid.json"))
    trainer = Trainer.from_config(cfg, training_labels=Labels(lfs), validation_labels=Labels(lfs),
                                  device="cpu")
    if len(set(channels)) > 1:
        with pytest.raises(ValueError, match="differ in channels"):
            trainer._image_channels()
    else:
        assert trainer._image_channels() == channels[0]


def test_mixed_size_run_records_its_target_and_inference_uses_it(tmp_path):
    """A project of a 64^2 and a 48^2 video trains with frames matched to
    64^2, and the run records that size (``target_height``/``target_width``,
    as upstream SLEAP does; the JAX trainer leaves them unset), so that
    labels of the small video alone, such as a validation split without the
    large one, are predicted at the scale the model trained at: equal to
    the same frames predicted within the whole project."""
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.core.skeleton import Skeleton
    from sleap_tpu_torch.inference.predictors import load_model
    from sleap_tpu_torch.io.slp import write_labels
    from sleap_tpu_torch.io.video import Video

    rng = np.random.default_rng(0)
    skeleton = Skeleton("pair")
    skeleton.add_node("a")
    skeleton.add_node("b")
    lfs = []
    for size in (64, 48):
        video = Video.from_numpy(rng.integers(0, 255, (3, size, size, 1), np.uint8))
        lfs += [LabeledFrame(video, i, [Instance(skeleton, rng.uniform(12, size - 12, (2, 2)))])
                for i in range(3)]
    project = str(tmp_path / "two_sizes.slp")
    write_labels(project, Labels(lfs))
    cfg = json.loads((PROFILES / "baseline_medium_rf.topdown.json").read_text())
    cfg["model"]["backbone"]["unet"]["filters"] = 4
    cfg["optimization"].update(epochs=1, batches_per_epoch=1, val_batches_per_epoch=1)
    cfg["outputs"]["runs_folder"] = str(tmp_path)
    (tmp_path / "p.json").write_text(json.dumps(cfg))
    ttrain.main([str(tmp_path / "p.json"), project, "--cpu", "--run_name", "mixed"])
    folder = tmp_path / "mixed"
    pp = json.loads((folder / "training_config.json").read_text())["data"]["preprocessing"]
    assert (pp["target_height"], pp["target_width"]) == (64, 64)

    from sleap_tpu_torch.io.slp import read_labels

    labels = read_labels(project)
    small = Labels([lf for lf in labels if lf.video.shape[1] == 48])
    pred = load_model(str(folder), device="cpu", peak_threshold=0.0, batch_size=2)
    assert pred.confmap_model.target_hw == (64, 64)
    whole = {lf.frame_idx: lf for lf in pred.predict(labels) if lf.video.shape[1] == 48}
    for lf in pred.predict(small):
        want = whole[lf.frame_idx]
        np.testing.assert_allclose(np.stack([i.numpy() for i in lf.instances]),
                                   np.stack([i.numpy() for i in want.instances]), atol=1e-5)
