"""The port's ``sleap-track`` (``sleap_tpu_torch.cli.track.main``) against
the JAX package's on the committed ``.slp`` fixtures, both on the CPU: the
trained ``minimal_instance`` top-down pair with and without flow tracking
and over two replicas (``--n-devices 2``), the single-model modes, frame
selection, empty-frame removal, the
tracking-only branch and the output-path rules. Outputs are compared through
the JAX package's ``read_labels``.

Tolerances, those of ``test_torch_topdown.py``: points within 0.01 px,
instance and point scores within 1e-4 (f32 convs sum in another order in
each framework); frames, instance counts and track names equal. Tracking
scores are held to 1e-4 as well: ``test_torch_tracking.py`` holds them to
1e-5 on the same instances, but here the trackers' inputs, the predicted
points, already differ within the point tolerance.
"""

from __future__ import annotations

import csv
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sleap_tpu.cli import track as jtrack
from sleap_tpu.io.slp import read_labels as jread
from sleap_tpu_torch.cli import track as ttrack
from sleap_tpu_torch.io.slp import read_labels as tread

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RUNS = REPO / ".convergence_runs"
CENTROID = str(RUNS / "minimal_instance.UNet.centroid")
INSTANCE = str(RUNS / "minimal_instance.UNet.centered_instance")
RAW = REPO / "tests" / "torch_data" / "raw.slp"
PKG = REPO / "tests" / "torch_data" / "pkg.slp"
PAIR = ["-m", CENTROID, "-m", INSTANCE]
# The trained models' maps peak below the default threshold of 0.2 on these
# synthetic blobs (chip_smoke.py phase 4g drives them at 0.05 too).
QUIET = ["--cpu", "--verbosity", "none", "--peak_threshold", "0.05"]
PT_TOL, VAL_TOL, TRACK_SCORE_TOL = 0.01, 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    """Full-f32 matmuls and convs on the JAX side, for this file only."""
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture
def data(tmp_path):
    """Copies of the fixtures in a fresh directory (outputs land beside them)."""
    for src in (RAW, PKG):
        shutil.copy(src, tmp_path / src.name)
    return tmp_path


def run_both(args, tmp_path, name):
    """Run both CLIs with ``-o`` paths of their own; return the two output
    paths."""
    outs = []
    for tag, main in (("jax", jtrack.main), ("port", ttrack.main)):
        out = str(tmp_path / f"{name}.{tag}.slp")
        main([*args, "-o", out])
        outs.append(out)
    return outs


def assert_same_predictions(port_path, jax_path, tracked=False):
    mine, ref = jread(port_path), jread(jax_path)
    assert [lf.frame_idx for lf in mine.labeled_frames] == [lf.frame_idx for lf in ref.labeled_frames]
    for a, b in zip(mine.labeled_frames, ref.labeled_frames):
        assert len(a.instances) == len(b.instances), a.frame_idx
        for x, y in zip(a.instances, b.instances):
            assert type(x).__name__ == type(y).__name__
            np.testing.assert_allclose(np.nan_to_num(x.numpy()), np.nan_to_num(y.numpy()), atol=PT_TOL,
                                       rtol=0)
            assert np.array_equal(np.isnan(x.numpy()), np.isnan(y.numpy()))
            if x.predicted:
                assert abs(x.score - y.score) <= VAL_TOL
                np.testing.assert_allclose(x.points["score"], y.points["score"], atol=VAL_TOL)
            assert (x.track and x.track.name) == (y.track and y.track.name)
            if tracked:
                assert abs(x.tracking_score - y.tracking_score) <= TRACK_SCORE_TOL
    return mine


@pytest.mark.parametrize("tracker", [None, "flow"])
def test_topdown_pair_matches_jax(data, tracker):
    extra = ["--tracking.tracker", tracker] if tracker else []
    port, ref = run_both([str(data / "raw.slp"), *PAIR, *QUIET, *extra], data, f"pair-{tracker}")
    labels = assert_same_predictions(port, ref, tracked=bool(tracker))
    assert len(labels) == 8 and all(lf.instances for lf in labels)
    if tracker:
        assert all(i.track is not None for lf in labels for i in lf.instances)
    provenance = tread(port).provenance
    assert provenance["predictor"] == "TopDownPredictor"
    assert provenance["model_paths"] == [CENTROID, INSTANCE]
    assert provenance["args"]["cpu"] is True and provenance["output_path"] == port


def test_n_devices_matches_jax(data):
    """``--n-devices 2``: each batch split over two replicas (the CPU twice;
    JAX: two of its virtual CPU devices), each at ``--batch_size``."""
    port, ref = run_both([str(data / "pkg.slp"), *PAIR, *QUIET, "--n-devices", "2", "--batch_size", "2"],
                         data, "n-devices")
    labels = assert_same_predictions(port, ref)
    assert len(labels) == 8 and all(lf.instances for lf in labels)
    assert tread(port).provenance["args"]["n_devices"] == 2


def test_ground_truth_centroid_mode_matches_jax(data):
    port, ref = run_both([str(data / "raw.slp"), "-m", INSTANCE, *QUIET], data, "gt")
    labels = assert_same_predictions(port, ref)
    users = tread(str(data / "raw.slp"))
    assert [len(lf.instances) for lf in labels] == [len(lf.user_instances) for lf in users]
    assert all(i.score == 1.0 for lf in labels for i in lf.instances)


def test_centroid_only_mode_matches_jax(data):
    port, ref = run_both([str(data / "pkg.slp"), "-m", CENTROID, *QUIET], data, "centroid")
    labels = assert_same_predictions(port, ref)
    users = tread(str(data / "pkg.slp"))
    user_points = {tuple(np.round(i.numpy().ravel(), 6)) for lf in users for i in lf.instances}
    got = [tuple(np.round(i.numpy().ravel(), 6)) for lf in labels for i in lf.instances]
    assert got and set(got) <= user_points


def test_frame_selection_matches_jax(data):
    port, ref = run_both([str(data / "pkg.slp"), *PAIR, *QUIET, "--frames", "1-3,6"], data, "frames")
    labels = assert_same_predictions(port, ref)
    assert [lf.frame_idx for lf in labels] == [1, 2, 3, 6]


def test_only_labeled_and_no_empty_frames_match_jax(data):
    from sleap_tpu_torch.core.labels import load_file

    labels = load_file(str(data / "raw.slp"))
    for i in (2, 5):
        labels[i].instances = []
    path = str(data / "partly.slp")
    labels.save(path)
    args = [path, *PAIR, *QUIET, "--only-labeled-frames", "--no-empty-frames",
            "--peak_threshold", "0.3"]
    port, ref = run_both(args, data, "labeled")
    out = assert_same_predictions(port, ref)
    assert len(out) < 6 and {lf.frame_idx for lf in out} <= {0, 1, 3, 4, 6, 7}


def test_tracking_only_branch_matches_jax(data):
    port_pred, jax_pred = run_both([str(data / "raw.slp"), *PAIR, *QUIET], data, "untracked")
    outs = []
    for main, src in ((jtrack.main, jax_pred), (ttrack.main, port_pred)):
        main([src, "--tracking.tracker", "flow", *QUIET])
        outs.append(f"{src}.FlowCandidateMaker.instance_similarity.greedy_matching.slp")
    labels = assert_same_predictions(outs[1], outs[0], tracked=True)
    assert all(i.track is not None for lf in labels for i in lf.instances)


def test_output_path_rules_match_jax(tmp_path):
    """Default output beside the input; ``-o`` as a directory for several
    inputs (a txt list, a csv with an output column); ``.slp`` files skipped
    among several inputs; an unwritable ``-o`` falls back to the default."""
    made = {}
    for tag, main in (("jax", jtrack.main), ("port", ttrack.main)):
        root = tmp_path / tag
        root.mkdir()
        shutil.copy(RAW, root / "one.slp")
        for name in ("a.h5", "b.h5", "c.slp"):
            shutil.copy(RAW, root / name)
        short = [*PAIR, *QUIET, "--frames", "0-1"]
        main([str(root / "one.slp"), *short])
        (root / "list.txt").write_text(f"{root / 'a.h5'}\n{root / 'b.h5'}\n{root / 'c.slp'}\n")
        main([str(root / "list.txt"), *short, "--video.dataset", "video0_raw", "-o", str(root / "outdir")])
        with open(root / "list.csv", "w", newline="") as f:
            csv.writer(f).writerows([["data", "out"], [str(root / "a.h5"), str(root / "csv_a.slp")]])
        main([str(root / "list.csv"), *short, "--video.dataset", "video0_raw"])
        (root / "blocker").write_text("a file where a directory should be")
        main([str(root / "one.slp"), *PAIR, *QUIET, "--frames", "0", "-o",
              str(root / "blocker" / "x.slp")])
        made[tag] = sorted(str(p.relative_to(root)) for p in root.rglob("*.slp"))
    assert made["port"] == made["jax"]
    assert "one.predictions.slp" in made["port"] and "csv_a.slp" in made["port"]
    assert "outdir/a.predictions.slp" in made["port"] and "outdir/c.predictions.slp" not in made["port"]
    assert_same_predictions(str(tmp_path / "port" / "outdir" / "b.predictions.slp"),
                            str(tmp_path / "jax" / "outdir" / "b.predictions.slp"))


def test_port_only_flags(data):
    # More cards than there are (none here): refused before any model loads.
    n = str(max(2, torch.cuda.device_count() + 1))
    with pytest.raises((RuntimeError, ValueError), match="No CUDA device|available"):
        ttrack.main([str(data / "raw.slp"), *PAIR, "--verbosity", "none", "--n-devices", n])
    with pytest.raises(ValueError, match="at least one model"):
        ttrack.main([str(data / "raw.slp"), *QUIET])
    with pytest.raises(ValueError, match="does not exist"):
        ttrack.main([str(data / "missing.slp"), *PAIR, *QUIET])
    ns = ttrack.make_parser().parse_args([str(data / "raw.slp"), *PAIR, "--compute_dtype", "bfloat16",
                                          "--cpu"])
    pred = ttrack.make_predictor_from_cli(ns)
    assert pred.device == torch.device("cpu")
    assert next(pred.centroid_model.module.parameters()).dtype == torch.bfloat16
    assert ttrack.parse_frames("1-3,7") == [1, 2, 3, 7] and ttrack.parse_frames("") is None
