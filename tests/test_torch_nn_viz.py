"""The port's matplotlib drawings (``sleap_tpu_torch.nn_viz``) and the
trainer's visualizations against the JAX package's, on the CPU:

- ``generate_skeleton_preview_image`` gives the same PNG bytes as JAX's for
  the same instance (the port's ``Instance``, or its points as a tensor with
  the skeleton);
- each ``plot_*`` draws the same artists with the same data (lines' points,
  images' pixels and extents, quivers' offsets and vectors) as JAX's, from
  numpy arrays or torch tensors;
- with ``save_visualizations`` the trainer writes ``viz/epoch_NNN.png`` each
  epoch, as JAX's does, removed at the end unless ``keep_viz_images``; the
  drawing moves no random stream, so the losses equal a run without it; and
  without matplotlib it trains on and draws nothing, as JAX's does.
"""

import csv
import logging
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from sleap_tpu import nn_viz as jviz  # noqa: E402
from sleap_tpu.config import TrainingJobConfig as JaxConfig  # noqa: E402
from sleap_tpu.core.instance import Instance as JaxInstance  # noqa: E402
from sleap_tpu.core.skeleton import Skeleton as JaxSkeleton  # noqa: E402
from sleap_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from sleap_tpu_torch import nn_viz  # noqa: E402
from sleap_tpu_torch.config import TrainingJobConfig  # noqa: E402
from sleap_tpu_torch.core.instance import Instance  # noqa: E402
from sleap_tpu_torch.core.skeleton import Skeleton  # noqa: E402
from sleap_tpu_torch.training import trainer as tt  # noqa: E402
from test_torch_training import _config_json, _labels_pair  # noqa: E402


def _instances(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(5, 60, (4, 2))
    pts[2] = np.nan
    out = []
    for skel_cls, inst_cls in ((Skeleton, Instance), (JaxSkeleton, JaxInstance)):
        skel = skel_cls.from_names_and_edge_inds(["a", "b", "c", "d"], [(0, 1), (1, 2), (2, 3), (0, 3)])
        out.append(inst_cls(skeleton=skel, points=pts))
    return out, pts


def test_skeleton_preview_bytes_match_jax():
    (inst, jinst), pts = _instances()
    want = jviz.generate_skeleton_preview_image(jinst)
    assert want[:8] == b"\x89PNG\r\n\x1a\n"
    assert nn_viz.generate_skeleton_preview_image(inst) == want
    assert nn_viz.generate_skeleton_preview_image(inst, box_size=64) == \
        jviz.generate_skeleton_preview_image(jinst, box_size=64)


def _artists(draw):
    """The data of every artist ``draw`` adds to a fresh figure."""
    fig = plt.figure()
    try:
        ax = fig.add_subplot()
        draw()
        out = []
        for line in ax.lines:
            out.append(("line", np.asarray(line.get_xydata()), line.get_linestyle(), line.get_marker(),
                        line.get_color(), line.get_markersize(), line.get_alpha()))
        for img in ax.images:
            out.append(("image", np.asarray(img.get_array()), tuple(img.get_extent())))
        for coll in ax.collections:
            out.append(("quiver", np.asarray(coll.get_offsets()), np.asarray(coll.U), np.asarray(coll.V)))
        return out
    finally:
        plt.close(fig)


def _assert_same_artists(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(np.asarray(a), b)
            else:
                assert a == b


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plots_draw_what_jax_draws(as_tensor):
    rng = np.random.default_rng(1)
    cms = rng.random((16, 20, 3)).astype(np.float32)
    pafs = rng.normal(size=(16, 20, 4)).astype(np.float32)
    gt, pr = rng.uniform(0, 20, (3, 2)), rng.uniform(0, 20, (3, 2))
    (inst, jinst), pts = _instances(2)
    wrap = (lambda a: torch.from_numpy(np.asarray(a))) if as_tensor else (lambda a: a)
    cases = [
        (lambda: nn_viz.plot_confmaps(wrap(cms), output_scale=0.5), lambda: jviz.plot_confmaps(cms, output_scale=0.5)),
        (lambda: nn_viz.plot_peaks(wrap(gt), wrap(pr), paired=True), lambda: jviz.plot_peaks(gt, pr, paired=True)),
        (lambda: nn_viz.plot_peaks(pts_gt=wrap(gt)), lambda: jviz.plot_peaks(pts_gt=gt)),
        (lambda: nn_viz.plot_pafs(wrap(pafs), stride=2), lambda: jviz.plot_pafs(pafs, stride=2)),
        (lambda: nn_viz.plot_instance(inst, color="r"), lambda: jviz.plot_instance(jinst, color="r")),
        (lambda: nn_viz.plot_instance(wrap(pts), skeleton=inst.skeleton),
         lambda: jviz.plot_instance(pts, skeleton=jinst.skeleton)),
        (lambda: nn_viz.plot_instances([inst, inst]), lambda: jviz.plot_instances([jinst, jinst])),
    ]
    for draw, jdraw in cases:
        _assert_same_artists(_artists(draw), _artists(jdraw))


@pytest.mark.parametrize("shape", [(12, 10), (12, 10, 1), (12, 10, 3)])
def test_plot_img_matches_jax(shape):
    img = np.random.default_rng(3).random(shape).astype(np.float32)
    for dpi, scale in ((72, 1.0), (36, 2.0)):
        fig, jfig = nn_viz.plot_img(torch.from_numpy(img), dpi=dpi, scale=scale), jviz.plot_img(img, dpi=dpi, scale=scale)
        try:
            assert tuple(fig.get_size_inches()) == tuple(jfig.get_size_inches()) and fig.dpi == jfig.dpi
            (im,), (jim,) = fig.axes[0].images, jfig.axes[0].images
            np.testing.assert_array_equal(im.get_array(), jim.get_array())
            assert im.get_extent() == jim.get_extent() and im.get_cmap().name == jim.get_cmap().name
        finally:
            plt.close(fig)
            plt.close(jfig)
    fig, jfig = nn_viz.imgfig((3, 2), dpi=50), jviz.imgfig((3, 2), dpi=50)
    assert tuple(fig.get_size_inches()) == tuple(jfig.get_size_inches()) == (3.0, 2.0)
    plt.close(fig)
    plt.close(jfig)


def _train(package, root, name, save_viz=True, keep=True, monkeypatch=None):
    labels, jlabels = _labels_pair(n_frames=6)
    text = _config_json("centroid", epochs=2, batches_per_epoch=2, val_batches_per_epoch=1)
    cfg = (TrainingJobConfig if package == "torch" else JaxConfig).from_json(text)
    out = cfg.outputs
    out.save_outputs, out.runs_folder, out.run_name = True, str(root / package), name
    out.save_visualizations, out.keep_viz_images = save_viz, keep
    if package == "torch":
        trainer = tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels, device="cpu")
    else:
        trainer = JaxTrainer.from_config(cfg, training_labels=jlabels, validation_labels=jlabels)
    if monkeypatch is not None:
        monkeypatch.setattr(trainer, "evaluate", lambda: None)
    trainer.train()
    folder = root / package / name
    with open(folder / "training_log.csv") as f:
        losses = [(float(r["loss"]), float(r["val_loss"])) for r in csv.DictReader(f)]
    viz = folder / "viz"
    return (sorted(os.listdir(viz)) if viz.exists() else None), losses, viz


def test_trainer_writes_the_visualizations_jax_writes(tmp_path, monkeypatch):
    got, losses, viz = _train("torch", tmp_path, "viz", monkeypatch=monkeypatch)
    want, _, _ = _train("jax", tmp_path, "viz", monkeypatch=monkeypatch)
    assert got == want == ["epoch_000.png", "epoch_001.png"]
    for name in got:
        data = (viz / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000
    none, plain_losses, _ = _train("torch", tmp_path, "plain", save_viz=False, monkeypatch=monkeypatch)
    assert none is None
    assert losses == plain_losses  # the drawing moves no random stream
    removed, _, _ = _train("torch", tmp_path, "removed", keep=False, monkeypatch=monkeypatch)
    jremoved, _, _ = _train("jax", tmp_path, "removed", keep=False, monkeypatch=monkeypatch)
    assert removed is None and jremoved is None


def test_trainer_without_matplotlib_trains_and_draws_nothing(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.DEBUG, logger="sleap_tpu_torch.training.trainer"):
        got, losses, _ = _train("torch", tmp_path, "no_mpl", monkeypatch=monkeypatch)
    assert got is None and len(losses) == 2
    assert "Visualization failed" in caplog.text
    with pytest.raises(ImportError, match="matplotlib"):
        nn_viz.generate_skeleton_preview_image(np.zeros((2, 2)))
