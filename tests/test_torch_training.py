"""The port's trainers against the JAX package's, on the same labels, config
and batch, for each of the six head types (augmentation off):

- the ground truth (``build_gt_fn``): images and every target map, 1e-6
  absolute;
- the loss and every gradient at the JAX trainer's initial weights, carried
  over by ``state_dict_from_flax``: loss within 1e-5 relative, each
  parameter's gradient within 1e-4 of that gradient's largest magnitude
  (the JAX side runs its own jitted ``train_step`` with an optimizer that
  hands the gradients back; both sides in full float32);

and: the batches a 2-epoch run draws equal the JAX loop's; the port's
``lecun_normal`` initialization has flax's per-layer spread; a 2-epoch run
writes a folder that ``load_model(folder, device="cpu")`` predicts from
(``best_model.pt``) and the JAX package reads the config of; mixed
precision keeps float32 parameters.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sleap_tpu.config import TrainingJobConfig as JaxConfig
from sleap_tpu.core.instance import Instance as JaxInstance
from sleap_tpu.core.instance import LabeledFrame as JaxLabeledFrame
from sleap_tpu.core.instance import Track as JaxTrack
from sleap_tpu.core.labels import Labels as JaxLabels
from sleap_tpu.core.skeleton import Skeleton as JaxSkeleton
from sleap_tpu.io.video import Video as JaxVideo
from sleap_tpu.training.trainer import Trainer as JaxTrainer
import sleap_tpu_torch
from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.core.instance import Instance, LabeledFrame, Track
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io.video import Video
from sleap_tpu_torch.models.model import init_params_lecun
from sleap_tpu_torch.models.params import flax_from_state_dict, state_dict_from_flax
from sleap_tpu_torch.training import trainer as tt

torch.set_num_threads(1)

GT_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SIZE = 48
NODES = ["n0", "n1", "n2", "n3"]
EDGES = [("n0", "n1"), ("n1", "n2"), ("n2", "n3")]


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _labels_pair(n_frames=5, n_inst=2, seed=0):
    """The same labels in both packages: uint8 frames, instances on them
    (some nodes missing), each animal on its track."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n_frames, SIZE, SIZE, 1), np.uint8)
    pts = rng.uniform(6, SIZE - 6, (n_frames, n_inst, len(NODES), 2))
    pts[rng.random(pts.shape[:3]) < 0.15] = np.nan
    pts[:, :, 0] = rng.uniform(10, SIZE - 10, (n_frames, n_inst, 2))  # anchors visible
    out = []
    for skel_cls, inst_cls, lf_cls, labels_cls, video, track_cls in (
        (Skeleton, Instance, LabeledFrame, Labels, Video, Track),
        (JaxSkeleton, JaxInstance, JaxLabeledFrame, JaxLabels, JaxVideo, JaxTrack),
    ):
        skel = skel_cls("chain")
        for n in NODES:
            skel.add_node(n)
        for a, b in EDGES:
            skel.add_edge(a, b)
        skel.add_symmetry("n1", "n3")
        vid = video.from_numpy(frames)
        tracks = [track_cls(name=f"animal{i}") for i in range(n_inst)]
        lfs = [lf_cls(vid, i, [inst_cls(skel, pts[i, j], track=tracks[j]) for j in range(n_inst)])
               for i in range(n_frames)]
        out.append(labels_cls(lfs))
    return out


UNET = {"max_stride": 8, "output_stride": 2, "filters": 4, "filters_rate": 2.0}
CONFIGS = {
    "single_instance": {
        "model": {"backbone": {"unet": UNET}, "heads": {"single_instance": {
            "sigma": 1.5, "output_stride": 2, "offset_refinement": True}}},
        "optimization": {"hard_keypoint_mining": {"online_mining": True}},
    },
    "centroid": {
        "data": {"preprocessing": {"input_scaling": 0.5}},
        "model": {"backbone": {"unet": UNET}, "heads": {"centroid": {
            "anchor_part": "n0", "sigma": 1.5, "output_stride": 2, "offset_refinement": True}}},
    },
    "centered_instance": {
        "data": {"instance_cropping": {"crop_size": 16}},
        "model": {"backbone": {"unet": {"max_stride": 16, "output_stride": 4, "filters": 4,
                                        "filters_rate": 2.0, "up_interpolate": True,
                                        "space_to_depth": 4}},
                  "heads": {"centered_instance": {"sigma": 1.5, "output_stride": 4}}},
    },
    "multi_instance": {
        "model": {"backbone": {"unet": UNET}, "heads": {"multi_instance": {
            "confmaps": {"sigma": 1.5, "output_stride": 2, "offset_refinement": True},
            "pafs": {"sigma": 3.0, "output_stride": 4, "loss_weight": 0.5}}}},
    },
    "multi_class_bottomup": {
        "model": {"backbone": {"unet": {**UNET, "up_interpolate": True}},
                  "heads": {"multi_class_bottomup": {
                      "confmaps": {"sigma": 1.5, "output_stride": 2},
                      "class_maps": {"sigma": 2.0, "output_stride": 4}}}},
    },
    "multi_class_topdown": {
        "data": {"instance_cropping": {"crop_size": 16, "center_on_part": "n0"}},
        "model": {"backbone": {"unet": UNET}, "heads": {"multi_class_topdown": {
            "confmaps": {"sigma": 1.5, "output_stride": 2},
            "class_vectors": {"num_fc_layers": 1, "num_fc_units": 8, "output_stride": 8,
                              "loss_weight": 0.5}}}},
    },
}
HEADS = list(CONFIGS)


def _config_json(head, **optimization):
    cfg = json.loads(json.dumps(CONFIGS[head]))
    cfg.setdefault("optimization", {}).update({"batch_size": 3, **optimization})
    cfg["outputs"] = {"save_outputs": False}
    return json.dumps(cfg)


def _trainers(head, **optimization):
    labels, jlabels = _labels_pair()
    text = _config_json(head, **optimization)
    port = tt.Trainer.from_config(TrainingJobConfig.from_json(text), training_labels=labels,
                                  validation_labels=labels, device="cpu")
    ref = JaxTrainer.from_config(JaxConfig.from_json(text), training_labels=jlabels,
                                 validation_labels=jlabels)
    port.setup()
    ref.setup()
    return port, ref


@pytest.fixture(scope="module")
def trainers():
    cache = {}

    def get(head):
        if head not in cache:
            cache[head] = _trainers(head)
        return cache[head]

    return get


def _batch(trainer, inds=(0, 2, 3)):
    return trainer.make_batch([trainer._train_examples[i] for i in inds], None)


def _grad_capture():
    """An optax transformation whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


@pytest.mark.parametrize("head", HEADS)
def test_ground_truth_matches_jax(head, trainers):
    port, ref = trainers(head)
    assert type(port).__name__ == type(ref).__name__
    batch = _batch(port)
    jbatch = _batch(ref)
    for k in jbatch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    imgs, gt = port.build_gt_fn()(port.to_device(batch), torch.Generator().manual_seed(0))
    jimgs, jgt = ref.build_gt_fn()({k: jnp.asarray(v) for k, v in jbatch.items()},
                                   jax.random.PRNGKey(0))
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jimgs), rtol=0, atol=GT_TOL)
    assert sorted(gt) == sorted(jgt)
    for k in gt:
        assert gt[k].shape == jgt[k].shape, k
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(jgt[k]), rtol=0, atol=GT_TOL,
                                   err_msg=k)
        assert float(np.abs(np.asarray(jgt[k])).max()) > 0.1, k  # the maps hold something


@pytest.mark.parametrize("head", HEADS)
def test_loss_and_gradients_match_jax(head, trainers):
    port, ref = trainers(head)
    train_step, _ = ref._build_train_step(_grad_capture())
    params = ref.variables["params"]
    jbatch = {k: jnp.asarray(v) for k, v in _batch(ref).items()}
    _, _, jgrads, jloss = train_step(params, {}, jax.tree.map(jnp.zeros_like, params), jbatch,
                                     jax.random.PRNGKey(0))
    module = port.module
    module.load_state_dict(state_dict_from_flax(module, jax.tree.map(np.asarray, params)))
    module.zero_grad()
    loss = port.compute_loss(port.to_device(_batch(port)), torch.Generator().manual_seed(0))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), (loss, jloss)
    want = state_dict_from_flax(module, jax.tree.map(np.asarray, jgrads))
    for name, p in module.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= GRAD_RTOL * scale, (name, np.abs(g - w).max(), scale)


def test_batches_match_jax(monkeypatch):
    """2 epochs of 3 train and 2 validation batches: the port draws JAX's
    examples in JAX's order (the JAX loop runs with its steps stubbed out,
    the port's for real)."""
    opt = {"epochs": 2, "batches_per_epoch": 3, "val_batches_per_epoch": 2}
    port, ref = _trainers("centered_instance", **opt)
    seen = {"port": [], "jax": []}

    def recorder(trainer, key):
        make = trainer.make_batch

        def make_batch(examples, rng):
            for e in examples:
                for split, pool in (("train", trainer._train_examples),
                                    ("val", trainer._val_examples)):
                    hits = [i for i, x in enumerate(pool) if x is e]
                    if hits:
                        seen[key].append((split, hits[0]))
                        break
            return make(examples, rng)

        return make_batch

    monkeypatch.setattr(port, "make_batch", recorder(port, "port"))
    monkeypatch.setattr(ref, "make_batch", recorder(ref, "jax"))
    monkeypatch.setattr(ref, "_build_train_step", lambda optimizer: (
        lambda params, bs, state, batch, rng: (params, bs, state, jnp.float32(0.0)),
        lambda params, bs, batch, rng: jnp.float32(0.0)))
    monkeypatch.setattr(ref, "evaluate", lambda: None)
    port.train()
    ref.train()
    assert len(seen["jax"]) == 2 * (3 + 2) * 3
    assert seen["port"] == seen["jax"]
    assert len(port.log_rows) == 2


def test_lecun_init_matches_flax():
    """Per layer, the port's kernels and flax's have the spread of a
    normal of std sqrt(1 / fan_in) cut at 2 of its own std: within 5% of
    it for layers of at least 4000 weights (about 4 standard errors), and
    within 7% of flax's; biases 0; nothing beyond the cut."""
    labels, jlabels = _labels_pair()
    cfg = json.loads(_config_json("multi_instance"))
    cfg["model"]["backbone"]["unet"].update(filters=16, max_stride=16)
    port = tt.Trainer.from_config(TrainingJobConfig.from_json(json.dumps(cfg)),
                                  training_labels=labels, validation_labels=labels, device="cpu")
    ref = JaxTrainer.from_config(JaxConfig.from_json(json.dumps(cfg)), training_labels=jlabels,
                                 validation_labels=jlabels)
    port.setup()
    ref.setup()
    ours = flax_from_state_dict(port.module)
    theirs = jax.tree.map(np.asarray, ref.variables["params"])
    flat_ours = {k: v for g in ("backbone",) for k, v in ours[g].items()}
    flat_ours.update({k: v for k, v in ours.items() if k != "backbone"})
    flat_theirs = dict(theirs["backbone"])
    flat_theirs.update({k: v for k, v in theirs.items() if k != "backbone"})
    assert sorted(flat_ours) == sorted(flat_theirs)
    checked = 0
    for name, layer in flat_ours.items():
        k, jk = layer["kernel"], flat_theirs[name]["kernel"]
        assert k.shape == jk.shape, name
        std = np.sqrt(1.0 / np.prod(k.shape[:-1]))
        assert np.abs(k).max() <= 2 * std / 0.87962566 + 1e-6, name
        np.testing.assert_array_equal(layer["bias"], 0)
        if k.size >= 4000:
            assert abs(k.std() / std - 1) < 0.05, (name, k.std() / std)
            assert abs(jk.std() / std - 1) < 0.05, (name, jk.std() / std)
            assert abs(k.std() / jk.std() - 1) < 0.07, name
            checked += 1
    assert checked >= 8
    # The first decoder conv (the fused up-conv in JAX) draws with flax's
    # fan-in: its input axis spans the skip and the upsampled channels.
    fused = flat_ours["stack0_dec0_refine_conv0"]["kernel"]
    assert fused.shape == flat_theirs["stack0_dec0_refine_conv0"]["kernel"].shape
    assert abs(fused.std() * np.sqrt(np.prod(fused.shape[:-1])) - 1) < 0.05


def test_trained_folders_load_and_predict(tmp_path):
    """A 2-epoch top-down pair: each folder holds the configs, the log and
    ``best_model.pt``; the JAX package reads the port's config; the pair
    predicts through ``load_model`` with no params."""
    labels, _ = _labels_pair(n_frames=6)
    folders = []
    for head in ("centroid", "centered_instance"):
        cfg = TrainingJobConfig.from_json(_config_json(
            head, epochs=2, batches_per_epoch=2, val_batches_per_epoch=1))
        cfg.outputs.save_outputs = True
        cfg.outputs.runs_folder = str(tmp_path)
        cfg.outputs.run_name = head
        cfg.outputs.checkpointing.latest_model = True
        trainer = tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                         device="cpu")
        trainer.train()
        folder = tmp_path / head
        assert {"best_model.pt", "latest_model.pt", "training_config.json",
                "initial_config.json", "training_log.csv"} <= set(os.listdir(folder))
        with open(folder / "training_log.csv") as f:
            rows = list(csv.DictReader(f))
        assert [int(r["epoch"]) for r in rows] == [0, 1]
        assert all(np.isfinite(float(r["loss"])) for r in rows)
        jcfg = JaxConfig.load_json(str(folder))
        assert jcfg.data.labels.skeletons[0].node_names == NODES
        assert jcfg.data.labels.skeletons[0].symmetry_names == [("n1", "n3")]
        if head == "centered_instance":
            assert jcfg.model.heads.centered_instance.part_names == NODES
            assert jcfg.data.instance_cropping.crop_size == 16
        state = torch.load(folder / "best_model.pt", weights_only=True)
        assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in state.values())
        folders.append(str(folder))
    pred = sleap_tpu_torch.load_model(folders, device="cpu", peak_threshold=0.0, max_instances=2)
    frames = labels.video.data[:3]
    out = pred.predict(frames)
    assert isinstance(out, Labels) and len(out) == 3
    assert all(len(lf.instances) > 0 for lf in out)
    assert all(i.numpy().shape == (4, 2) for lf in out for i in lf.instances)


def test_mixed_precision_keeps_float32_parameters():
    port, _ = _trainers("centered_instance", mixed_precision=True)
    port.make_optimizer()
    gen = torch.Generator().manual_seed(0)
    before = {k: v.clone() for k, v in port.module.state_dict().items()}
    losses = [port.train_step(port.to_device(_batch(port)), gen) for _ in range(2)]
    assert all(l.dtype == torch.float32 and torch.isfinite(l) for l in losses)
    assert all(p.dtype == torch.float32 for p in port.module.parameters())
    assert all(s.dtype == torch.float32 for st in port.optimizer.state.values()
               for s in st.values() if torch.is_tensor(s) and s.ndim > 0)
    assert any(not torch.equal(before[k], v) for k, v in port.module.state_dict().items())
    # Under autocast the convolutions ran in bf16 (the head outputs are bf16).
    with port._autocast():
        out = port.module(port.build_gt_fn()(port.to_device(_batch(port)), gen)[0])
    assert all(v.dtype == torch.bfloat16 for v in out.values())


def test_trainer_runs_on_the_card_by_default():
    import inspect

    assert inspect.signature(tt.Trainer.from_config).parameters["device"].default == "cuda"
    assert inspect.signature(tt.Trainer.__init__).parameters["device"].default == "cuda"


def test_lecun_init_is_seeded():
    port, _ = _trainers("single_instance")
    a = flax_from_state_dict(init_params_lecun(port.module, torch.Generator().manual_seed(1)))
    b = flax_from_state_dict(init_params_lecun(port.module, torch.Generator().manual_seed(1)))
    for layer in a["backbone"]:
        np.testing.assert_array_equal(a["backbone"][layer]["kernel"], b["backbone"][layer]["kernel"])


def test_labels_selection_matches_jax():
    """``split`` with a seed picks JAX's frames; ``with_user_labels_only``
    drops predicted instances and frames without user instances;
    ``find_instance_crop_size`` and ``size_match_image`` agree."""
    from sleap_tpu.core.instance import PredictedInstance as JaxPredicted
    from sleap_tpu.training import trainer as jt

    from sleap_tpu_torch.core.instance import PredictedInstance

    labels, jlabels = _labels_pair(n_frames=9)
    for seed in (0, 3):
        for n in (0.6, 4):
            got = labels.split(n, copy=True, seed=seed)
            want = jlabels.split(n, copy=True, seed=seed)
            assert [[lf.frame_idx for lf in part] for part in got] == [
                [lf.frame_idx for lf in part] for part in want]
            assert got[0].video is labels.video  # copies share the video
    skel, jskel = labels.skeleton, jlabels.skeleton
    pred = PredictedInstance.from_arrays(np.zeros((4, 2)), np.ones(4), 1.0, skel)
    jpred = JaxPredicted.from_numpy(np.zeros((4, 2)), np.ones(4), 1.0, jskel)
    labels[0].instances.append(pred)
    jlabels[0].instances.append(jpred)
    labels[1].instances[:] = [pred]
    jlabels[1].instances = [jpred]
    got, want = labels.with_user_labels_only(), jlabels.with_user_labels_only()
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want] == [0] + list(range(2, 9))
    assert [len(lf.instances) for lf in got] == [len(lf.instances) for lf in want]
    assert all(not i.predicted for lf in got for i in lf.instances)
    for padding, scale, min_crop in ((0, 1.0, None), (16, 0.5, None), (8, 1.0, 24), (0, 1.0, 32)):
        kw = dict(padding=padding, maximum_stride=16, input_scaling=scale, min_crop_size=min_crop)
        assert tt.find_instance_crop_size(labels, **kw) == jt.find_instance_crop_size(jlabels, **kw)
    frame = labels.video.data[0]
    for target in ((64, 80), (48, 48), (100, 60)):
        got_img, got_scale = tt.size_match_image(frame, target)
        want_img, want_scale = jt.size_match_image(frame, target)
        assert got_scale == want_scale
        np.testing.assert_array_equal(got_img, want_img)


def test_lazy_examples_match_preloaded():
    """``preload_data=False`` decodes on access: the same examples, so the
    same ground truth, for a frame trainer and a crop trainer."""
    for head in ("centroid", "multi_class_topdown"):
        labels, _ = _labels_pair()
        eager = tt.Trainer.from_config(TrainingJobConfig.from_json(_config_json(head)),
                                       training_labels=labels, validation_labels=labels,
                                       device="cpu")
        lazy = tt.Trainer.from_config(
            TrainingJobConfig.from_json(_config_json(head, preload_data=False)),
            training_labels=labels, validation_labels=labels, device="cpu")
        eager.setup()
        lazy.setup()
        assert isinstance(lazy._train_examples, (tt.LazyExamples, tt.LazyInstanceExamples))
        assert len(lazy._train_examples) == len(eager._train_examples)
        gen = torch.Generator().manual_seed(0)
        a = eager.build_gt_fn()(eager.to_device(_batch(eager)), gen)
        b = lazy.build_gt_fn()(lazy.to_device(_batch(lazy)), gen)
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
        for k in a[1]:
            torch.testing.assert_close(a[1][k], b[1][k], rtol=0, atol=0)


def test_augmented_amsgrad_run_and_base_checkpoint(tmp_path):
    """A run with every augmentation on and AMSGrad trains with finite
    losses; a trainer whose ``base_checkpoint`` is that folder starts from
    its ``best_model.pt``."""
    from sleap_tpu_torch.training.optimizers import AMSGrad

    labels, _ = _labels_pair()
    cfg = TrainingJobConfig.from_json(_config_json(
        "single_instance", epochs=2, batches_per_epoch=2, val_batches_per_epoch=1,
        optimizer="amsgrad"))
    cfg.optimization.augmentation_config = type(cfg.optimization.augmentation_config)(
        rotate=True, scale=True, translate=True, random_flip=True, uniform_noise=True,
        gaussian_noise=True, contrast=True, brightness=True)
    cfg.outputs.save_outputs = True
    cfg.outputs.runs_folder, cfg.outputs.run_name = str(tmp_path), "base"
    trainer = tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                     device="cpu")
    trainer.train()
    assert isinstance(trainer.optimizer, AMSGrad)
    assert all(np.isfinite(r["loss"]) for r in trainer.log_rows)
    cfg2 = TrainingJobConfig.from_json(_config_json("single_instance"))
    cfg2.model.base_checkpoint = str(tmp_path / "base")
    tuned = tt.Trainer.from_config(cfg2, training_labels=labels, validation_labels=labels,
                                   device="cpu")
    tuned.setup()
    best = torch.load(tmp_path / "base" / "best_model.pt", weights_only=True)
    for k, v in tuned.module.state_dict().items():
        assert torch.equal(v, best[k]), k
