"""The port's data-parallel execution (``sleap_tpu_torch.parallel``) against
the JAX package's, on the CPU: JAX on the 8 virtual devices of
``tests/conftest.py``, the port on the CPU named several times, its
training ranks spawned processes over gloo (``tests/torch_parallel_ranks.py``,
one thread each, 60 s group timeouts).

- ``make_mesh``: the shapes of the JAX meshes, the same ``ValueError`` for
  6 devices and spatial 4; asking for more devices than there are raises,
  where JAX builds a smaller mesh; no card and no ``devices`` raises; a
  spatial sharding's blocks are JAX's ``addressable_shards``, and the
  trainer's ``(n/s, s)`` mesh JAX's;
- ``shard_pytree_batch``'s blocks are the rows of JAX's shards;
- ``sharded_infer_fn`` on ``tests/test_parallel.py``'s conv + sum, the
  same weights (HWIO -> OIHW), 4 entries: 1e-5 relative;
- ``make_sharded_predictor`` on the trained top-down pair and bottom-up
  folder against JAX's on a 2-device mesh at ``batch_size=2``: the
  tolerances of ``test_torch_topdown.py`` and ``test_torch_bottomup.py``
  (0.01 px, 1e-4), and against the port's own unsharded predictor at the
  global batch: 1e-3 px (``tests/test_parallel.py``'s bound), same NaNs;
- one step on two ranks against the JAX trainer's step on the global batch:
  a centroid UNet (float32) and a ResNet-18 encoder with batch norm and
  hard keypoint mining on (float64 on both sides, as in
  ``test_torch_backbone_training.py``), with
  ``test_loss_and_gradients_match_jax``'s tolerances (loss 1e-5 relative,
  gradients 1e-4 of their largest) and the running statistics 1e-5;
- ``Trainer(n_devices=2)`` for two epochs of two batches with augmentation
  on, against the single-device run at the rounded-up batch: parameters and
  running statistics within ``rtol=2e-3, atol=2e-4`` (the JAX test's own
  bound), ``batch_size=5`` becoming 6; one run folder; a rank that raises
  makes ``train()`` raise with its traceback, within the timeout.
"""

from __future__ import annotations

import json
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.config import TrainingJobConfig as JaxConfig
from sleap_tpu.inference.bottomup import BottomUpPredictor as JaxBottomUp
from sleap_tpu.inference import predictors as jp
from sleap_tpu.models.model import Model as JaxModel
from sleap_tpu.parallel import distributed as jdist
from sleap_tpu.parallel import mesh as jmesh
from sleap_tpu.training.trainer import Trainer as JaxTrainer
from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.models.params import flax_variables_from_state_dict, state_dict_from_flax
from sleap_tpu_torch.parallel import distributed as tdist
from sleap_tpu_torch.parallel import mesh as tmesh
from sleap_tpu_torch.training import trainer as tt
from test_torch_backbone_training import _grad_capture, _labels_pair as _bb_labels_pair
from test_torch_backbone_training import _seeded_running_stats
from test_torch_bottomup import BOTTOMUP, _assert_bottomup_equal
from test_torch_bottomup import _frames as _bottomup_frames
from test_torch_topdown import CENTROID, INSTANCE, TOPDOWN_KEYS, _assert_topdown_equal, _frames
from test_torch_topdown import _merged, _np_params
from test_torch_training import _batch, _config_json, _labels_pair
from torch_parallel_ranks import FailingPeerTrainer, run_ranks, sharded_step

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATS_RTOL = 1e-5
SHARDED_XY_TOL = 1e-3
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def cpus(n):
    return ["cpu"] * n


# --------------------------------------------------------------------------- #
# Meshes and batches
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,spatial", [(8, 2), (4, 1)])
def test_make_mesh_shapes_match_jax(n, spatial):
    want = jmesh.make_mesh(n_devices=n, spatial=spatial)
    got = tmesh.make_mesh(n_devices=n, spatial=spatial, devices=cpus(8))
    assert got.shape == dict(want.shape)
    assert got.axis_names == want.axis_names
    assert got.size == want.size and len(got.data_devices) == want.shape["data"]


def test_make_mesh_refuses_like_jax_and_where_jax_truncates():
    with pytest.raises(ValueError, match="6 devices not divisible by spatial=4"):
        jmesh.make_mesh(n_devices=6, spatial=4)
    with pytest.raises(ValueError, match="6 devices not divisible by spatial=4"):
        tmesh.make_mesh(n_devices=6, spatial=4, devices=cpus(8))
    # JAX takes devices[:9] of 8 and builds a mesh of 8; the port raises.
    assert jmesh.make_mesh(n_devices=9).shape["data"] == 8
    with pytest.raises(ValueError, match="9 devices asked for, 8 available"):
        tmesh.make_mesh(n_devices=9, devices=cpus(8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="No CUDA device"):
            tmesh.make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_mesh(devices=["cuda:0", "cuda:0"])
    # A spatial axis splits height into equal parts, as JAX's NamedSharding
    # does: its addressable shards, device for device; JAX's refusal of a
    # height the spatial size does not divide.
    images = np.random.default_rng(1).integers(0, 255, (4, 12, 4, 1), np.uint8)
    want = jax.device_put(images, jmesh.batch_sharding(jmesh.make_mesh(n_devices=6, spatial=3), 1))
    got = tmesh.batch_sharding(tmesh.make_mesh(devices=cpus(6), spatial=3), 1).shard(images)
    assert len(got) == len(want.addressable_shards) == 6
    for i, shard in enumerate(sorted(want.addressable_shards, key=lambda s: s.device.id)):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(shard.data))
        np.testing.assert_array_equal(got[i].numpy(), images[shard.index])
    with pytest.raises(ValueError, match="divisible by 3"):
        jax.device_put(images[:, :7], jmesh.batch_sharding(jmesh.make_mesh(n_devices=6, spatial=3), 1))
    with pytest.raises(ValueError, match="equal parts only where it divides 7"):
        tmesh.batch_sharding(tmesh.make_mesh(devices=cpus(6), spatial=3), 1).shard(images[:, :7])


def test_batch_split_equals_the_rows_of_jax_shards():
    batch = {"image": np.random.default_rng(0).integers(0, 255, (8, 16, 16, 1), np.uint8),
             "scale": np.arange(8, dtype=np.float32)}
    want = jmesh.shard_pytree_batch(batch, jmesh.make_mesh(n_devices=8, spatial=2))
    got = tmesh.shard_pytree_batch(batch, tmesh.make_mesh(n_devices=8, spatial=2, devices=cpus(8)))
    assert len(got) == 4
    for key in batch:
        assert want[key].sharding.spec == jax.sharding.PartitionSpec("data")
        for shard in want[key].addressable_shards:
            rows = shard.index[0]
            i = rows.start // 2
            np.testing.assert_array_equal(got[i][key].numpy(), np.asarray(shard.data))
            np.testing.assert_array_equal(got[i][key].numpy(), batch[key][rows])
    replicas = tmesh.replicate_pytree({"w": np.ones(3)}, tmesh.make_mesh(devices=cpus(2)))
    assert len(replicas) == 2 and all(torch.equal(r["w"], torch.ones(3, dtype=torch.float64))
                                      for r in replicas)


class ConvSum(torch.nn.Module):
    """``tests/test_parallel.py``'s conv + sum, in NCHW."""

    def __init__(self, w_hwio):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 4, 3, padding=1, bias=False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.from_numpy(np.array(w_hwio)).permute(3, 2, 0, 1))

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).float() / 255.0
        return {"out": self.conv(x).sum(dim=(2, 3))}


def test_sharded_infer_fn_matches_jax():
    w = jax.random.normal(jax.random.PRNGKey(0), (3, 3, 1, 4))

    def infer(images):
        x = images.astype(jnp.float32) / 255.0
        y = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return {"out": y.sum(axis=(1, 2))}

    images = np.random.default_rng(0).integers(0, 255, (8, 32, 32, 1), np.uint8)
    want = jdist.sharded_infer_fn(infer, jmesh.make_mesh(n_devices=4))(jnp.asarray(images))
    module = ConvSum(w)
    got = tdist.sharded_infer_fn(module, tmesh.make_mesh(devices=cpus(4)))(torch.from_numpy(images))
    np.testing.assert_allclose(got["out"].detach().numpy(), np.asarray(want["out"]), rtol=1e-5)
    # A plain function runs on each block as given.
    plain = tdist.sharded_infer_fn(lambda x: module(x), tmesh.make_mesh(devices=cpus(4)))
    torch.testing.assert_close(plain(torch.from_numpy(images))["out"], got["out"], rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# Sharded predictors
# --------------------------------------------------------------------------- #


def _assert_sharded_topdown_equal(got, want):
    got, want = _merged(got, TOPDOWN_KEYS), _merged(want, TOPDOWN_KEYS)
    np.testing.assert_array_equal(got["centroid_mask"], want["centroid_mask"])
    for k in ("centroids", "instance_peaks"):
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
        np.testing.assert_allclose(np.nan_to_num(got[k]), np.nan_to_num(want[k]), atol=SHARDED_XY_TOL,
                                   rtol=0)


def test_sharded_topdown_predictor_matches_jax():
    mesh = jmesh.make_mesh(n_devices=2)
    jpred = jp.TopDownPredictor.from_trained_models(
        centroid_model_path=CENTROID, confmap_model_path=INSTANCE, peak_threshold=0.05, batch_size=2)
    params = {CENTROID: _np_params(jpred.centroid_model), INSTANCE: _np_params(jpred.confmap_model)}
    jdist.make_sharded_predictor(jpred, mesh)
    assert jpred.batch_size == 4

    def port(batch_size):
        return tp.load_model([CENTROID, INSTANCE], device="cpu", params=params, peak_threshold=0.05,
                             batch_size=batch_size)

    tpred = tdist.make_sharded_predictor(port(2), tmesh.make_mesh(devices=cpus(2)))
    assert tpred.batch_size == 4
    frames = _frames(6, 384, seed=0)
    got = tpred.predict(frames, make_labels=False)
    assert [ex["n_valid"] for ex in got] == [4, 2]
    _assert_topdown_equal(got, jpred.predict(frames, make_labels=False), min_centroids=4)
    _assert_sharded_topdown_equal(got, port(4).predict(frames, make_labels=False))
    labels = tpred.predict(frames)
    assert [lf.frame_idx for lf in labels] == list(range(6))


def test_sharded_bottomup_predictor_matches_jax():
    jpred = JaxBottomUp.from_trained_models(BOTTOMUP, batch_size=2, peak_threshold=0.1)
    params = jax.tree_util.tree_map(np.asarray, jpred.bottomup_model.variables["params"])
    jdist.make_sharded_predictor(jpred, jmesh.make_mesh(n_devices=2))
    tpred = tp.load_model(BOTTOMUP, device="cpu", params={BOTTOMUP: params}, batch_size=2,
                          peak_threshold=0.1)
    tdist.make_sharded_predictor(tpred, tmesh.make_mesh(devices=cpus(2)))
    frames = _bottomup_frames(4, 128, seed=0, blobs=2, sigma=10.0)
    _assert_bottomup_equal(tpred.predict(frames, make_labels=False),
                           jpred.predict(frames, make_labels=False), min_instances=4)


# --------------------------------------------------------------------------- #
# One data-parallel step against the JAX trainer's
# --------------------------------------------------------------------------- #


def _assert_grads(grads, want, largest_floor=True):
    largest = max(float(w.abs().max()) for n, w in want.items() if n in grads)
    for name, g in grads.items():
        w = want[name].to(g.dtype)
        scale = max(float(w.abs().max()), GRAD_RTOL * largest) if largest_floor else \
            float(w.abs().max())
        assert float((g - w).abs().max()) <= GRAD_RTOL * scale, name


def test_two_rank_centroid_step_matches_jax():
    labels, jlabels = _labels_pair()
    text = _config_json("centroid", batch_size=4)
    port = tt.Trainer.from_config(TrainingJobConfig.from_json(text), training_labels=labels,
                                  validation_labels=labels, device="cpu")
    ref = JaxTrainer.from_config(JaxConfig.from_json(text), training_labels=jlabels,
                                 validation_labels=jlabels)
    port.setup()
    ref.setup()
    inds = (0, 1, 2, 3)
    train_step, _ = ref._build_train_step(_grad_capture())
    params = ref.variables["params"]
    _, _, jgrads, jloss = train_step(params, {}, jax.tree.map(jnp.zeros_like, params),
                                     {k: jnp.asarray(v) for k, v in _batch(ref, inds).items()},
                                     jax.random.PRNGKey(0))
    port.module.load_state_dict(state_dict_from_flax(port.module, jax.tree.map(np.asarray, params)))
    results = run_ranks(sharded_step, 2, pickle.dumps(port), inds)
    want = state_dict_from_flax(port.module, jax.tree.map(np.asarray, jgrads))
    for loss, grads, _ in results:
        assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), (loss, jloss)
        _assert_grads(grads, want, largest_floor=False)
    assert all(torch.equal(results[0][1][n], results[1][1][n]) for n in results[0][1])


BN_CONFIG = json.dumps({
    "model": {"backbone": {"pretrained_encoder": {"encoder": "resnet18", "pretrained": False,
                                                  "decoder_filters": 8, "output_stride": 4}},
              "heads": {"single_instance": {"sigma": 1.5, "output_stride": 4}}},
    "optimization": {"batch_size": 4, "hard_keypoint_mining": {"online_mining": True,
                                                               "hard_to_easy_ratio": 1.2}},
    "outputs": {"save_outputs": False},
})


def test_two_rank_batch_norm_ohkm_step_matches_jax(monkeypatch):
    """A ResNet-18 encoder (batch norm throughout) with hard keypoint mining:
    the two ranks' step equals the JAX step on the global batch of 4 (float64
    on both sides, seeded running statistics)."""
    labels, jlabels = _bb_labels_pair()
    port = tt.Trainer.from_config(TrainingJobConfig.from_json(BN_CONFIG), training_labels=labels,
                                  validation_labels=labels, device="cpu")
    port.setup()
    variables = flax_variables_from_state_dict(port.module)
    variables["batch_stats"] = _seeded_running_stats(variables)
    inds = (0, 1, 2, 3)
    with jax.enable_x64(True):
        ref = JaxTrainer.from_config(JaxConfig.from_json(BN_CONFIG), training_labels=jlabels,
                                     validation_labels=jlabels)
        monkeypatch.setattr(JaxModel, "init", lambda self, rng, shape, compute_dtype=jnp.float32: (
            self.make_flax_module(jnp.float64), variables))
        ref.setup()
        train_step, _ = ref._build_train_step(_grad_capture())
        to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        p64 = to64(variables["params"])
        _, jstats, jgrads, jloss = train_step(
            p64, to64(variables["batch_stats"]), jax.tree.map(jnp.zeros_like, p64),
            {k: jnp.asarray(v) for k, v in _batch(ref, inds).items()}, jax.random.PRNGKey(0))
        jloss, jgrads, jstats = float(jloss), jax.tree.map(np.asarray, jgrads), \
            jax.tree.map(np.asarray, jstats)

    module = port.model.make_module(port._input_channels, compute_dtype=torch.float64)
    module.load_state_dict(state_dict_from_flax(module, variables))
    port.module = module
    results = run_ranks(sharded_step, 2, pickle.dumps(port), inds)
    want = state_dict_from_flax(module, {"params": jgrads, "batch_stats": jstats})
    before = state_dict_from_flax(module, variables)
    for loss, grads, stats in results:
        assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
        _assert_grads(grads, want)
        assert stats
        for name, s in stats.items():
            w = want[name].double()
            assert float((s - w).abs().max()) <= STATS_RTOL * float(w.abs().max()), name
            assert not torch.equal(s, before[name].double()), name  # it moved
    assert all(torch.equal(results[0][2][n], results[1][2][n]) for n in results[0][2])


# --------------------------------------------------------------------------- #
# Trainer(n_devices=2) against the single-device trainer
# --------------------------------------------------------------------------- #

AUGMENT = {"rotate": True, "rotation_min_angle": -15.0, "rotation_max_angle": 15.0,
           "scale": True, "scale_min": 0.9, "scale_max": 1.1, "uniform_noise": True}
RUNS = {
    "centroid UNet": ("centroid", None, 5, 6),
    "ResNet-18 batch norm": (None, BN_CONFIG, 4, 4),
}


def _run_trainer(name, root, n_devices, batch_size):
    head, bn_config, _, _ = RUNS[name]
    cfg = json.loads(_config_json(head) if head else bn_config)
    cfg["optimization"].update({"batch_size": batch_size, "epochs": 2, "batches_per_epoch": 2,
                                "val_batches_per_epoch": 1, "augmentation_config": AUGMENT})
    cfg["outputs"] = {"runs_folder": str(root), "run_name": "run", "save_outputs": True}
    labels = _labels_pair()[0] if head else _bb_labels_pair()[0]
    trainer = tt.Trainer.from_config(TrainingJobConfig.from_json(json.dumps(cfg)),
                                     training_labels=labels, validation_labels=labels, device="cpu",
                                     n_devices=n_devices)
    trainer.group_timeout = 60.0
    trainer.train()
    return trainer


@pytest.mark.parametrize("name", list(RUNS))
def test_two_rank_training_matches_one_device(name, tmp_path, monkeypatch):
    monkeypatch.setattr(tt.Trainer, "evaluate", lambda self: None)  # rank 0's, after training
    _, _, dp_batch, single_batch = RUNS[name]
    single = _run_trainer(name, tmp_path / "single", None, single_batch)
    dp = _run_trainer(name, tmp_path / "dp", 2, dp_batch)
    assert dp.mesh.shape == {"data": 2, "spatial": 1}
    want, got = single.module.state_dict(), dp.module.state_dict()
    assert any(k.endswith("running_var") for k in got) == (name != "centroid UNet")
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=PARAM_RTOL, atol=PARAM_ATOL, msg=k)
    np.testing.assert_allclose([r["loss"] for r in dp.log_rows], [r["loss"] for r in single.log_rows],
                               rtol=1e-4)
    # One run folder, rank 0's, with its checkpoints and log.
    assert os.listdir(tmp_path / "dp") == ["run"]
    folder = tmp_path / "dp" / "run"
    assert {"best_model.pt", "training_config.json", "training_log.csv"} <= set(os.listdir(folder))
    torch.testing.assert_close(torch.load(folder / "best_model.pt", weights_only=True),
                               {k: v.float() for k, v in dp._state_dict().items()})


def test_a_failing_rank_makes_train_raise(tmp_path):
    labels = _labels_pair()[0]
    cfg = json.loads(_config_json("centroid", batch_size=4, epochs=1, batches_per_epoch=2))
    cfg["outputs"] = {"save_outputs": False}
    trainer = tt.Trainer.from_config(TrainingJobConfig.from_json(json.dumps(cfg)),
                                     training_labels=labels, validation_labels=labels, device="cpu",
                                     n_devices=2)
    trainer.__class__ = FailingPeerTrainer
    trainer.group_timeout = 60.0
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"(?s)ranks \[1\].*rank 1 fails on purpose"):
        trainer.train()
    assert time.perf_counter() - t0 < 60.0


def test_labels_pickle_for_spawned_ranks():
    """A spawned rank gets its trainer pickled: labels come back with each
    instance owned by its frame (a list subclass's pickle appends before
    its attributes are back)."""
    labels = _labels_pair()[0]
    back = pickle.loads(pickle.dumps(labels))
    assert len(back) == len(labels)
    for lf, lf_back in zip(labels.labeled_frames, back.labeled_frames):
        assert [i.frame for i in lf_back.instances] == [lf_back] * len(lf.instances)
        for a, b in zip(lf.instances, lf_back.instances):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            assert a.track.name == b.track.name


def test_trainer_refuses_spatial_sharding_and_missing_cards():
    """Spatial sharding builds an (n/s, s) mesh (n defaults to s), as JAX's
    trainer does; missing cards and an indivisible mesh raise."""
    labels = _labels_pair()[0]
    cfg = TrainingJobConfig.from_json(_config_json("centroid"))
    for n, s, shape in [(4, 2, (2, 2)), (2, 2, (1, 2)), (None, 3, (1, 3)), (6, 3, (2, 3))]:
        trainer = tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                         device="cpu", n_devices=n, spatial_sharding=s)
        assert trainer.mesh.shape == {"data": shape[0], "spatial": shape[1]}
        assert trainer.mesh.shape == dict(jmesh.make_mesh(n_devices=n or s, spatial=s).shape)
        assert trainer.n_devices == shape[0] * shape[1] and trainer.spatial_sharding == s
    with pytest.raises(ValueError, match="6 devices not divisible by spatial=4"):
        tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels, device="cpu",
                               n_devices=6, spatial_sharding=4)
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises((RuntimeError, ValueError), match="No CUDA device|available"):
        tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels, n_devices=n)
    trainer = tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                     device="cpu", n_devices=3)
    assert trainer.mesh.shape == {"data": 3, "spatial": 1} and trainer.n_devices == 3
    assert tdist.backend_for(trainer.mesh.data_devices) == "gloo"
