"""Spatial (frame-height) sharding of the port's training
(``sleap_tpu_torch.parallel.spatial``) on the CPU: ranks are spawned
processes over gloo (``tests/torch_parallel_ranks.py``, the port only, one
thread each), on a ``(data, spatial)`` mesh of the CPU named several times.

- Every shared primitive of the backbones (SAME convolutions, strided,
  dilated, grouped, even windows; transposed convolutions; max and average
  pools; nearest and bilinear upsampling; space-to-depth; batch norm; the
  frame mean of squeeze-excite and global pooling; the flattening
  class-vector head's gather) on uneven bands, in float64, against the
  unsharded op on the whole frame: each rank's band of the output and of
  the input's gradient, the weight gradients summed over the ranks and the
  running statistics within PRIMITIVE_TOL. Two ranks on 48 x 32 frames at
  maximum stride 16 (bands of 32 and 16 rows) and three on 56 x 24 at
  maximum stride 8 (24, 16 and 16): one spawn each for every case, and a
  dilated convolution whose halo is taller than a neighbour's band.
- One float64 train step of every backbone the port trains (UNet with and
  without ``up_interpolate``, LEAP, a 2-stack Hourglass, ``resnet``, HRNet,
  the pretrained-encoder UNet on ResNet-18 and EfficientNet-b0) on a
  ``(1, 2)`` mesh against the JAX trainer's unsharded step on the same
  batch, with ``test_torch_backbone_training.py``'s tolerances (loss
  LOSS_RTOL relative, gradients GRAD_RTOL of their largest, running
  statistics STATS_RTOL), and against the port's own unsharded float64
  step: gradients and statistics within STEP_RTOL of their largest, the
  loss within STEP_LOSS_RTOL (both trainers sum the loss in float32, as the
  JAX trainer does, so a band's share and the whole batch's mean round
  apart there). HRNet's step is held to the port's unsharded step alone
  (both trainers cast the heads' outputs to float32 for the loss, which
  HRNet at its initial weights amplifies to 4e-3 of a gradient, as
  ``test_torch_backbone_training.py`` says); its banded train-mode forward
  and backward are held to the JAX module's, in float64 without that
  cast: each band's outputs and the running statistics within STATS_RTOL
  of their largest, and the gradients of a seeded sum of the outputs
  within GRAD_RTOL of their largest.
- A mixed-precision step on two bands against the unsharded one, within
  bf16's rounding (MIXED_LOSS_RTOL, MIXED_GRAD_RTOL of the largest
  gradient).
- ``tests/test_parallel.py``'s spatially sharded run (a bottom-up UNet with
  part affinity fields on 64^2 frames, maximum stride 4, batch 8, two
  epochs of two batches) as ``Trainer(n_devices=4, spatial_sharding=2)``
  on four ranks, from the JAX run's initial weights: the parameters within
  that test's ``rtol=2e-3, atol=2e-4`` of the JAX package's single-device
  run.
- The bands: interior edges at multiples of the maximum stride, dealt as
  ``numpy.array_split`` deals blocks; an empty band raises naming the
  shapes.
"""

from __future__ import annotations

import copy
import json
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleap_tpu.models.hrnet as jax_hrnet
from sleap_tpu.config import TrainingJobConfig as JaxConfig
from sleap_tpu.core.instance import Instance as JaxInstance
from sleap_tpu.core.instance import LabeledFrame as JaxLabeledFrame
from sleap_tpu.core.labels import Labels as JaxLabels
from sleap_tpu.core.skeleton import Skeleton as JaxSkeleton
from sleap_tpu.io.video import Video as JaxVideo
from sleap_tpu.models.model import Model as JaxModel
from sleap_tpu.training.trainer import Trainer as JaxTrainer
from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.core.instance import Instance, LabeledFrame
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io.video import Video
from sleap_tpu_torch.models.params import flax_variables_from_state_dict, state_dict_from_flax
from sleap_tpu_torch.parallel.spatial import SpatialGroup
from sleap_tpu_torch.training import trainer as tt
import test_torch_backbone_training as bbt
from torch_parallel_ranks import run_ranks
from torch_spatial_ranks import check_primitives, primitive_cases, spatial_steps

torch.set_num_threads(1)

PRIMITIVE_TOL = 1e-12
LOSS_RTOL, GRAD_RTOL, STATS_RTOL = bbt.LOSS_RTOL, bbt.GRAD_RTOL, bbt.STATS_RTOL
STEP_RTOL = 1e-10
STEP_LOSS_RTOL = 1e-6
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


# --------------------------------------------------------------------------- #
# Bands
# --------------------------------------------------------------------------- #


def test_bands_align_to_the_maximum_stride_and_refuse_empty_ones():
    assert SpatialGroup(0, 2).bands(48, 32, 16).edges == (0, 32, 48)
    assert SpatialGroup(2, 3).bands(56, 24, 8).edges == (0, 24, 40, 56)
    bands = SpatialGroup(1, 3).bands(56, 24, 8)
    level = bands.at_stride(4)
    assert (level.n, level.rows, level.band) == (14, ((0, 6), (6, 10), (10, 14)), (6, 10))
    maps = torch.zeros(2, 14, 6, 3)
    assert bands.rows_of(maps).shape == (2, 4, 6, 3)
    assert bands.level(torch.zeros(1, 1, 4, 6)).band == (6, 10)
    with pytest.raises(ValueError, match="padded height of 32 at maximum stride 32 has 1"):
        SpatialGroup(0, 2).bands(32, 64, 32)


# --------------------------------------------------------------------------- #
# The primitives, forward and backward
# --------------------------------------------------------------------------- #

WORLDS = {
    "2 ranks 48x32 stride 16": (2, 48, 32, 16),
    "3 ranks 56x24 stride 8": (3, 56, 24, 8),
}
EDGES = {"2 ranks 48x32 stride 16": (0, 32, 48), "3 ranks 56x24 stride 8": (0, 24, 40, 56)}
CASES = [(world, case[0]) for world, (_, h, w, _) in WORLDS.items()
         for case in primitive_cases(h, w)]


@pytest.fixture(scope="module")
def primitive_runs():
    return {world: run_ranks(check_primitives, *args) for world, args in WORLDS.items()}


@pytest.mark.parametrize("world,case", CASES)
def test_primitive_on_bands_matches_the_unsharded_op(world, case, primitive_runs):
    for rank, out in enumerate(primitive_runs[world]):
        assert out["edges"] == EDGES[world]
        errs = out[case]
        assert {"y", "dx"} <= set(errs)
        assert max(errs.values()) <= PRIMITIVE_TOL, (rank, errs)


# --------------------------------------------------------------------------- #
# One float64 step of every backbone against the JAX step
# --------------------------------------------------------------------------- #

FAMILIES = {
    "unet": ({"unet": {"max_stride": 16, "output_stride": 4, "filters": 8,
                       "up_interpolate": False}}, 4),
    "unet_up_interpolate": ({"unet": {"max_stride": 16, "output_stride": 4, "filters": 8,
                                      "up_interpolate": True}}, 4),
    **bbt.FAMILIES,
}
NO_JAX_STEP = {"hrnet"}


def _config_json(family):
    backbone, stride = FAMILIES[family]
    return json.dumps({
        "model": {"backbone": backbone,
                  "heads": {"single_instance": {"sigma": 1.5, "output_stride": stride}}},
        "optimization": {"batch_size": 2},
        "outputs": {"save_outputs": False},
    })


def _jax_float64_step(family, variables, jlabels, monkeypatch):
    """The JAX trainer's float64 ``train_step`` on ``variables`` and the
    first two examples: (loss, gradients, updated statistics)."""
    ref = JaxTrainer.from_config(JaxConfig.from_json(_config_json(family)),
                                 training_labels=jlabels, validation_labels=jlabels)
    monkeypatch.setattr(JaxModel, "init", lambda self, rng, shape, compute_dtype=jnp.float32: (
        self.make_flax_module(jnp.float64), variables))
    ref.setup()
    batch = ref.make_batch([ref._train_examples[i] for i in (0, 1)], None)
    train_step, _ = ref._build_train_step(bbt._grad_capture())
    to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
    params = to64(variables["params"])
    _, stats, grads, loss = train_step(
        params, to64(variables.get("batch_stats", {})), jax.tree.map(jnp.zeros_like, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    return float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, stats)


def _jax_hrnet_train_forward(variables, x, r):
    """The JAX HRNet's float64 train-mode forward on the NHWC batch ``x``
    (as ``test_torch_backbone_training.py``'s HRNet test runs it) and the
    gradients of the sum of its outputs times ``r``'s: (outputs,
    gradients, updated statistics)."""
    cfg = JaxConfig.from_json(_config_json("hrnet"))
    cfg.model.heads.single_instance.part_names = bbt.NODES
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_hrnet, "jnp", types.SimpleNamespace(**{**vars(jnp), "float32": jnp.float64}))
        module = JaxModel.from_config(cfg.model).make_flax_module(jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def total(params):
            out, updates = module.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                        jnp.asarray(x), train=True, mutable=["batch_stats"])
            return sum(jnp.sum(y * r[k]) for k, y in out.items()), (out, updates["batch_stats"])

        (_, (out, stats)), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(v64["params"])
        return tuple(jax.tree.map(np.asarray, t) for t in (out, grads, stats))


@pytest.fixture(scope="module")
def backbone_steps():
    """Per family: the two ranks' steps, the port's unsharded float64 step
    and the JAX step (None for HRNet), on the same seeded weights; and
    HRNet's banded train-mode forward and backward on the two ranks with
    the JAX module's (``"hrnet forward"``)."""
    labels, jlabels = bbt._labels_pair()
    payloads, unsharded, jax_steps, forwards = {}, {}, {}, {}
    monkeypatch = pytest.MonkeyPatch()
    try:
        for family in FAMILIES:
            port = tt.Trainer.from_config(TrainingJobConfig.from_json(_config_json(family)),
                                          training_labels=labels, validation_labels=labels,
                                          device="cpu")
            port.setup()
            if family == "hrnet":
                hrnet_stride = port.model.maximum_stride
            variables = flax_variables_from_state_dict(port.module)
            if variables["batch_stats"]:
                variables["batch_stats"] = bbt._seeded_running_stats(variables)
            else:
                del variables["batch_stats"]
            module = port.model.make_module(port._input_channels, compute_dtype=torch.float64)
            module.load_state_dict(state_dict_from_flax(module, variables))
            port.module = module
            payloads[family] = pickle.dumps(port)
            single = pickle.loads(payloads[family])
            single.optimizer = torch.optim.SGD(single.module.parameters(), lr=0.0)
            batch = single.to_device(single.make_batch([single._train_examples[i] for i in (0, 1)],
                                                       None))
            loss = float(single.train_step(batch, torch.Generator().manual_seed(0)))
            unsharded[family] = (
                loss, {n: p.grad.clone() for n, p in single.module.named_parameters()},
                {k: v.clone() for k, v in single.module.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}, module, variables)
            if family not in NO_JAX_STEP:
                with jax.enable_x64(True):
                    jax_steps[family] = _jax_float64_step(family, variables, jlabels, monkeypatch)
    finally:
        monkeypatch.undo()
    module, variables = unsharded["hrnet"][3:]
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, bbt.SIZE, bbt.SIZE, 1))
    with torch.no_grad():
        shapes = {k: y.shape for k, y in copy.deepcopy(module)(torch.from_numpy(x)).items()}
    r = {k: rng.normal(size=tuple(shape)) for k, shape in shapes.items()}
    forwards["hrnet forward"] = (pickle.dumps(module), torch.from_numpy(x),
                                 {k: torch.from_numpy(v) for k, v in r.items()},
                                 hrnet_stride)
    ranks = run_ranks(spatial_steps, 2, 2, payloads, (0, 1), forwards)
    out = {f: ([rank[f] for rank in ranks], unsharded[f], jax_steps.get(f)) for f in FAMILIES}
    out["hrnet forward"] = ([rank["hrnet forward"] for rank in ranks], module,
                            _jax_hrnet_train_forward(variables, x, r))
    return out


def _largest(tensors):
    return max(float(t.abs().max()) for t in tensors)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_spatial_step_matches_the_unsharded_steps(family, backbone_steps):
    ranks, (loss1, grads1, stats1, module, variables), jax_step = backbone_steps[family]
    (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b) = ranks
    assert loss_a == loss_b
    assert all(torch.equal(grads_a[n], grads_b[n]) for n in grads_a)
    assert all(torch.equal(stats_a[n], stats_b[n]) for n in stats_a)
    # Against the port's unsharded float64 step.
    assert abs(loss_a - loss1) <= STEP_LOSS_RTOL * abs(loss1), (loss_a, loss1)
    largest = _largest(grads1.values())
    for name, g in grads_a.items():
        assert float((g - grads1[name]).abs().max()) <= STEP_RTOL * largest, name
    assert bool(stats_a) == ("batch_stats" in variables)
    for name, s in stats_a.items():
        w = stats1[name]
        assert float((s - w).abs().max()) <= STEP_RTOL * float(w.abs().max()), name
    if jax_step is None:
        return
    # Against the JAX trainer's unsharded step.
    jloss, jgrads, jstats = jax_step
    assert abs(loss_a - jloss) <= LOSS_RTOL * abs(jloss), (loss_a, jloss)
    want = state_dict_from_flax(module, {"params": jgrads,
                                         **({"batch_stats": jstats} if stats_a else {})})
    jlargest = max(float(w.abs().max()) for n, w in want.items() if n in grads_a)
    for name, g in grads_a.items():
        w = want[name].double()
        scale = max(float(w.abs().max()), GRAD_RTOL * jlargest)
        assert float((g - w).abs().max()) <= GRAD_RTOL * scale, name
    for name, s in stats_a.items():
        w = want[name].double()
        assert float((s - w).abs().max()) <= STATS_RTOL * float(w.abs().max()), name


def test_hrnet_bands_match_the_jax_train_forward_and_gradients(backbone_steps):
    ranks, module, (jout, jgrads, jstats) = backbone_steps["hrnet forward"]
    (_, grads_a, stats_a), (_, grads_b, stats_b) = ranks
    assert all(torch.equal(grads_a[n], grads_b[n]) for n in grads_a)
    assert all(torch.equal(stats_a[n], stats_b[n]) for n in stats_a)
    for outputs, _, _ in ranks:
        for key, (r0, y) in outputs.items():
            want = jout[key][:, r0:r0 + y.shape[1]]
            assert y.shape == want.shape, key
            err = float(np.abs(y.numpy() - want).max())
            assert err <= STATS_RTOL * float(np.abs(jout[key]).max()), key
    assert sum(y.shape[1] for outputs, _, _ in ranks for _, y in outputs.values()) == sum(
        y.shape[1] for y in jout.values())
    want = state_dict_from_flax(module, {"params": jgrads, "batch_stats": jstats})
    largest = max(float(want[n].abs().max()) for n in grads_a)
    for name, g in grads_a.items():
        assert float((g - want[name].double()).abs().max()) <= GRAD_RTOL * largest, name
    assert stats_a
    for name, s in stats_a.items():
        w = want[name].double()
        assert float((s - w).abs().max()) <= STATS_RTOL * float(w.abs().max()), name


MIXED_LOSS_RTOL, MIXED_GRAD_RTOL = 5e-4, 5e-2


def test_mixed_precision_spatial_step_stays_within_bf16_rounding():
    """A mixed-precision step (bf16 convolutions, halos exchanged in bf16)
    of the Hourglass and the pretrained ResNet-18 on two bands against the
    unsharded mixed-precision step: the bands' convolutions round in bf16
    at other places than the whole frame's, so the two agree to bf16's
    rounding, amplified by batch norm (measured: losses 1.6e-7 and 4.9e-5
    relative, gradients 1.2e-2 and 1.3e-2 of their largest), not to
    float64's."""
    labels, _ = bbt._labels_pair()
    payloads, single = {}, {}
    for family in ("hourglass", "pretrained_resnet18"):
        cfg = json.loads(_config_json(family))
        cfg["optimization"]["mixed_precision"] = True
        port = tt.Trainer.from_config(TrainingJobConfig.from_json(json.dumps(cfg)),
                                      training_labels=labels, validation_labels=labels,
                                      device="cpu")
        port.setup()
        payloads[family] = pickle.dumps(port)
        port.make_optimizer()
        port.optimizer = torch.optim.SGD(port.module.parameters(), lr=0.0)
        batch = port.to_device(port.make_batch([port._train_examples[i] for i in (0, 1)], None))
        single[family] = (float(port.train_step(batch, torch.Generator().manual_seed(0))),
                          {n: p.grad.clone() for n, p in port.module.named_parameters()})
    ranks = run_ranks(spatial_steps, 2, 2, payloads, (0, 1))
    for family, (loss1, grads1) in single.items():
        loss, grads, _ = ranks[0][family]
        assert all(p.dtype == torch.float32 for p in grads.values())
        assert abs(loss - loss1) <= MIXED_LOSS_RTOL * abs(loss1), (family, loss, loss1)
        largest = _largest(grads1.values())
        worst = max(float((grads[n] - g).abs().max()) for n, g in grads1.items())
        assert worst <= MIXED_GRAD_RTOL * largest, (family, worst / largest)


# --------------------------------------------------------------------------- #
# tests/test_parallel.py's spatially sharded run on four ranks
# --------------------------------------------------------------------------- #

BOTTOMUP_RUN = {
    "model": {"backbone": {"unet": {"max_stride": 4, "output_stride": 2, "filters": 4,
                                    "filters_rate": 1.5}},
              "heads": {"multi_instance": {
                  "confmaps": {"output_stride": 2, "sigma": 3.0},
                  "pafs": {"output_stride": 2, "sigma": 3.0}}}},
    "data": {"preprocessing": {"pad_to_stride": 4}},
    "optimization": {"epochs": 2, "batch_size": 8, "batches_per_epoch": 2,
                     "val_batches_per_epoch": 1, "initial_learning_rate": 1e-3},
    "outputs": {"save_outputs": False},
}


def _bottomup_labels():
    """``tests/test_parallel.py``'s labels in both packages."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (6, 64, 64, 1), np.uint8)
    points = [(rng.uniform(10, 30, (2, 2)), rng.uniform(34, 54, (2, 2))) for _ in range(6)]
    out = []
    for skel_cls, inst_cls, lf_cls, labels_cls, video in (
        (Skeleton, Instance, LabeledFrame, Labels, Video),
        (JaxSkeleton, JaxInstance, JaxLabeledFrame, JaxLabels, JaxVideo),
    ):
        skel = skel_cls.from_names_and_edge_inds(["a", "b"], [(0, 1)], name="S")
        vid = video.from_numpy(frames)
        out.append(labels_cls([lf_cls(video=vid, frame_idx=i,
                                      instances=[inst_cls(skeleton=skel, points=p) for p in pts])
                               for i, pts in enumerate(points)]))
    return out


def test_four_rank_spatial_run_matches_the_jax_single_device_run(monkeypatch):
    labels, jlabels = _bottomup_labels()
    text = json.dumps(BOTTOMUP_RUN)
    ref = JaxTrainer.from_config(JaxConfig.from_json(text), training_labels=jlabels,
                                 validation_labels=jlabels)
    ref.evaluate = lambda: None
    ref.setup()
    initial = jax.tree.map(np.asarray, ref.variables["params"])
    ref.train()
    monkeypatch.setattr(tt.Trainer, "evaluate", lambda self: None)
    port = tt.Trainer.from_config(TrainingJobConfig.from_json(text), training_labels=labels,
                                  validation_labels=labels, device="cpu", n_devices=4,
                                  spatial_sharding=2)
    assert port.mesh.shape == {"data": 2, "spatial": 2}
    port.group_timeout = 60.0
    port.setup()
    port.module.load_state_dict(state_dict_from_flax(port.module, initial))
    port.train()
    want = state_dict_from_flax(port.module, jax.tree.map(np.asarray, ref.variables["params"]))
    got = port.module.state_dict()
    moved = 0
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=PARAM_RTOL, atol=PARAM_ATOL, msg=k)
        moved += not torch.equal(w, state_dict_from_flax(port.module, initial)[k])
    assert moved == len(want)
