"""Training the backbones other than the UNet: the port's trainer against the
JAX trainer, for LEAP, a 2-stack Hourglass, HRNet, ``resnet`` ResNet50 and
the pretrained-encoder UNet on a ResNet (resnet18) and an EfficientNet (b0)
encoder, at narrow widths where a family has any and 64^2 frames.

- One train step against the JAX trainer's ``_build_train_step``, from the
  port trainer's initial weights carried over to JAX with seeded running
  statistics (means N(0, 0.1^2), variances U(0.5, 2)), on one batch: the
  loss within LOSS_RTOL relative, each parameter's gradient within GRAD_RTOL
  of its largest magnitude, and each updated running statistic within
  STATS_RTOL of its largest magnitude. A gradient that batch norm makes 0
  in exact arithmetic (a bias in front of a train-mode batch norm) is held
  against GRAD_RTOL of the step's largest gradient instead. HRNet: its
  train-mode forward and updated statistics.

  Both sides run in float64 (JAX with x64 and a float64 ``compute_dtype``;
  HRNet's batch norm, float32 in the JAX module, is widened there by the
  test alone). In float32 neither framework computes this step to those
  tolerances: measured against float64, at these weights and sizes JAX's
  float32 gradients are off by up to 1e-2 (Hourglass), 2e-2 (HRNet) and
  5e-2 (ResNet50) of the step's largest gradient, and the port's by 1e-5,
  2e-3 and 2e-2. A deep network normalised by its own batch statistics at
  its initial weights amplifies rounding that much. Float32 parity of the
  port is held in inference (``tests/test_torch_backbones.py``), and of
  the train step's loss, with the whole step in float64, card against CPU
  (``chip_smoke.py`` phase 11a).
- Setup and validation move no statistic; a train step moves each once, by
  flax's rule.
- The bf16 forward of each family against the JAX module's bf16 forward:
  within BF16_ULPS bf16 ulps of the maps' largest value; batch norm keeps
  float32 parameters and statistics.
- ``Model.init`` against the JAX package's ``Model.init``: the same
  variables tree, flax's ``lecun_normal`` spread, zero biases and means,
  unit scales and variances; the pretrained encoder's ``init_weights_hook``
  reads a local ``.npz`` after it.
- ``mixed_precision`` keeps float32 parameters, statistics and optimizer
  state; a trained batch-norm run folder loads and predicts as its
  ``best_model.pt`` does; ``sleap-train --cpu`` trains a Hourglass.
"""

import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
import sleap_tpu_torch
from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.core.instance import Instance, LabeledFrame
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io.video import Video
from sleap_tpu_torch.models.encoder_decoder import FlaxBatchNorm2d
from sleap_tpu_torch.models.model import Model
from sleap_tpu_torch.models.params import flax_variables_from_state_dict, state_dict_from_flax
from sleap_tpu_torch.training import trainer as tt
from test_torch_backbones import _flat, seeded_variables

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATS_RTOL = 1e-5
# bf16 forward: each framework rounds every layer's output to bf16 at its own
# places; measured on these configs, the largest difference at the maps'
# largest value is 6.75 ulps through HRNet's ~300 layers and 1-2.25 ulps on
# the other families.
BF16_ULPS = 12
SIZE = 64
NODES = ["n0", "n1", "n2"]

FAMILIES = {
    "leap": ({"leap": {"max_stride": 8, "output_stride": 2, "filters": 8}}, 2),
    "hourglass": ({"hourglass": {"stem_stride": 4, "max_stride": 32, "output_stride": 4,
                                 "stem_filters": 8, "filters": 8, "filter_increase": 4,
                                 "stacks": 2}}, 4),
    "hrnet": ({"hrnet": {"C": 4, "stem_filters": 8, "deconv_filters": 8}}, 2),
    "resnet": ({"resnet": {"weights": "random", "max_stride": 16, "output_stride": 4}}, 4),
    "pretrained_resnet18": ({"pretrained_encoder": {
        "encoder": "resnet18", "pretrained": False, "decoder_filters": 8, "output_stride": 4}}, 4),
    "pretrained_efficientnetb0": ({"pretrained_encoder": {
        "encoder": "efficientnetb0", "pretrained": False, "decoder_filters": 8,
        "output_stride": 4}}, 4),
}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _labels_pair(n_frames=4, seed=0):
    """The same labels in both packages: uint8 noise frames of SIZE^2, one
    animal of three nodes a frame."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n_frames, SIZE, SIZE, 1), np.uint8)
    pts = rng.uniform(8, SIZE - 8, (n_frames, len(NODES), 2))
    out = []
    for skel_cls, inst_cls, lf_cls, labels_cls, video in (
        (Skeleton, Instance, LabeledFrame, Labels, Video),
        (JaxSkeleton, JaxInstance, JaxLabeledFrame, JaxLabels, JaxVideo),
    ):
        skel = skel_cls("chain")
        for n in NODES:
            skel.add_node(n)
        skel.add_edge("n0", "n1")
        skel.add_edge("n1", "n2")
        vid = video.from_numpy(frames)
        out.append(labels_cls([lf_cls(vid, i, [inst_cls(skel, pts[i])]) for i in range(n_frames)]))
    return out


def _config_json(family, **optimization):
    backbone, stride = FAMILIES[family]
    return json.dumps({
        "model": {"backbone": backbone,
                  "heads": {"single_instance": {"sigma": 1.5, "output_stride": stride}}},
        "optimization": {"batch_size": 2, **optimization},
        "outputs": {"save_outputs": False},
    })


def _port_trainer(family, labels=None, **optimization):
    if labels is None:
        labels, _ = _labels_pair()
    trainer = tt.Trainer.from_config(TrainingJobConfig.from_json(_config_json(family, **optimization)),
                                     training_labels=labels, validation_labels=labels, device="cpu")
    trainer.setup()
    return trainer


def _seeded_running_stats(variables, seed=1):
    rng = np.random.default_rng(seed)
    stats = {}
    for layer, leaves in _flat(variables["batch_stats"]).items():
        stats[layer] = (rng.normal(size=leaves.shape) * 0.1 if layer.endswith("mean")
                        else rng.uniform(0.5, 2.0, leaves.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: stats["/".join(str(k.key) for k in p)], variables["batch_stats"])


def _grad_capture():
    """An optax transformation whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def _jax_float64_step(family, variables, monkeypatch):
    """The JAX trainer's ``train_step`` in float64 on ``variables`` and its
    first two examples: returns (loss, gradients, updated batch_stats)."""
    _, jlabels = _labels_pair()
    ref = JaxTrainer.from_config(JaxConfig.from_json(_config_json(family)),
                                 training_labels=jlabels, validation_labels=jlabels)
    # The port's initial weights stand for JAX's (flax's init takes tens of
    # seconds for the deep families; ``test_init_matches_flax`` holds the two
    # inits alike).
    monkeypatch.setattr(JaxModel, "init", lambda self, rng, shape, compute_dtype=jnp.float32: (
        self.make_flax_module(jnp.float64), variables))
    ref.setup()
    batch = ref.make_batch([ref._train_examples[i] for i in (0, 1)], None)
    train_step, _ = ref._build_train_step(_grad_capture())
    to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
    params = to64(variables["params"])
    _, new_stats, grads, loss = train_step(
        params, to64(variables.get("batch_stats", {})), jax.tree.map(jnp.zeros_like, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    return float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new_stats)


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "hrnet"])
def test_train_step_matches_jax(family, monkeypatch):
    port = _port_trainer(family)
    variables = flax_variables_from_state_dict(port.module)
    has_bn = bool(variables["batch_stats"])
    if has_bn:
        variables["batch_stats"] = _seeded_running_stats(variables)
    else:
        del variables["batch_stats"]
    with jax.enable_x64(True):
        jloss, jgrads, jstats = _jax_float64_step(family, variables, monkeypatch)

    module = port.model.make_module(port._input_channels, compute_dtype=torch.float64)
    module.load_state_dict(state_dict_from_flax(module, variables))
    port.module = module
    port.optimizer = torch.optim.SGD(module.parameters(), lr=0.0)  # the gradients stay put
    batch = port.to_device(port.make_batch([port._train_examples[i] for i in (0, 1)], None))
    loss = float(port.train_step(batch, torch.Generator().manual_seed(0)))
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)

    want = state_dict_from_flax(module, {"params": jgrads, **({"batch_stats": jstats} if has_bn
                                                              else {})})
    grads = {n: p.grad for n, p in module.named_parameters()}
    largest = max(float(w.abs().max()) for n, w in want.items() if n in grads)
    for name, g in grads.items():
        w = want[name].double()
        scale = max(float(w.abs().max()), GRAD_RTOL * largest)
        assert float((g - w).abs().max()) <= GRAD_RTOL * scale, name
    stats = {k: v for k, v in module.state_dict().items() if k.endswith(("running_mean",
                                                                         "running_var"))}
    assert bool(stats) == has_bn
    before = state_dict_from_flax(module, variables)
    for name, s in stats.items():
        w = want[name].double()
        assert float((s - w).abs().max()) <= STATS_RTOL * float(w.abs().max()), name
        assert not torch.equal(s, before[name].double()), name  # it moved


def test_hrnet_train_forward_matches_jax(monkeypatch):
    """HRNet in train mode against ``module.apply(..., train=True,
    mutable=["batch_stats"])``, in float64: the head outputs within
    STATS_RTOL of their largest value, every updated statistic within
    STATS_RTOL of its largest. Its train step is not compared: both
    trainers cast the heads' outputs to float32 for the loss, and HRNet at
    its initial weights amplifies a one-ulp difference there to 4e-3 of a
    gradient's largest value, float64 layers or not (and the JAX step of
    its several hundred layers takes two minutes to compile). Its backward
    runs only ops that the other families' steps hold."""
    port = _port_trainer("hrnet")
    variables = flax_variables_from_state_dict(port.module)
    variables["batch_stats"] = _seeded_running_stats(variables)
    cfg = JaxConfig.from_json(_config_json("hrnet"))
    cfg.model.heads.single_instance.part_names = NODES
    x = np.random.default_rng(3).uniform(0, 1, (2, SIZE, SIZE, 1))
    monkeypatch.setattr(jax_hrnet, "jnp", types.SimpleNamespace(
        **{**vars(jnp), "float32": jnp.float64}))
    with jax.enable_x64(True):
        module = JaxModel.from_config(cfg.model).make_flax_module(jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, updates = jax.jit(lambda v, x: module.apply(v, x, train=True, mutable=["batch_stats"]))(
            v64, jnp.asarray(x))
        want = jax.tree.map(np.asarray, want)
        stats = jax.tree.map(np.asarray, updates["batch_stats"])
    net = port.model.make_module(1, compute_dtype=torch.float64)
    net.load_state_dict(state_dict_from_flax(net, variables))
    with torch.no_grad():
        got = net.train()(torch.from_numpy(x))
    for key, ref in want.items():
        err = float(np.abs(got[key].numpy() - ref).max())
        assert err <= STATS_RTOL * float(np.abs(ref).max()), key
    expected = state_dict_from_flax(net, {"params": variables["params"], "batch_stats": stats})
    for name, s in _bn_state(net).items():
        w = expected[name].double()
        assert float((s - w).abs().max()) <= STATS_RTOL * float(w.abs().max()), name


def _bn_state(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_statistics_move_once_a_step_and_never_in_setup_or_validation():
    """After setup the statistics are flax's init (0 and 1: no forward ran);
    a validation step leaves them; a train step moves each once, by flax's
    rule from that step's batch (checked on the first layer, whose input is
    the batch itself)."""
    port = _port_trainer("hourglass")
    stats = _bn_state(port.module)
    for k, v in stats.items():
        assert torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v)), k
    port.make_optimizer()
    gen = torch.Generator().manual_seed(0)
    batch = port.to_device(port.make_batch([port._train_examples[i] for i in (0, 1)], None))
    port.val_step(batch, gen)
    assert all(torch.equal(v, stats[k]) for k, v in _bn_state(port.module).items())

    seen = {}
    layer = port.module.backbone.layers["stem0_conv7x7_bn"]
    hook = layer.register_forward_pre_hook(lambda m, args: seen.setdefault("x", []).append(args[0]))
    running = (layer.running_mean.clone(), layer.running_var.clone())
    port.train_step(batch, gen)
    hook.remove()
    assert len(seen["x"]) == 1
    x = seen["x"][0].detach().double()
    mean = x.mean((0, 2, 3))
    var = (x.square().mean((0, 2, 3)) - mean.square()).clamp_min(0)
    m = layer.momentum
    torch.testing.assert_close(layer.running_mean.double(), m * running[0] + (1 - m) * mean,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(layer.running_var.double(), m * running[1] + (1 - m) * var,
                               rtol=0, atol=1e-6)
    assert all(not torch.equal(v, stats[k]) for k, v in _bn_state(port.module).items())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_forward_matches_jax(family):
    cfg = JaxConfig.from_json(_config_json(family))
    cfg.model.heads.single_instance.part_names = NODES
    module = JaxModel.from_config(cfg.model).make_flax_module(jnp.bfloat16)
    x = np.random.default_rng(2).uniform(0, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)),
                                                train=False))
    variables = seeded_variables(shapes, seed=4)
    want = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, jnp.asarray(x))

    tcfg = TrainingJobConfig.from_json(_config_json(family))
    tcfg.model.heads.single_instance.part_names = NODES
    net = Model.from_config(tcfg.model).make_module(1, compute_dtype=torch.bfloat16)
    net.load_state_dict(state_dict_from_flax(net, variables))
    bns = [m for m in net.modules() if isinstance(m, FlaxBatchNorm2d)]
    assert bool(bns) == (family != "leap")
    assert all(t.dtype == torch.float32 for m in bns for t in (*m.parameters(), *m.buffers()))
    assert all(p.dtype == torch.bfloat16 for n, p in net.named_parameters() if "_bn" not in n
               and not any(p is q for m in bns for q in m.parameters()))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    assert set(got) == set(want)
    for key, ref in want.items():
        ref = np.asarray(ref.astype(jnp.float32))
        out = got[key]
        assert out.dtype == torch.bfloat16 and out.shape == ref.shape
        top = float(np.abs(ref).max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        assert float(np.abs(out.float().numpy() - ref).max()) <= BF16_ULPS * ulp, key


@pytest.mark.parametrize("family", ["leap", "hourglass", "pretrained_resnet18"])
def test_init_matches_flax(family):
    """``Model.init`` against the JAX package's ``Model.init``: the same
    variables tree; every kernel within flax's ``lecun_normal`` cut at 2
    standard deviations, and, pooled over all kernels with each divided by
    its layer's ``sqrt(1 / fan_in)``, of unit spread within 2% on both
    sides; biases and running means 0; batch-norm scales and running
    variances 1."""
    port = _port_trainer(family)
    ours = _flat(flax_variables_from_state_dict(port.module))
    cfg = JaxConfig.from_json(_config_json(family))
    cfg.model.heads.single_instance.part_names = NODES
    _, theirs = JaxModel.from_config(cfg.model).init(jax.random.PRNGKey(0), (SIZE, SIZE, 1))
    theirs = _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    pooled = {"ours": [], "theirs": []}
    for name, a in ours.items():
        b = theirs[name]
        assert a.shape == b.shape, name
        leaf = name.rsplit("/", 1)[-1]
        if leaf != "kernel":
            fill = 1.0 if leaf in ("scale", "var") else 0.0
            np.testing.assert_array_equal(a, fill, err_msg=name)
            np.testing.assert_array_equal(b, fill, err_msg=name)
            continue
        std = math.sqrt(1.0 / math.prod(a.shape[:-1]))
        assert np.abs(a).max() <= 2 * std / 0.87962566 + 1e-6, name
        pooled["ours"].append(a.ravel() / std)
        pooled["theirs"].append(np.asarray(b).ravel() / std)
    for side, parts in pooled.items():
        z = np.concatenate(parts)
        assert z.size > 20000 and abs(z.std() - 1) < 0.02, (side, z.size, z.std())


def test_init_hook_reads_local_npz(tmp_path, monkeypatch):
    """A pretrained encoder's trainer starts from flax's init with the local
    ``.npz`` merged over it, as JAX's ``Model.init`` runs the hook after
    ``module.init``: the file's arrays, kernels and statistics, land in the
    module; everything else keeps the seeded init."""
    plain = flax_variables_from_state_dict(_port_trainer("pretrained_resnet18").module)
    rng = np.random.default_rng(5)
    arrays = {name: rng.normal(size=a.shape).astype(np.float32)
              for col in ("params", "batch_stats") for name, a in _flat(plain[col]).items()
              if "/stem_" in name or "/stage1_block1_" in name}
    np.savez(tmp_path / "resnet18.npz", **arrays)
    monkeypatch.setenv("SLEAP_TPU_PRETRAINED_DIR", str(tmp_path))
    labels, _ = _labels_pair()
    cfg = TrainingJobConfig.from_json(_config_json("pretrained_resnet18"))
    cfg.model.backbone.pretrained_encoder.pretrained = True
    trainer = tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                     device="cpu")
    trainer.setup()
    got = flax_variables_from_state_dict(trainer.module)
    flat = {**_flat(got["params"]), **_flat(got["batch_stats"])}
    flat_plain = {**_flat(plain["params"]), **_flat(plain["batch_stats"])}
    assert len(arrays) > 10
    for name, a in flat.items():
        np.testing.assert_array_equal(a, arrays.get(name, flat_plain[name]), err_msg=name)


def test_mixed_precision_keeps_batch_norm_float32():
    port = _port_trainer("pretrained_efficientnetb0", mixed_precision=True)
    port.make_optimizer()
    gen = torch.Generator().manual_seed(0)
    before = _bn_state(port.module)
    batch = port.to_device(port.make_batch([port._train_examples[i] for i in (0, 1)], None))
    losses = [port.train_step(batch, gen) for _ in range(2)]
    assert all(l.dtype == torch.float32 and torch.isfinite(l) for l in losses)
    assert all(p.dtype == torch.float32 for p in port.module.parameters())
    after = _bn_state(port.module)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in after.values())
    assert all(not torch.equal(v, before[k]) for k, v in after.items())
    assert all(s.dtype == torch.float32 for st in port.optimizer.state.values()
               for s in st.values() if torch.is_tensor(s) and s.ndim > 0)
    with port._autocast():
        out = port.module(port.build_gt_fn()(batch, gen)[0])
    assert all(v.dtype == torch.bfloat16 for v in out.values())


def test_trained_batch_norm_folder_loads_and_predicts(tmp_path):
    """Two epochs of a 2-stack Hourglass: ``best_model.pt`` carries running
    statistics that moved from the init; ``load_trained_model`` reads them
    back; the folder predicts as the same weights handed over as flax
    variables do, in float32 and in bf16."""
    from sleap_tpu_torch.inference.predictors import load_trained_model

    labels, _ = _labels_pair(n_frames=6)
    cfg = TrainingJobConfig.from_json(_config_json("hourglass", epochs=2, batches_per_epoch=2,
                                                   val_batches_per_epoch=1))
    cfg.outputs.save_outputs = True
    cfg.outputs.runs_folder, cfg.outputs.run_name = str(tmp_path), "hg"
    trainer = tt.Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                     device="cpu")
    trainer.train()
    folder = str(tmp_path / "hg")
    best = torch.load(tmp_path / "hg" / "best_model.pt", weights_only=True)
    means = [v for k, v in best.items() if k.endswith("running_mean")]
    variances = [v for k, v in best.items() if k.endswith("running_var")]
    assert means and all(bool(v.abs().max() > 0) for v in means)
    assert all(not torch.equal(v, torch.ones_like(v)) for v in variances)
    tm = load_trained_model(folder, device="cpu")
    assert not tm.module.training
    for k, v in tm.module.state_dict().items():
        assert torch.equal(v, best[k]), k
    frames = labels.video.data[:4]
    variables = flax_variables_from_state_dict(tm.module)
    for dtype in (torch.float32, torch.bfloat16):
        got = sleap_tpu_torch.load_model(folder, device="cpu", peak_threshold=0.0,
                                         compute_dtype=dtype).predict(frames, make_labels=False)
        want = sleap_tpu_torch.load_model(folder, device="cpu", peak_threshold=0.0,
                                          compute_dtype=dtype, params={folder: variables}).predict(
            frames, make_labels=False)
        for g, w in zip(got, want):
            for k in ("instance_peaks", "instance_peak_vals"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_cli_trains_a_batch_norm_backbone(tmp_path, capsys):
    """``sleap-train --cpu`` of the shipped single-instance profile with a
    2-stack Hourglass in place of its UNet, on ``tests/torch_data/pkg.slp``:
    the run folder's ``best_model.pt`` holds statistics that moved, and
    ``sleap-inspect`` names the backbone."""
    from pathlib import Path

    from sleap_tpu_torch.cli import train as cli_train
    from sleap_tpu_torch.info import labels as info

    repo = Path(__file__).resolve().parent.parent
    cfg = json.loads((repo / "sleap_tpu_torch" / "training_profiles" /
                      "baseline_large_rf.single.json").read_text())
    cfg["model"]["backbone"] = {"hourglass": {"stem_stride": 4, "max_stride": 16,
                                              "output_stride": 4, "stem_filters": 4,
                                              "filters": 4, "filter_increase": 4, "stacks": 2}}
    cfg["optimization"].update(epochs=1, batches_per_epoch=2, val_batches_per_epoch=1)
    cfg["outputs"]["runs_folder"] = str(tmp_path)
    profile = tmp_path / "hourglass.json"
    profile.write_text(json.dumps(cfg))
    cli_train.main([str(profile), str(repo / "tests" / "torch_data" / "pkg.slp"), "--cpu",
                    "--run_name", "hg"])
    best = torch.load(tmp_path / "hg" / "best_model.pt", weights_only=True)
    variances = [v for k, v in best.items() if k.endswith("running_var")]
    assert variances and all(not torch.equal(v, torch.ones_like(v)) for v in variances)
    capsys.readouterr()
    info.main([str(tmp_path / "hg")])
    out = capsys.readouterr().out
    assert "  backbone: hourglass" in out and "  head: single_instance" in out
