"""The port's run-folder reading against the JAX package's: for every
``training_config.json`` in ``.convergence_runs``, the port's config and
``sleap_tpu.config.TrainingJobConfig.load_json`` give the same head type,
part names, edges, strides, preprocessing, crop size and UNet fields, and
the same skeleton nodes and edges. The port writes configs the JAX package
reads, and its weights bridge round-trips: ``state_dict_from_flax`` of
``flax_from_state_dict`` gives back the module's weights, float32 and bf16.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sleap_tpu.config import TrainingJobConfig as JaxConfig
from sleap_tpu_torch.config import (
    BackboneConfig,
    DataConfig,
    HeadsConfig,
    LabelsConfig,
    ModelConfig,
    MultiInstanceConfig,
    MultiInstanceConfmapsHeadConfig,
    PartAffinityFieldsHeadConfig,
    PreprocessingConfig,
    TrainingJobConfig,
    UNetConfig,
)
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.models.model import Model, init_params
from sleap_tpu_torch.models.params import flax_from_state_dict, state_dict_from_flax

torch.set_num_threads(1)

RUNS = Path(__file__).resolve().parent.parent / ".convergence_runs"
RUN_NAMES = sorted(p.name for p in RUNS.iterdir() if (p / "training_config.json").exists())
UNET_FIELDS = ("stem_stride", "max_stride", "output_stride", "filters", "filters_rate",
               "middle_block", "up_interpolate", "stacks", "space_to_depth")


def _fields(cfg):
    """What inference reads from a config, from either package's."""
    heads = cfg.model.heads
    hc = heads.which_oneof
    confmaps = getattr(hc, "confmaps", hc)
    pafs = getattr(hc, "pafs", None)
    unet = cfg.model.backbone.unet
    pp = cfg.data.preprocessing
    return {
        "head": heads.which_oneof_attrib_name,
        "backbone": cfg.model.backbone.which_oneof_attrib_name,
        "part_names": getattr(confmaps, "part_names", None),
        "anchor_part": getattr(confmaps, "anchor_part", None),
        "edges": None if pafs is None or pafs.edges is None else [list(e) for e in pafs.edges],
        "strides": (confmaps.output_stride, None if pafs is None else pafs.output_stride),
        "offset_refinement": getattr(confmaps, "offset_refinement", None),
        "input_scaling": pp.input_scaling,
        "pad_to_stride": pp.pad_to_stride,
        "imagenet_mode": pp.imagenet_mode,
        "crop_size": cfg.data.instance_cropping.crop_size,
        "unet": None if unet is None else {f: getattr(unet, f) for f in UNET_FIELDS},
    }


def _skeletons(cfg):
    return [(list(s.node_names), [tuple(e) for e in s.edge_names]) for s in cfg.data.labels.skeletons]


def test_every_run_folder_is_covered():
    assert len(RUN_NAMES) == 5
    heads = {TrainingJobConfig.load_json(str(RUNS / r)).model.heads.which_oneof_attrib_name
             for r in RUN_NAMES}
    assert heads == {"centroid", "centered_instance", "single_instance", "multi_instance",
                     "multi_class_topdown"}


@pytest.mark.parametrize("run", RUN_NAMES)
def test_config_matches_jax(run):
    got = TrainingJobConfig.load_json(str(RUNS / run))
    want = JaxConfig.load_json(str(RUNS / run))
    assert _fields(got) == _fields(want)
    assert got.filename == want.filename


@pytest.mark.parametrize("run", RUN_NAMES)
def test_skeleton_matches_jax(run):
    got = TrainingJobConfig.load_json(str(RUNS / run))
    want = JaxConfig.load_json(str(RUNS / run))
    assert _skeletons(got) == _skeletons(want)
    assert len(got.data.labels.skeletons) >= 1


def test_jsonpickle_ids_and_edge_order_match_jax():
    """A skeleton whose links reuse nodes by ``py/id``, list edges out of
    insertion order and carry a symmetry pair decodes as in the JAX package."""
    from sleap_tpu.core.skeleton import Skeleton as JaxSkeleton

    node = lambda name: {"py/object": "sleap.skeleton.Node", "py/state": {"py/tuple": [name, 1.0]}}
    body = {"py/reduce": [{"py/type": "sleap.skeleton.EdgeType"}, {"py/tuple": [1]}]}
    sym = {"py/reduce": [{"py/type": "sleap.skeleton.EdgeType"}, {"py/tuple": [2]}]}
    d = {
        "directed": True, "graph": {"name": "s", "num_edges_inserted": 3}, "multigraph": True,
        "links": [
            {"edge_insert_idx": 2, "key": 0, "source": node("c"), "target": node("d"), "type": body},
            {"edge_insert_idx": 0, "key": 0, "source": node("a"), "target": node("b"), "type": {"py/id": 3}},
            {"key": 0, "source": {"py/id": 4}, "target": {"py/id": 5}, "type": sym},
            {"edge_insert_idx": 1, "key": 0, "source": {"py/id": 5}, "target": {"py/id": 1},
             "type": {"py/id": 3}},
        ],
        "nodes": [{"id": {"py/id": 4}}, {"id": {"py/id": 1}}, {"id": {"py/id": 5}}, {"id": {"py/id": 2}}],
    }
    got, want = Skeleton.from_dict(d), JaxSkeleton.from_dict(d)
    assert got.node_names == want.node_names == ["a", "c", "b", "d"]
    assert got.edge_names == [tuple(e) for e in want.edge_names] == [("a", "b"), ("b", "c"), ("c", "d")]


def test_written_config_reads_back_in_both_packages(tmp_path):
    skel = Skeleton("chain")
    for n in ("head", "thorax", "tail"):
        skel.add_node(n)
    skel.add_edge("head", "thorax")
    skel.add_edge("thorax", "tail")
    cfg = TrainingJobConfig(
        data=DataConfig(labels=LabelsConfig(skeletons=[skel]),
                        preprocessing=PreprocessingConfig(input_scaling=0.5, pad_to_stride=16)),
        model=ModelConfig(
            backbone=BackboneConfig(unet=UNetConfig(filters=8, output_stride=4, space_to_depth=4)),
            heads=HeadsConfig(multi_instance=MultiInstanceConfig(
                confmaps=MultiInstanceConfmapsHeadConfig(output_stride=4),
                pafs=PartAffinityFieldsHeadConfig(output_stride=8))),
        ),
    )
    path = tmp_path / "training_config.json"
    cfg.save_json(str(path))
    written = json.loads(path.read_text())
    written["unknown"] = {"ignored": True}
    written["model"]["heads"]["multi_instance"]["pafs"]["unknown"] = 1
    path.write_text("// a comment line\n" + json.dumps(written, indent=4))
    got, want = TrainingJobConfig.load_json(str(tmp_path)), JaxConfig.load_json(str(tmp_path))
    assert _fields(got) == _fields(want) == _fields(cfg)
    assert _skeletons(got) == _skeletons(want) == [(["head", "thorax", "tail"],
                                                    [("head", "thorax"), ("thorax", "tail")])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flax_params_round_trip(dtype):
    cfg = TrainingJobConfig.load_json(str(RUNS / "minimal_instance.UNet.bottomup"))
    model = Model.from_config(cfg.model, skeleton=cfg.data.labels.skeletons[0])
    module = init_params(model.make_module(1, dtype), torch.Generator().manual_seed(0))
    state = module.state_dict()
    tree = flax_from_state_dict(module)
    assert set(tree) == {"backbone", "MultiInstanceConfmapsHead", "PartAffinityFieldsHead",
                         "OffsetRefinementHead"}
    # HWIO kernels, the layout of the JAX package's params.
    head = state["heads.PartAffinityFieldsHead.weight"].float().numpy()
    np.testing.assert_array_equal(tree["PartAffinityFieldsHead"]["kernel"][0, 0], head[:, :, 0, 0].T)
    back = state_dict_from_flax(module, tree)
    assert set(back) == set(state)
    for key, value in state.items():
        assert torch.equal(back[key].to(dtype), value), key


def _symmetric_skeleton(cls):
    skel = cls("mouse")
    for n in ("nose", "l_ear", "r_ear", "tail", "l_paw", "r_paw"):
        skel.add_node(n)
    for a, b in (("nose", "l_ear"), ("nose", "r_ear"), ("nose", "tail"), ("tail", "r_paw")):
        skel.add_edge(a, b)
    skel.add_symmetry("r_paw", "l_paw")
    skel.add_symmetry("l_ear", "r_ear")
    return skel


def test_skeleton_symmetries_match_jax():
    """Symmetric pairs, their indices, ``flip_idx``, ``edge_inds`` and the
    written form equal the JAX package's, and survive a round trip through
    either package's reader."""
    from sleap_tpu.core.skeleton import Skeleton as JaxSkeleton

    got, want = _symmetric_skeleton(Skeleton), _symmetric_skeleton(JaxSkeleton)
    assert got.symmetric_inds == want.symmetric_inds == [(1, 2), (4, 5)]
    assert got.symmetry_names == want.symmetry_names
    assert got.flip_idx() == want.flip_idx() == [0, 2, 1, 3, 5, 4]
    assert got.edge_inds == want.edge_inds and got.n_nodes == want.n_nodes == 6
    assert got.to_dict() == want.to_dict()
    for d in (got.to_dict(), want.to_dict()):
        a, b = Skeleton.from_dict(d), JaxSkeleton.from_dict(d)
        assert a.symmetric_inds == b.symmetric_inds == want.symmetric_inds
        assert a.flip_idx() == b.flip_idx() == want.flip_idx()
        assert a.to_dict() == b.to_dict()
    with pytest.raises(ValueError):
        got.add_symmetry("l_ear", "tail")


def _training_config_json(skeleton) -> dict:
    """A training config far from the defaults in every section."""
    from sleap_tpu_torch import config as c

    cfg = c.TrainingJobConfig(
        data=c.DataConfig(
            labels=c.LabelsConfig(skeletons=[skeleton], validation_fraction=0.2,
                                  split_by_inds=True, training_inds=[0, 2],
                                  validation_inds=[1], search_path_hints=["x"]),
            preprocessing=c.PreprocessingConfig(ensure_rgb=True, input_scaling=0.5,
                                                target_height=64, target_width=80),
            instance_cropping=c.InstanceCroppingConfig(center_on_part="nose", crop_size=96,
                                                       crop_size_detection_padding=8),
        ),
        model=c.ModelConfig(
            backbone=c.BackboneConfig(unet=c.UNetConfig(filters=16, up_interpolate=True)),
            heads=c.HeadsConfig(multi_class_topdown=c.MultiClassTopDownConfig(
                confmaps=c.CenteredInstanceConfmapsHeadConfig(sigma=2.5, output_stride=4),
                class_vectors=c.ClassVectorsHeadConfig(classes=["a", "b"], loss_weight=0.5))),
            base_checkpoint="models/base",
        ),
        optimization=c.OptimizationConfig(
            augmentation_config=c.AugmentationConfig(rotate=True, rotation_min_angle=-15,
                                                     random_flip=True, flip_horizontal=False,
                                                     contrast=True),
            batch_size=16, epochs=3, optimizer="amsgrad", initial_learning_rate=3e-4,
            learning_rate_schedule=c.LearningRateScheduleConfig(plateau_patience=2),
            hard_keypoint_mining=c.HardKeypointMiningConfig(online_mining=True,
                                                            max_hard_keypoints=4),
            early_stopping=c.EarlyStoppingConfig(plateau_patience=7),
            mixed_precision=True,
        ),
        outputs=c.OutputsConfig(
            run_name="run", runs_folder="somewhere", tags=["t"], zip_outputs=True,
            checkpointing=c.CheckpointingConfig(latest_model=True, final_model=True),
            tensorboard=c.TensorBoardConfig(loss_frequency="batch"),
            zmq=c.ZMQConfig(controller_polling_timeout=5),
        ),
        name="job", description="a job",
    )
    return cfg


def test_training_config_round_trips_between_packages(tmp_path):
    """A full training config (optimization, outputs, a skeleton with
    symmetries) written by the port reads back equal in the JAX package, and
    the JAX package's own writing of it reads back equal in the port."""
    cfg = _training_config_json(_symmetric_skeleton(Skeleton))
    port_json = json.loads(cfg.to_json())
    cfg.save_json(str(tmp_path / "port.json"))
    jax_cfg = JaxConfig.load_json(str(tmp_path / "port.json"))
    jax_json = json.loads(jax_cfg.to_json())
    for d in (port_json, jax_json):
        d.pop("filename")
    assert jax_json == port_json
    assert jax_cfg.data.labels.skeletons[0].flip_idx() == [0, 2, 1, 3, 5, 4]
    assert jax_cfg.optimization.augmentation_config.rotation_min_angle == -15
    jax_cfg.save_json(str(tmp_path / "jax.json"))
    back = TrainingJobConfig.load_json(str(tmp_path / "jax.json"))
    back_json = json.loads(back.to_json())
    back_json.pop("filename")
    assert back_json == jax_json
    assert back.outputs.run_path == jax_cfg.outputs.run_path


def _attrs_fields(cls):
    import attr

    return {f.name: f for f in attr.fields(cls)}


def test_every_jax_config_field_exists_in_the_port():
    """Same classes, same field names in the same order, same plain
    defaults, all the way down from ``TrainingJobConfig`` (the port keeps
    the non-UNet backbones as raw dicts): nothing a JAX config holds is
    dropped when the port reads it."""
    import dataclasses

    import attr

    from sleap_tpu import config as jc
    from sleap_tpu_torch import config as pc

    checked = []

    def walk(jax_cls, port_cls):
        checked.append(jax_cls.__name__)
        jf = _attrs_fields(jax_cls)
        pf = {f.name: f for f in dataclasses.fields(port_cls)}
        assert list(jf) == list(pf), jax_cls.__name__
        for name, f in jf.items():
            default = f.default
            if isinstance(default, attr.Factory):
                inner = getattr(pc, getattr(default.factory, "__name__", ""), None)
                if inner is not None and dataclasses.is_dataclass(inner):
                    walk(default.factory, inner)
                continue
            assert pf[name].default == default, (jax_cls.__name__, name)
            target = getattr(pc, str(f.type).replace("Optional[", "").rstrip("]"), None)
            jtarget = getattr(jc, str(f.type).replace("Optional[", "").rstrip("]"), None)
            if jtarget is not None and attr.has(jtarget) and target is not None:
                if dataclasses.is_dataclass(target):
                    walk(jtarget, target)

    walk(jc.TrainingJobConfig, pc.TrainingJobConfig)
    for name in ("OptimizationConfig", "AugmentationConfig", "OutputsConfig", "ZMQConfig",
                 "HeadsConfig", "MultiClassTopDownConfig", "UNetConfig", "LabelsConfig",
                 "InstanceCroppingConfig", "PreprocessingConfig", "EarlyStoppingConfig"):
        assert name in checked, name


def _backbone(module, name):
    """A non-default backbone config of ``module`` (either package's config
    module): every field away from its default."""
    m = module
    return {
        "leap": lambda: m.LEAPConfig(max_stride=16, output_stride=2, filters=32, filters_rate=1.5,
                                     up_interpolate=True, stacks=2),
        "hourglass": lambda: m.HourglassConfig(stem_stride=2, max_stride=32, output_stride=8,
                                               stem_filters=64, filters=128, filter_increase=64,
                                               stacks=2),
        "resnet": lambda: m.ResNetConfig(
            version="ResNet101", weights="random", max_stride=16, output_stride=2,
            upsampling=m.UpsamplingConfig(method="transposed_conv", skip_connections="add",
                                          block_stride=4, filters=32, filters_rate=2.0,
                                          refine_convs=1, batch_norm=False,
                                          transposed_conv_kernel_size=3)),
        "resnet_defaults": lambda: m.ResNetConfig(),
        "pretrained_encoder": lambda: m.PretrainedEncoderConfig(
            encoder="resnet50", pretrained=False, decoder_filters=128, decoder_filters_rate=0.5,
            output_stride=4, decoder_batchnorm=False),
        "hrnet": lambda: m.HRNetConfig(C=32, initial_downsampling_steps=3, n_deconv_modules=2,
                                       bottleneck=True, deconv_filters=128,
                                       bilinear_upsampling=True, stem_filters=32),
    }[name]()


BACKBONE_NAMES = ["leap", "hourglass", "resnet", "resnet_defaults", "pretrained_encoder", "hrnet"]


def _backbone_dict(cfg):
    """The backbone oneof of a loaded config as plain data, from either package."""
    import attr
    import dataclasses

    bb = cfg.model.backbone
    value = bb.which_oneof
    as_dict = attr.asdict(value) if attr.has(type(value)) else dataclasses.asdict(value)
    return bb.which_oneof_attrib_name, as_dict


@pytest.mark.parametrize("name", BACKBONE_NAMES)
def test_backbone_config_json_round_trips_with_jax(name, tmp_path):
    """Each backbone config written by the port reads back equal in the
    JAX package and in the port, and the JAX package's reads in the port."""
    from sleap_tpu import config as jc
    from sleap_tpu_torch import config as tcfg

    oneof = name.split("_defaults")[0]
    ours = TrainingJobConfig(model=ModelConfig(backbone=BackboneConfig(**{oneof: _backbone(tcfg, name)})))
    theirs = JaxConfig(model=jc.ModelConfig(backbone=jc.BackboneConfig(**{oneof: _backbone(jc, name)})))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours.save_json(str(tmp_path / "a" / "training_config.json"))
    theirs.save_json(str(tmp_path / "b" / "training_config.json"))
    want = _backbone_dict(theirs)
    assert want[0] == oneof
    assert _backbone_dict(ours) == want
    assert _backbone_dict(JaxConfig.load_json(str(tmp_path / "a"))) == want
    assert _backbone_dict(TrainingJobConfig.load_json(str(tmp_path / "a"))) == want
    assert _backbone_dict(TrainingJobConfig.load_json(str(tmp_path / "b"))) == want


def test_backbone_config_defaults_match_jax():
    import attr
    import dataclasses

    from sleap_tpu import config as jc
    from sleap_tpu_torch import config as tcfg

    for cls in ("LEAPConfig", "UNetConfig", "HourglassConfig", "UpsamplingConfig",
                "ResNetConfig", "PretrainedEncoderConfig", "HRNetConfig"):
        assert dataclasses.asdict(getattr(tcfg, cls)()) == attr.asdict(getattr(jc, cls)()), cls
    assert [f.name for f in dataclasses.fields(tcfg.BackboneConfig)] == \
        [f.name for f in attr.fields(jc.BackboneConfig)]


# --------------------------------------------------------------------------- #
# The heads' fields, Model.head_names, Trainer.head_config, load_config
# --------------------------------------------------------------------------- #


def _jax_head_configs():
    from sleap_tpu import config as jc

    return {
        "SingleInstanceConfmapsHead": jc.SingleInstanceConfmapsHeadConfig(
            part_names=["a", "b"], sigma=2.5, output_stride=2, loss_weight=0.5),
        "CentroidConfmapsHead": jc.CentroidsHeadConfig(anchor_part="b", sigma=3.5, output_stride=4,
                                                       loss_weight=2.0),
        "CenteredInstanceConfmapsHead": jc.CenteredInstanceConfmapsHeadConfig(
            part_names=["a", "b", "c"], anchor_part="a", sigma=1.5, output_stride=2),
        "MultiInstanceConfmapsHead": jc.MultiInstanceConfmapsHeadConfig(part_names=["a"], sigma=4.0,
                                                                        output_stride=8),
        "PartAffinityFieldsHead": jc.PartAffinityFieldsHeadConfig(edges=[("a", "b")], sigma=9.0,
                                                                  output_stride=4, loss_weight=0.25),
        "ClassMapsHead": jc.ClassMapsHeadConfig(classes=["x", "y"], sigma=6.0, output_stride=4),
        "ClassVectorsHead": jc.ClassVectorsHeadConfig(classes=["x", "y"], num_fc_layers=2, num_fc_units=32,
                                                      global_pool=False, output_stride=16),
        "OffsetRefinementHead": jc.CentroidsHeadConfig(anchor_part="b", output_stride=2, loss_weight=3.0),
    }


@pytest.mark.parametrize("name", sorted(_jax_head_configs()))
def test_heads_have_the_jax_heads_fields(name):
    import attr

    from sleap_tpu.models import heads as jheads
    from sleap_tpu_torch.models import heads as theads

    config = _jax_head_configs()[name]
    mine, ref = getattr(theads, name).from_config(config), getattr(jheads, name).from_config(config)
    for f in attr.fields(type(ref)):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert (mine.name, mine.channels, mine.activation, mine.loss_function) == \
        (ref.name, ref.channels, ref.activation, ref.loss_function)


@pytest.mark.parametrize("run", RUN_NAMES)
def test_model_head_names_and_trainer_head_config_match_jax(run):
    from types import SimpleNamespace

    import sleap_tpu_torch
    from sleap_tpu.models.model import Model as JaxModel
    from sleap_tpu.training.trainer import Trainer as JaxTrainer
    from sleap_tpu_torch.training.trainer import Trainer

    mine, ref = TrainingJobConfig.load_json(str(RUNS / run)), JaxConfig.load_json(str(RUNS / run))
    assert Model.from_config(mine.model).head_names == JaxModel.from_config(ref.model).head_names
    got = Trainer.head_config.fget(SimpleNamespace(config=mine))
    want = JaxTrainer.head_config.fget(SimpleNamespace(config=ref))
    assert type(got).__name__ == type(want).__name__
    assert got is mine.model.heads.which_oneof
    assert sleap_tpu_torch.load_config(str(RUNS / run)).model.heads.which_oneof_attrib_name == \
        ref.model.heads.which_oneof_attrib_name
