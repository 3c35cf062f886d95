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
