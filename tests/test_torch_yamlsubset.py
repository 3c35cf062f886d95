"""The port's YAML subset (``sleap_tpu_torch.io.yamlsubset``) against
PyYAML: DeepLabCut project configs generated from a seed (single- and
multi-animal, posix and Windows paths, ``crop`` strings, nested skeleton
pairs, nulls, booleans, numbers), written by PyYAML's ``safe_dump`` and by
the port's ``yaml_dump``, read by ``yaml_load`` as ``yaml.safe_load`` reads
them; plain scalars resolved by PyYAML's YAML 1.1 rules; and a config as
DeepLabCut writes it, comments and blank values included."""

from __future__ import annotations

import math

import numpy as np
import pytest
import yaml

from sleap_tpu_torch.io.yamlsubset import yaml_dump, yaml_load


def dlc_config(seed: int, multi: bool) -> dict:
    rng = np.random.default_rng(seed)
    parts = [f"part{i}_{rng.integers(100)}" for i in range(rng.integers(2, 7))]
    windows = bool(rng.integers(2))
    root = "C:\\Users\\lab member\\proj-2024" if windows else "/home/lab/proj-2024"
    sep = "\\" if windows else "/"
    video = root + sep + "videos" + sep + f"clip{seed}.avi"
    config = {
        "Task": f"task{seed}", "scorer": "lab", "date": "Jun18", "multianimalproject": multi,
        "identity": None if rng.integers(2) else False, "project_path": root,
        "video_sets": {video: {"crop": f"0, {rng.integers(100, 2000)}, 0, {rng.integers(100, 2000)}"}},
        "start": 0, "stop": 1, "numframes2pick": int(rng.integers(5, 50)),
        "skeleton": [[parts[0], p] for p in parts[1:]], "skeleton_color": "black",
        "pcutoff": float(rng.choice([0.6, 0.1, 0.95])), "dotsize": 12, "alphavalue": 0.7,
        "colormap": "rainbow", "TrainingFraction": [0.95], "iteration": 0,
        "default_net_type": "resnet_50", "snapshotindex": -1, "batch_size": 8, "cropping": False,
        "x1": 0, "x2": 640, "y1": 277, "y2": 624, "corner2move2": [50, 50], "move2corner": True,
    }
    if multi:
        config.update({"individuals": [f"mouse{i}" for i in range(3)], "uniquebodyparts": [],
                       "multianimalbodyparts": parts, "bodyparts": "MULTI!"})
    else:
        config["bodyparts"] = parts
    return config


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_dlc_configs_read_as_pyyaml_reads_them(seed, multi):
    config = dlc_config(seed, multi)
    text = yaml.safe_dump(config)
    assert yaml_load(text) == yaml.safe_load(text) == config
    mine = yaml_dump(config)
    assert yaml.safe_load(mine) == config
    assert yaml_load(mine) == config


DLC_TEXT = """\
    # Project definitions (do not edit)
Task: reaching
scorer: Mackenzie
date: Jun18
multianimalproject:
identity:

    # Project path (change when moving around)
project_path: C:\\Users\\Mackenzie\\reaching-Mackenzie-2018-06-18

    # Annotation data set configuration (and individual video cropping parameters)
video_sets:
  C:\\Users\\Mackenzie\\reaching-Mackenzie-2018-06-18\\videos\\reachingvideo1.avi:
    crop: 0, 832, 0, 747
  '/data/videos/b: c.avi':
    crop: 0, 640, 0, 480
bodyparts:
- Hand
- Finger1
- "Finger2"
- 'Joystick'
start: 0
stop: 1
numframes2pick: 20

    # Plotting configuration
skeleton:
- - Hand
  - Finger1
- - Finger1
  - Joystick
skeleton_color: black
pcutoff: 0.6
dotsize: 12
alphavalue: 0.7
colormap: jet

    # Training,Evaluation and Analysis configuration
TrainingFraction:
- 0.95
iteration: 0
default_net_type: resnet_50
default_augmenter: default
snapshotindex: -1
batch_size: 8

    # Cropping Parameters (for analysis and outlier frame detection)
cropping: false
#if cropping is true for analysis, then set the values here:
x1: 0
x2: 640
y1: 277
y2: 624

    # Refinement configuration (parameters from annotation dataset configuration also relevant in this stage)
corner2move2:
- 50
- 50
move2corner: true
individuals: [a, b]
uniquebodyparts: []
"""


def test_a_config_as_deeplabcut_writes_it():
    text = "\n".join(line.lstrip() if line.lstrip().startswith("#") else line for line in DLC_TEXT.splitlines())
    assert yaml_load(text) == yaml.safe_load(text)


SCALARS = ["yes", "No", "ON", "off", "True", "FALSE", "tRuE", "0x1F", "-0x1f", "017", "0b101", "1_000", "1:30",
           "-1:30:15", "1.5", "1e5", "1.0e5", "1.0e+5", ".5", "5.", "-.inf", ".NaN", "+.inf", "~", "null", "Null",
           "", "0", "-0", "+7", "007", "08", "0, 832, 0, 747", "C:\\x\\y", "a b", "1_0.5", "3:60", "12e", "'q'",
           '"d\\tq\\u00e9"', "'it''s'", "x#y", "v # a comment"]


@pytest.mark.parametrize("scalar", SCALARS)
def test_plain_and_quoted_scalars_resolve_as_pyyaml(scalar):
    text = f"key: {scalar}\n"
    want = yaml.safe_load(text)["key"]
    got = yaml_load(text)["key"]
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("value", ["yes", "0x1F", "1:30", "~", "", "-x", "a: b", "#c", "[1]", "1.5", "x'y",
                                   "'q", "C:\\Users\\x", " lead", "trail "])
def test_dumped_strings_read_back_as_themselves(value):
    config = {"k": value, "l": [value]}
    assert yaml.safe_load(yaml_dump(config)) == config
    assert yaml_load(yaml_dump(config)) == config


def test_nested_sequences_dump_as_pyyaml_dumps_them():
    config = {"skeleton": [["a", "b"], ["b", "c"]], "empty": [], "pairs": [[1, 2.5], []]}
    assert yaml_dump(config) == yaml.safe_dump(config)
