"""The port's analysis export, importers and ``sleap-convert``
(``sleap_tpu_torch.info.write_tracking_h5``, ``sleap_tpu_torch.io.formats``,
``sleap_tpu_torch.io.convert``) against the JAX package's, on files the
tests write from a seed:

- the analysis ``.h5``, read with h5py: the same datasets, dtypes, shapes,
  values (NaN equal), chunks and filters (gzip at level 9) as the JAX
  package's file, on tracked, untracked, user-corrected, edgeless and
  multi-video projects;
- the analysis CSV, byte-equal to the JAX package's pandas output;
- each importer against the JAX importer (DeepLabCut single-animal and
  multi-animal CSVs and projects, COCO, AlphaTracker, labels JSON plain,
  gzip and zip, a LEAP ``.mat``, a DeepPoseKit ``.h5``, analysis files of
  either package), with the port's DeepLabCut and analysis-reader
  divergences pinned;
- ``io.convert.main`` against ``sleap_tpu.io.convert.main`` on the same
  arguments: the files written and the lines printed.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import os
import shutil
import zipfile

import h5py
import numpy as np
import pytest

from sleap_tpu.info import write_tracking_h5 as j_export
from sleap_tpu.io import convert as j_convert
from sleap_tpu.io import formats as j_formats
from sleap_tpu.io.formats import deepposekit as j_dpk
from sleap_tpu_torch.info import write_tracking_h5 as t_export
from sleap_tpu_torch.io import convert as t_convert
from sleap_tpu_torch.io import formats as t_formats
from sleap_tpu_torch.io.formats import deepposekit as t_dpk
from test_torch_data_model import JAX, TORCH, make_project, make_skeletons, summary


def tracked(P, seed=0):
    """One skeleton, two videos, tracked predictions and user corrections."""
    return make_project(P, seed=seed, two_skeletons=False)


def untracked(P, seed=0):
    """One animal a frame, no tracks."""
    rng = np.random.default_rng(seed)
    skel = make_skeletons(P)[0]
    video = P.Video(P.DummyVideo(filename="solo.mp4", frames=9))
    lfs = []
    for fi in (1, 2, 4, 7):
        xy = rng.uniform(0, 50, (5, 2))
        xy[rng.uniform(size=5) < 0.2] = np.nan
        inst = (P.PredictedInstance.from_arrays(xy, rng.uniform(size=5), rng.uniform(), skel) if fi != 4
                else P.Instance(skel, xy))
        lfs.append(P.LabeledFrame(video, fi, [inst]))
    return P.Labels(lfs)


def edgeless(P, seed=0):
    labels = untracked(P, seed)
    labels.skeleton.clear_edges()
    return labels


PROJECTS = {"tracked": tracked, "untracked": untracked, "edgeless": edgeless}


def h5_contents(path):
    with h5py.File(path, "r") as f:
        out = {}
        for key in f:
            ds = f[key]
            value = ds[()]
            out[key] = (ds.dtype.str if ds.dtype.kind != "O" else str(h5py.check_string_dtype(ds.dtype)),
                        ds.shape, ds.chunks, ds.compression, ds.compression_opts, ds.shuffle)
            if isinstance(value, np.ndarray) and value.dtype.kind == "f":
                out[key] += (np.nan_to_num(value, nan=-12345.0).tolist(), np.isnan(value).tolist())
            elif isinstance(value, np.ndarray):
                out[key] += (value.tolist(),)
            else:
                out[key] += (value,)
    return out


EXPORTS = [(p, kw) for p in PROJECTS for kw in ("all_frames", "labeled_range")] + [("tracked", "second_video")]


def _export(P, module, project, how, path, csv):
    labels = PROJECTS[project](P)
    kw = {"labels_path": "in.slp", "csv": csv}
    if how == "labeled_range":
        kw["all_frames"] = False
    if how == "second_video":
        kw["video"] = labels.videos[1]
    module.export_analysis_file(labels, path, **kw)


@pytest.mark.parametrize("project,how", EXPORTS)
def test_analysis_h5_matches_jax_file(project, how, tmp_path):
    mine, ref = str(tmp_path / "mine.h5"), str(tmp_path / "ref.h5")
    _export(TORCH, t_export, project, how, mine, csv=False)
    _export(JAX, j_export, project, how, ref, csv=False)
    a, b = h5_contents(mine), h5_contents(ref)
    assert sorted(a) == sorted(b)
    for key in b:
        assert a[key] == b[key], key
    assert a["tracks"][4] == 9 and "utf-8" in a["labels_path"][0] and a["labels_path"][-1] == b"in.slp"


@pytest.mark.parametrize("project,how", EXPORTS)
def test_analysis_csv_is_byte_equal_to_jax(project, how, tmp_path):
    mine, ref = str(tmp_path / "mine.csv"), str(tmp_path / "ref.csv")
    _export(TORCH, t_export, project, how, mine, csv=True)
    _export(JAX, j_export, project, how, ref, csv=True)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        text = a.read()
        assert text == b.read()
    assert text.count(b"\n") > 2


def test_analysis_csv_float_formats_match_pandas(tmp_path):
    """Scores and coordinates across the float formats pandas writes:
    exponents, integral values, negative zero, long mantissas."""
    values = [1e-05, 1e16, 0.1 + 0.2, 5.0, -0.0, 123456789012.5, 2.5e-300, 7.0e22, 1 / 3]
    for P, module, name in ((TORCH, t_export, "mine.csv"), (JAX, j_export, "ref.csv")):
        skel = make_skeletons(P)[1]
        video = P.Video(P.DummyVideo(filename="v.mp4", frames=len(values)))
        lfs = [P.LabeledFrame(video, i, [P.PredictedInstance.from_arrays(
            np.array([[v, -v], [v * 3, np.nan]]), np.array([v, 0.5]), v, skel)]) for i, v in enumerate(values)]
        module.export_analysis_file(P.Labels(lfs), str(tmp_path / name), csv=True)
    assert (tmp_path / "mine.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()


def test_analysis_export_without_frames_raises_as_jax(tmp_path):
    for P, module in ((TORCH, t_export), (JAX, j_export)):
        labels = tracked(P)
        with pytest.raises(ValueError, match="No labeled frames"):
            module.export_analysis_file(labels, str(tmp_path / "x.h5"),
                                        video=P.Video(P.DummyVideo(filename="other.mp4")))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_analysis_reader_matches_jax(writer, tmp_path):
    path = str(tmp_path / "a.analysis.h5")
    (t_export if writer == "port" else j_export).export_analysis_file(
        tracked(TORCH if writer == "port" else JAX), path)
    mine = t_formats.read(path, device="cpu")
    ref = j_formats.read(path)
    assert summary(mine) == summary(ref)
    np.testing.assert_array_equal(mine.numpy(), ref.numpy())


def test_analysis_reader_reads_an_edgeless_skeleton(tmp_path):
    """The JAX reader fails on a skeleton without edges (its empty
    ``edge_inds`` unpacks as one empty row); the port's reads it."""
    path = str(tmp_path / "e.analysis.h5")
    j_export.export_analysis_file(edgeless(JAX), path)
    with pytest.raises(ValueError):
        j_formats.read(path)
    labels = t_formats.read(path, device="cpu")
    assert labels.skeleton.node_names == ["head", "thorax", "abdomen", "wingL", "wingR"]
    assert labels.skeleton.edges == [] and len(labels) == 4


def test_labels_export_methods_write_the_analysis_files(tmp_path):
    labels = tracked(TORCH)
    labels.export(str(tmp_path / "a.h5"))
    labels.export_csv(str(tmp_path / "a.csv"))
    j_export.export_analysis_file(tracked(JAX), str(tmp_path / "r.h5"), all_frames=True)
    j_export.export_analysis_file(tracked(JAX), str(tmp_path / "r.csv"), csv=True)
    assert h5_contents(str(tmp_path / "a.h5")) == h5_contents(str(tmp_path / "r.h5"))
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "r.csv").read_bytes()


NWB_NIX_PACKAGE = {"export_nwb": "pynwb", "export_nix": "nixio", "load_nwb": "pynwb"}


@pytest.mark.parametrize("call", ["export_nwb", "export_nix", "load_nwb"])
def test_nwb_and_nix_name_the_roadmap_item(call, tmp_path):
    """NWB and NIX go through pynwb/ndx-pose and nixio, as in the JAX
    package: where they are absent both packages raise the same ImportError
    naming the package, and write nothing."""
    package = NWB_NIX_PACKAGE[call]
    try:
        __import__(package)
    except ImportError:
        pass
    else:
        pytest.skip(f"{package} is installed: the file round trip is tests/test_torch_nwb_nix.py's")
    messages = []
    for P in (TORCH, JAX):
        with pytest.raises(ImportError, match=package) as e:
            if call == "load_nwb":
                P.Labels.load_nwb(str(tmp_path / "x.nwb"))
            else:
                getattr(tracked(P), call)(str(tmp_path / "x"))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert not (tmp_path / "x").exists()


# --------------------------------------------------------------------------- #
# Importers
# --------------------------------------------------------------------------- #


def _write_png(path, seed):
    from sleap_tpu_torch.io import png

    frame = np.random.default_rng(seed).integers(0, 255, (12, 16, 1), dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(png.encode(frame))


def _dlc_csv(path, parts, individuals=None, n_frames=4, seed=0, prefix="labeled-data/clip"):
    """A CollectedData CSV as DeepLabCut writes it (NaN cells empty)."""
    rng = np.random.default_rng(seed)
    cols = [(ind, part, c) for ind in (individuals or [None]) for part in parts for c in ("x", "y")]
    rows = [["scorer"] + ["me"] * len(cols)]
    if individuals:
        rows.append(["individuals"] + [c[0] for c in cols])
    rows.append(["bodyparts"] + [c[1] for c in cols])
    rows.append(["coords"] + [c[2] for c in cols])
    for i in range(n_frames):
        vals = rng.uniform(0, 16, len(cols))
        cells = ["" if rng.uniform() < 0.15 else repr(float(v)) for v in vals]
        if i == 2 and individuals:
            cells[:2 * len(parts)] = [""] * (2 * len(parts))  # the first animal absent
        rows.append([f"{prefix}/img{10 * i + 3:04d}.png"] + cells)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(",".join(r) for r in rows) + "\n")
    for i in range(n_frames):
        _write_png(os.path.join(os.path.dirname(path), f"img{10 * i + 3:04d}.png"), i)


def _dlc_project(root, multi, flag=True):
    os.makedirs(root, exist_ok=True)
    if multi:
        config = ("Task: mice\nscorer: me\ndate: Jun18\n" + ("multianimalproject: true\n" if flag else "")
                  + "identity:\nindividuals:\n- m1\n- m2\nuniquebodyparts: []\nmultianimalbodyparts:\n"
                  "- snout\n- tail\nbodyparts: MULTI!\nskeleton:\n- - snout\n  - tail\n")
    else:
        config = ("Task: reach\nscorer: me\nmultianimalproject: false\nproject_path: C:\\Users\\me\\reach\n"
                  "video_sets:\n  C:\\Users\\me\\reach\\videos\\clip.avi:\n    crop: 0, 16, 0, 12\n"
                  "bodyparts:\n- hand\n- finger\n- joystick\nstart: 0\nstop: 1\npcutoff: 0.6\n")
    with open(os.path.join(root, "config.yaml"), "w") as f:
        f.write(config)
    for k, sub in enumerate(("clip", "clip2")):
        if multi:
            _dlc_csv(os.path.join(root, "labeled-data", sub, "CollectedData_me.csv"), ["snout", "tail"],
                     ["m1", "m2"], seed=k, prefix=f"labeled-data/{sub}")
        else:
            _dlc_csv(os.path.join(root, "labeled-data", sub, "CollectedData_me.csv"),
                     ["hand", "finger", "joystick"], seed=k, prefix=f"labeled-data/{sub}")
    return os.path.join(root, "config.yaml")


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_dlc_csv_matches_jax(multi, tmp_path):
    path = _dlc_project(str(tmp_path / "proj"), multi)
    csv_path = os.path.join(os.path.dirname(path), "labeled-data", "clip", "CollectedData_me.csv")
    mine, ref = t_formats.read(csv_path, device="cpu"), j_formats.read(csv_path)
    assert summary(mine) == summary(ref)
    assert len(mine) == 4 and (len(mine.tracks) == 2) == multi
    np.testing.assert_array_equal(mine.video.get_frame(1), ref.video.get_frame(1))


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_dlc_project_matches_jax(multi, tmp_path):
    path = _dlc_project(str(tmp_path / "proj"), multi)
    mine, ref = TORCH.Labels.load_deeplabcut(path, device="cpu"), JAX.Labels.load_deeplabcut(path)
    assert summary(mine) == summary(ref)
    assert len(mine) == 8 and len(mine.videos) == 2


def test_dlc_project_without_the_multianimal_flag_uses_multianimalbodyparts(tmp_path):
    """Pinned divergence: the JAX reader asks for ``multianimalproject``, so
    without it takes ``bodyparts: MULTI!`` and adds a node a character."""
    path = _dlc_project(str(tmp_path / "proj"), multi=True, flag=False)
    assert JAX.Labels.load_deeplabcut(path).skeleton.node_names[:6] == ["M", "U", "L", "T", "I", "!"]
    mine = TORCH.Labels.load_deeplabcut(path, device="cpu")
    assert mine.skeleton.node_names == ["snout", "tail"]
    ref = JAX.Labels.load_deeplabcut(_dlc_project(str(tmp_path / "flagged"), multi=True))
    a, b = summary(mine), summary(ref)
    assert [f[1:] for f in a["frames"]] == [f[1:] for f in b["frames"]]


def test_dlc_config_bodyparts_that_are_not_a_list_add_no_nodes(tmp_path):
    """Pinned divergence: ``bodyparts: MULTI!`` with no multi-animal lists
    gives the CSV's body parts, not one node a character."""
    path = _dlc_project(str(tmp_path / "proj"), multi=True, flag=False)
    text = open(path).read().replace("multianimalbodyparts:\n- snout\n- tail\n", "")
    with open(path, "w") as f:
        f.write(text)
    assert TORCH.Labels.load_deeplabcut(path, device="cpu").skeleton.node_names == ["snout", "tail"]
    assert JAX.Labels.load_deeplabcut(path).skeleton.node_names[:2] == ["M", "U"]


def test_dlc_project_with_videos_indexes_frames_by_image_number(tmp_path):
    """Pinned divergence: where ``videos/<subdir>.*`` exists, the frames are
    that video's at the numbers of ``imgNNNN`` (the JAX reader keeps the
    images in row order)."""
    path = _dlc_project(str(tmp_path / "proj"), multi=False)
    os.makedirs(tmp_path / "proj" / "videos")
    (tmp_path / "proj" / "videos" / "clip.mp4").write_bytes(b"")
    mine = TORCH.Labels.load_deeplabcut(path, device="cpu")
    ref = JAX.Labels.load_deeplabcut(path)
    clip = [v for v in mine.videos if v.filename.endswith("clip.mp4")]
    assert len(clip) == 1 and type(clip[0].backend).__name__ == "MediaVideo"
    assert [lf.frame_idx for lf in mine.find(clip[0])] == [3, 13, 23, 33]
    assert [lf.frame_idx for lf in ref.find(ref.videos[0])] == [0, 1, 2, 3]
    a, b = summary(mine), summary(ref)
    assert [f[2] for f in a["frames"]] == [f[2] for f in b["frames"]]  # the same instances


def test_coco_matches_jax(tmp_path):
    images = [{"id": 7, "file_name": "a.png"}, {"id": 3, "file_name": "b.png"}]
    for i, im in enumerate(images):
        _write_png(str(tmp_path / im["file_name"]), i)
    data = {
        "images": images,
        "categories": [{"id": 1, "name": "mouse", "keypoints": ["nose", "ear", "tail"], "skeleton": [[1, 2], [2, 3]]},
                       {"id": 2, "name": "fly", "keypoints": ["head", "tail"], "skeleton": [[1, 2]]}],
        "annotations": [
            {"image_id": 7, "category_id": 1, "keypoints": [1, 2, 2, 3, 4, 1, 0, 0, 0]},
            {"image_id": 3, "category_id": 1, "keypoints": [5, 6, 2, 7, 8, 2, 9, 1, 2]},
            {"image_id": 3, "category_id": 2, "keypoints": [5.5, 6.5, 2, 0, 0, 0]},
            {"image_id": 3, "category_id": 1},
        ],
    }
    path = str(tmp_path / "coco.json")
    with open(path, "w") as f:
        json.dump(data, f)
    assert t_formats.sniff_format(path) == j_formats.sniff_format(path) == "coco"
    assert summary(TORCH.Labels.load_coco(path, device="cpu")) == summary(JAX.Labels.load_coco(path))


def test_alphatracker_matches_jax(tmp_path):
    data = []
    for i in range(3):
        _write_png(str(tmp_path / f"f{i}.png"), i)
        anns = [{"class": "Face", "x": 0, "y": 0, "width": 5, "height": 5}]
        anns += [{"class": "point", "x": float(i + k), "y": float(2 * k)} for k in range(3 + (i == 1))]
        anns += [{"class": "Face"}, {"class": "point", "x": 9.5, "y": 1.5}]
        data.append({"filename": f"f{i}.png", "class": "image", "annotations": anns})
    path = str(tmp_path / "at.json")
    with open(path, "w") as f:
        json.dump(data, f)
    assert t_formats.sniff_format(path) == j_formats.sniff_format(path) == "alphatracker"
    assert summary(TORCH.Labels.load_alphatracker(path, device="cpu")) == \
        summary(JAX.Labels.load_alphatracker(path))


@pytest.mark.parametrize("container", ["plain", "gzip", "zip"])
def test_labels_json_matches_jax(container, tmp_path):
    text = json.dumps(make_project(JAX).to_dict())
    path = str(tmp_path / ("p.json" if container != "zip" else "p.json.zip"))
    if container == "plain":
        open(path, "w").write(text)
    elif container == "gzip":
        open(path, "wb").write(gzip.compress(text.encode()))
    else:
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("p.json", text)
    mine = TORCH.Labels.load_json(path, video_search=False, device="cpu")
    ref = JAX.Labels.load_json(path, video_search=False)
    assert summary(mine) == summary(ref)
    assert mine.to_dict() == ref.to_dict()
    assert json.dumps(make_project(TORCH).to_dict()) == text


def test_labels_json_of_the_port_reads_in_jax(tmp_path):
    path = str(tmp_path / "p.json")
    open(path, "w").write(json.dumps(make_project(TORCH).to_dict()))
    assert summary(JAX.Labels.load_json(path, video_search=False)) == \
        summary(TORCH.Labels.load_json(path, video_search=False, device="cpu"))


def test_leap_matlab_matches_jax(tmp_path):
    from scipy.io import savemat

    rng = np.random.default_rng(0)
    positions = rng.uniform(0, 30, (3, 2, 5))
    positions[:, :, 2] = 0  # an unlabeled frame
    box = rng.integers(0, 255, (5, 1, 8, 8), dtype=np.uint8)
    with h5py.File(str(tmp_path / "box.h5"), "w") as f:
        f.create_dataset("box", data=box)
    nodes = np.empty((3,), dtype=object)
    nodes[:] = ["head", "body", "tail"]
    skeleton = {"nodes": nodes, "edges": np.array([[1, 2], [2, 3]])}
    path = str(tmp_path / "labels.mat")
    savemat(path, {"positions": positions, "skeleton": skeleton, "boxPath": "/elsewhere/box.h5"})
    mine, ref = TORCH.Labels.load_leap_matlab(path, device="cpu"), JAX.Labels.load_leap_matlab(path)
    assert summary(mine) == summary(ref)
    assert len(mine) == 4 and mine.skeleton.node_names == ["head", "body", "tail"]
    np.testing.assert_array_equal(mine.video.get_frame(3), ref.video.get_frame(3))


def test_deepposekit_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    with h5py.File(str(tmp_path / "pose.h5"), "w") as f:
        f.create_dataset("pose", data=rng.uniform(0, 20, (2, 3, 4, 3)))
    with open(tmp_path / "skeleton.csv", "w") as f:
        f.write("name,parent,swap\nhead,,\nneck,head,\nleft,neck,right\nright,neck,left\n")
    np.save(str(tmp_path / "video.npy"), rng.integers(0, 255, (3, 8, 8, 1), dtype=np.uint8))
    args = (str(tmp_path / "pose.h5"), str(tmp_path / "video.npy"), str(tmp_path / "skeleton.csv"))
    mine, ref = t_dpk.read_labels(*args, device="cpu"), j_dpk.read_labels(*args)
    assert summary(mine) == summary(ref)
    assert mine.skeleton.symmetry_names == [("left", "right")]


@pytest.mark.parametrize("name", ["a.slp", "a.analysis.h5", "a.h5", "a.mat", "a.csv", "a.json", "a.nwb",
                                  "a.nix", "a.txt", "a.yaml"])
def test_sniff_format_matches_jax(name, tmp_path):
    path = str(tmp_path / name)
    if name == "a.h5":
        j_export.export_analysis_file(tracked(JAX), path)
    elif name == "a.csv":
        open(path, "w").write("scorer,me\n")
    elif name == "a.json":
        open(path, "w").write('{"skeletons": []}')
    elif name == "a.yaml":
        open(path, "w").write("bodyparts:\n- a\n")
    else:
        open(path, "w").write("")

    def sniff(module):
        try:
            return module.sniff_format(path)
        except ValueError:
            return "raised"

    assert sniff(t_formats) == sniff(j_formats)


# --------------------------------------------------------------------------- #
# sleap-convert
# --------------------------------------------------------------------------- #


CLI_CASES = {
    "analysis": ["--format", "analysis"],
    "analysis_csv": ["--format", "analysis.csv"],
    "analysis_outputs": ["--format", "analysis", "-o", "first.h5", "-o", "second.h5"],
    "analysis_video": ["--format", "analysis", "--video", "clip_b"],
    "analysis_missing_video": ["--format", "analysis", "--video", "nope"],
    "slp": ["--format", "slp"],
    "pkg_slp": ["--format", "pkg.slp"],
    "json": ["--format", "json"],
    "output": ["-o", "out.slp"],
    "unknown": ["--format", "xyz"],
}


def _run_cli(main, args, workdir, **kw):
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(out):
            main(args, **kw)
    finally:
        os.chdir(cwd)
    return out.getvalue()


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_convert_main_matches_jax(name, tmp_path):
    src = tmp_path / "src.slp"
    tracked(JAX).save(str(src))
    outputs = {}
    for who, main, kw in (("mine", t_convert.main, {"device": "cpu"}), ("ref", j_convert.main, {})):
        work = tmp_path / who
        work.mkdir()
        shutil.copy(src, work / "proj.slp")
        printed = _run_cli(main, ["proj.slp"] + CLI_CASES[name], str(work), **kw)
        outputs[who] = (printed.replace(str(work), "<dir>"), sorted(os.listdir(work)))
    assert outputs["mine"] == outputs["ref"]
    for fn in outputs["mine"][1]:
        a, b = str(tmp_path / "mine" / fn), str(tmp_path / "ref" / fn)
        if fn.endswith(".csv"):
            assert open(a, "rb").read() == open(b, "rb").read()
        elif fn.endswith(".h5") and "analysis" in fn or fn in ("first.h5", "second.h5"):
            assert h5_contents(a) == h5_contents(b)
        elif fn != "proj.slp":
            mine = j_formats.read(a, as_format="slp", video_search=False)
            ref = j_formats.read(b, as_format="slp", video_search=False)
            assert json.loads(json.dumps(summary(mine))) == json.loads(json.dumps(summary(ref)).replace(
                str(tmp_path / "ref"), str(tmp_path / "mine")))
            for va, vb in zip(mine.videos, ref.videos):
                np.testing.assert_array_equal(va[:], vb[:])


@pytest.mark.parametrize("fmt", ["nwb", "nix", "analysis.nix"])
def test_convert_nwb_and_nix_name_the_roadmap_item(fmt, tmp_path):
    """``--format nwb|nix|analysis.nix`` reach the writers as the JAX CLI's
    do: the same ImportError where the package is absent."""
    package = "pynwb" if fmt == "nwb" else "nixio"
    try:
        __import__(package)
    except ImportError:
        pass
    else:
        pytest.skip(f"{package} is installed: the file round trip is tests/test_torch_nwb_nix.py's")
    tracked(TORCH).save(str(tmp_path / "p.slp"))
    messages = []
    for main, kw in ((t_convert.main, {"device": "cpu"}), (j_convert.main, {})):
        with pytest.raises(ImportError, match=package) as e:
            _run_cli(main, ["p.slp", "--format", fmt], str(tmp_path), **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_convert_function_matches_jax(tmp_path):
    tracked(JAX).save(str(tmp_path / "p.slp"))
    for fmt in ("analysis", "analysis.csv", "slp"):
        mine = t_convert.convert(str(tmp_path / "p.slp"), str(tmp_path / f"m.{fmt}"), output_format=fmt,
                                 device="cpu")
        ref = j_convert.convert(str(tmp_path / "p.slp"), str(tmp_path / f"r.{fmt}"), output_format=fmt)
        assert os.path.basename(mine)[1:] == os.path.basename(ref)[1:]
    assert h5_contents(str(tmp_path / "m.analysis")) == h5_contents(str(tmp_path / "r.analysis"))
    assert (tmp_path / "m.analysis.csv").read_bytes() == (tmp_path / "r.analysis.csv").read_bytes()
    with pytest.raises(ValueError, match="Unsupported"):
        t_convert.convert(str(tmp_path / "p.slp"), output_format="xyz", device="cpu")


def test_default_analysis_filename_matches_jax():
    mine, ref = tracked(TORCH), tracked(JAX)
    for i in range(2):
        assert t_convert.default_analysis_filename(mine, mine.videos[i], "out", "proj", "csv") == \
            j_convert.default_analysis_filename(ref, ref.videos[i], "out", "proj", "csv")
