"""The port's top-level host modules against the JAX package's, on the CPU,
as ``tests/test_system_tools.py`` and ``tests/test_misc.py::test_util_helpers``
test the JAX ones:

- ``util``: each helper equals the JAX one on the same inputs; a dataclass's
  structured dtype equals the JAX one of the same attrs class; dicts saved
  through the port's HDF5 writer read back in h5py as the JAX package's
  h5py file does, and each package's readers read the other's file;
- ``system`` with no CUDA device: no GPUs, the CPU as the device, a summary;
- ``prefs`` in a temporary folder (never the real home): each package reads
  what the other saved; saving without PyYAML names it;
- ``message``: the port's sender and receiver against the JAX package's
  over a local socket (handshake, dicts, arrays) both ways;
- ``diagnostic``, ``version.versions``, ``__init__.system_summary`` and
  ``load_config``: the summary names torch, CUDA and the packages, and a
  fresh process that prints it imports nothing of the JAX side.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys

import attr
import h5py
import numpy as np
import pytest

import sleap_tpu_torch
from sleap_tpu import prefs as j_prefs
from sleap_tpu import util as j_util
from sleap_tpu_torch import diagnostic as t_diagnostic
from sleap_tpu_torch import message as t_message
from sleap_tpu_torch import prefs as t_prefs
from sleap_tpu_torch import system as t_system
from sleap_tpu_torch import util as t_util
from sleap_tpu_torch.io import hdf5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTILS = (t_util, j_util)


@pytest.mark.parametrize("case", [
    ("frame_list", ("1-3,7",)), ("frame_list", ("",)), ("frame_list", (" 4, 9-11 ,2",)),
    ("uniquify", ([3, 1, 3, 2, 1],)), ("weak_filename_match", ("C:\\data\\vid.mp4", "/other/VID.MP4")),
    ("weak_filename_match", ("a/b.mp4", "a/c.mp4")),
    ("make_scoped_dictionary", ({"a.x": 1, "a.y": 2, "b.z": 3, "c": 4, "d.w": None},)),
    ("make_scoped_dictionary", ({"a.x": 1, "d.w": None}, False)),
    ("dict_cut", ({1: "a", 3: "b", 5: "c", 9: "d"}, 3, 9)),
    ("json_dumps", ({"b": [1, 2.5, None], "a": {"x": "y"}},)),
    ("json_loads", ('{"a": [1, 2], "b": null}',)),
], ids=lambda c: c[0])
def test_util_helpers_match_jax(case):
    name, args = case
    assert getattr(t_util, name)(*args) == getattr(j_util, name)(*args)


def test_util_find_matches_jax():
    for first in (False, True):
        assert t_util.find(lambda x: x > 2, [1, 3, 5], first) == j_util.find(lambda x: x > 2, [1, 3, 5], first)
    assert t_util.find(lambda x: x > 9, [1], first=True) is j_util.find(lambda x: x > 9, [1], first=True)


def test_util_json_dumps_to_a_file(tmp_path):
    for i, util in enumerate(UTILS):
        assert util.json_dumps({"k": [1, 2]}, str(tmp_path / f"{i}.json")) is None
    assert (tmp_path / "0.json").read_bytes() == (tmp_path / "1.json").read_bytes()


@dataclasses.dataclass
class _Row:
    name: str = ""
    count: int = 0
    score: float = 0.0
    flag: bool = False
    skipped: list = None


@attr.s(auto_attribs=True)
class _AttrRow:
    name: str = ""
    count: int = 0
    score: float = 0.0
    flag: bool = False
    skipped: list = None


def test_attr_to_dtype_matches_jax():
    mine, ref = t_util.attr_to_dtype(_Row()), j_util.attr_to_dtype(_AttrRow())
    assert mine == ref and mine.names == ref.names == ("name", "count", "score", "flag")
    assert h5py.check_string_dtype(mine["name"]) == h5py.check_string_dtype(ref["name"])


DICT = {"a": np.arange(6, dtype="f4").reshape(2, 3), "b": {"c": np.int64(7), "d": ["x", "yy", "zzz"]},
        "e": None, "f": 2.5, "g": "text", "h": {"i": {"j": np.array([True, False])}}}


def _h5py_contents(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj.dtype.str if obj.dtype.kind != "O" else "vlen", obj[()].tolist()
                             if isinstance(obj[()], np.ndarray) else obj[()])
        f.visititems(visit)
    return out


def test_save_dict_to_hdf5_matches_jax(tmp_path):
    mine, ref = str(tmp_path / "mine.h5"), str(tmp_path / "ref.h5")
    with hdf5.Writer(mine) as w:
        t_util.save_dict_to_hdf5(w, "root", DICT)
        t_util.save_dict_to_hdf5(w, "root", {"f": 3.5})  # an existing dataset is replaced
    with h5py.File(ref, "w") as f:
        j_util.save_dict_to_hdf5(f, "root", DICT)
        j_util.save_dict_to_hdf5(f, "root", {"f": 3.5})
    assert _h5py_contents(mine) == _h5py_contents(ref)
    for path in (mine, ref):
        for util in UTILS:
            np.testing.assert_array_equal(util.read_hdf5_dataset(path, "root/a"), DICT["a"])
        got = t_util.read_hdf5_group(path, "root")
        want = j_util.read_hdf5_group(path, "root")
        assert sorted(got) == sorted(want) == ["root/a", "root/b/c", "root/b/d", "root/f", "root/g",
                                                "root/h/i/j"]
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


def test_config_files_resolve_in_the_users_folder(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    assert t_util.get_package_file("x.json") == os.path.join(os.path.dirname(sleap_tpu_torch.__file__),
                                                             "x.json")
    for util in UTILS:
        with pytest.raises(FileNotFoundError, match="prefs.yaml"):
            util.get_config_file("prefs.yaml")
    user = tmp_path / ".sleap_tpu" / "prefs.yaml"
    assert t_util.get_config_file("prefs.yaml", ignore_file_not_found=True) == str(user)
    user.parent.mkdir()
    user.write_text("a: 1\n")
    for util in UTILS:
        assert util.get_config_file("prefs.yaml") == str(user)


def test_system_without_cuda(capsys):
    if t_system.is_accelerator_system():
        pytest.skip("a CUDA device is present: chip_smoke.py phase 16a checks it")
    assert t_system.get_all_gpus() == [] and t_system.get_all_tpus is t_system.get_all_gpus
    assert t_system.get_all_devices() == [sleap_tpu_torch.system.torch.device("cpu")]
    assert t_system.best_logical_device_name() == "cpu"
    for select in (t_system.use_first_gpu, t_system.use_last_gpu, lambda: t_system.use_gpu(0)):
        with pytest.raises(RuntimeError, match="No CUDA device"):
            select()
    t_system.summary()
    out = capsys.readouterr().out
    assert "GPUs: 0" in out and "CUDA:" in out and "cuDNN:" in out
    sleap_tpu_torch.system_summary()
    assert capsys.readouterr().out == out


@pytest.fixture
def prefs_files(tmp_path, monkeypatch):
    files = {}
    for name, mod in (("port", t_prefs), ("jax", j_prefs)):
        files[name] = str(tmp_path / name / "preferences.yaml")
        monkeypatch.setattr(mod.Preferences, "_filename", files[name])
    return files


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_prefs_round_trip_between_packages(writer, prefs_files):
    mods = {"port": t_prefs, "jax": j_prefs}
    p = mods[writer].Preferences()
    p["marker size"] = 7
    p["palette"] = "alphabet"
    p["trail width"] = 2.5
    p["color predicted"] = True
    p.save()
    reader = "jax" if writer == "port" else "port"
    os.makedirs(os.path.dirname(prefs_files[reader]), exist_ok=True)
    with open(prefs_files[writer]) as src, open(prefs_files[reader], "w") as dst:
        dst.write(src.read())
    q = mods[reader].Preferences()
    for key in j_prefs.Preferences._defaults:
        assert q[key] == p[key], key
    assert q["marker size"] == 7 and q["palette"] == "alphabet" and q["color predicted"] is True
    with pytest.raises(KeyError, match="No preference matching"):
        q["nope"]
    assert "palette" in q and "nope" not in q


def test_prefs_defaults_and_reset_match_jax(prefs_files):
    assert t_prefs.Preferences._defaults == j_prefs.Preferences._defaults
    for name, mod in (("port", t_prefs), ("jax", j_prefs)):
        p = mod.Preferences()
        p["bold lines"] = True
        p.reset_to_default()
        assert p["bold lines"] is False and os.path.exists(prefs_files[name])
    assert open(prefs_files["port"]).read() == open(prefs_files["jax"]).read()


def test_prefs_save_names_pyyaml_where_absent(prefs_files, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    p = t_prefs.Preferences()
    assert p["marker size"] == 4  # reading needs no PyYAML
    with pytest.raises(ImportError, match="PyYAML"):
        p.save()


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


@pytest.mark.parametrize("sender_of,receiver_of", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_paired_messages_between_packages(sender_of, receiver_of):
    from sleap_tpu import message as j_message

    mods = {"port": t_message, "jax": j_message}
    address = _free_address()
    sender = mods[sender_of].PairedSender(address)
    receiver = mods[receiver_of].PairedReceiver(address)
    sender.setup()
    receiver.setup()
    try:
        import threading

        done = threading.Event()

        def answer():
            while not done.is_set():
                receiver.check_messages(timeout=0.01)

        thread = threading.Thread(target=answer)
        thread.start()
        try:
            assert sender.send_handshake(timeout=5.0)
        finally:
            done.set()
            thread.join()
        sender.send_dict({"event": "epoch_end", "logs": {"loss": 0.5}})
        array = np.arange(12, dtype="f4").reshape(3, 4)
        sender.send_array({"event": "frame"}, array)
        got = []
        for _ in range(50):
            got += receiver.check_messages(timeout=0.1)
            if len(got) == 2:
                break
        assert got[0] == {"event": "epoch_end", "logs": {"loss": 0.5}}
        assert got[1]["event"] == "frame" and got[1]["shape"] == [3, 4]
        np.testing.assert_array_equal(got[1]["array"], array)
    finally:
        sender.close()
        receiver.close()


def test_message_setup_names_pyzmq_where_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, "zmq", None)
    for cls in (t_message.PairedSender, t_message.PairedReceiver):
        with pytest.raises(ImportError, match="pyzmq"):
            cls("tcp://127.0.0.1:1").setup()


JAX_SIDE = ("jax", "jaxlib", "flax", "optax", "orbax", "sleap_tpu", "h5py", "cv2", "attr", "networkx",
            "yaml", "pandas", "sklearn", "zmq", "pynwb", "ndx_pose", "nixio")


def test_diagnostic_runs_as_a_module_without_the_jax_side():
    code = ("import runpy, sys; runpy.run_module('sleap_tpu_torch.diagnostic', run_name='__main__'); "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & set({JAX_SIDE!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO}, check=True).stdout
    lines = out.strip().splitlines()
    assert lines[-1] == "[]", lines[-1]
    text = "\n".join(lines[:-1])
    assert text == t_diagnostic.system_summary()
    import torch

    for want in (f"torch: {torch.__version__}", "CUDA:", "cuDNN:", "GPUs:", "numpy: " + np.__version__,
                 "scipy:", "triton:", "sleap-tpu-torch version: " + sleap_tpu_torch.version.__version__):
        assert want in text, want


def test_versions_and_load_config(capsys):
    import torch

    from sleap_tpu_torch.config import load_config
    from sleap_tpu_torch.version import versions

    out = versions()
    assert out in capsys.readouterr().out and f"PyTorch: {torch.__version__}" in out
    folder = os.path.join(REPO, ".convergence_runs", "minimal_instance.UNet.centroid")
    mine, ref = sleap_tpu_torch.load_config(folder), load_config(folder)
    assert mine.model == ref.model and mine.data.preprocessing == ref.data.preprocessing
    assert [s.node_names for s in mine.data.labels.skeletons] == [s.node_names for s in ref.data.labels.skeletons]
