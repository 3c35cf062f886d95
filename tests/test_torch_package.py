"""Package rules of the PyTorch port: importing it pulls in no JAX (nor the
JAX package, whose import needs h5py), a machine without nvcc cannot build
the kernels and gets no fallback, and CPU tensors never launch a kernel."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sleap_tpu_torch.ops import _build, cuda_crops, cuda_peaks
from sleap_tpu_torch.ops import peak_finding as tpf

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import sleap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sleap_tpu_torch.__path__, "sleap_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "sleap_tpu", "h5py"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_every_module_leaves_jax_out():
    # A fresh interpreter: this test process has JAX loaded by conftest.py.
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        check=True, timeout=120,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "sleap_tpu_torch.inference.predictors" in result["modules"]
    assert "sleap_tpu_torch.ops.cuda_peaks" in result["modules"]
    assert result["bad"] == []


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_cpu_tensors_never_launch_kernels():
    wrappers = (cuda_peaks.global_peaks_cuda, cuda_peaks.local_peaks_cuda, cuda_crops.crop_unit_cuda)
    before = [w.launches for w in wrappers]
    rng = np.random.default_rng(0)
    cms = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32))
    tpf.find_global_peaks(cms, refinement="integral")
    tpf.find_global_peaks_rough(cms)
    tpf.find_local_peaks(cms, max_peaks=4, refinement="integral")
    tpf.find_local_peaks(cms, max_peaks=4)
    images = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 1), np.uint8))
    tpf.crop_bboxes_unit(images, torch.tensor([[3.5, -2.25]]), torch.tensor([1]), (8, 8))
    assert [w.launches for w in wrappers] == before == [0, 0, 0]


def test_array_batches_and_staging_keep_order_and_padding():
    from sleap_tpu_torch.data.streaming import stage_to_device
    from sleap_tpu_torch.inference.predictors import _array_batches

    frames = np.arange(5 * 4 * 4, dtype=np.uint8).reshape(5, 4, 4, 1)
    staged = list(stage_to_device(_array_batches(frames, 2), torch.device("cpu"), depth=2))
    assert [n for _, n, _ in staged] == [2, 2, 1]
    assert [b["frame_ind"].tolist() for b, _, _ in staged] == [[0, 1], [2, 3], [4, 4]]
    for batch, _, image in staged:
        assert image.device.type == "cpu"
        np.testing.assert_array_equal(image.numpy(), frames[batch["frame_ind"]])
