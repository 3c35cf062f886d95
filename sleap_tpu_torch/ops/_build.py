"""Build and bind the CUDA kernels in ``sleap_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc``, one process per source
started together, and linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. The library lands in ``sleap_tpu_torch/build/`` under a name
keyed by a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is reused. A missing ``nvcc`` or a failed build raises:
there is no fallback to the plain versions. :func:`launch` is the one way
the wrappers call an entry point.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"
SOURCES = ("peaks.cu", "crops.cu")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default install
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C signatures of the entry points (every pointer and the stream as void*).
SIGNATURES = {
    "sleap_global_peaks": [_p, _i64, _i64, _i64, _i64, _i, _i, _i, _i, _i, _f, _i, _p, _p, _p],
    "sleap_global_plan": [_i64, _i64, _i64, _i, _i, _i, _i, _i, _i],
    "sleap_local_peaks": [_p, _i64, _i64, _i64, _i64, _i, _i, _i, _i, _i, _f, _i, _p, _p, _p],
    "sleap_local_peaks_hwcs": [
        _p, _i64, _i64, _i64, _i64, _i, _i, _i, _i, _i, _f, _i, _p, _p, _p, _p, _p,
    ],
    "sleap_crop_unit": [_p, _i, _i64, _i, _i, _i, _i, _i, _i, _i, _p, _p, _i, _i, _i, _p, _p],
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    default location; raise if none exists."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), DEFAULT_NVCC]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of sleap_tpu_torch cannot be built."
    )


def _raise_on_failure(cmd: List[str], code: int, stderr: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed with code {code}:\n{' '.join(cmd)}\n{stderr}")


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels into ``build_dir`` unless an up-to-date build is
    there; return the library's path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    lib = Path(build_dir) / f"libsleap_tpu_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(name).stem}.o") for name in SOURCES]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
        for name, obj in zip(SOURCES, objs)
    ]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in compiles
    ]
    try:
        for cmd, proc in zip(compiles, procs):
            _, stderr = proc.communicate()
            _raise_on_failure(cmd, proc.returncode, stderr)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        done = subprocess.run(link, capture_output=True, text=True)
        _raise_on_failure(link, done.returncode, done.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and bound once per process."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def entry(name: str):
    """The bound C function ``name`` of the kernel library."""
    return getattr(load_library(), name)


def launch(name: str, device_index: int, *args) -> None:
    """Call entry point ``name`` with ``args`` and the current stream of CUDA
    device ``device_index``, from that device (switched to only when it is
    not current); raise if the launch failed."""
    fn = entry(name)
    if device_index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    else:
        with torch.cuda.device(device_index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}.")
