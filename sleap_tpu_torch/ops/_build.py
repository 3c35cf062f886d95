"""Build and bind the CUDA kernels in ``sleap_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), and
loaded with ``ctypes``. The library lands in ``sleap_tpu_torch/build/`` under
a name keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. A missing ``nvcc`` or a failed build
raises: there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"
SOURCES = ("peaks.cu", "crops.cu")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default install
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C signatures of the entry points (every pointer and the stream as void*).
SIGNATURES = {
    "sleap_global_peaks": [_p, _i64, _i64, _i64, _i64, _i, _i, _i, _i, _f, _i, _p, _p, _p],
    "sleap_local_peaks": [_p, _i64, _i64, _i64, _i64, _i, _i, _i, _i, _i, _f, _i, _p, _p, _p],
    "sleap_crop_unit": [_p, _i, _i64, _i64, _i64, _i64, _i, _i, _i, _i, _p, _p, _i, _i, _i, _p, _p],
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
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
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
