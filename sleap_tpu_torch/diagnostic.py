"""``sleap-diagnostic`` for the port: what a bug report needs to know of
the environment.

    python -m sleap_tpu_torch.diagnostic

Prints the port's version, Python and the platform, PyTorch with the CUDA
and cuDNN versions it was built with, each GPU's name, and the versions of
numpy, scipy and triton ("NOT INSTALLED" where absent). Versions are read
from the installed distributions, so nothing is imported to report it; the
JAX side (``jax``, ``flax``, ``h5py``, ``cv2``) is never imported.
"""

from __future__ import annotations

import platform
import sys
from importlib import metadata


def _version(distribution: str) -> str:
    try:
        return metadata.version(distribution)
    except metadata.PackageNotFoundError:
        return "NOT INSTALLED"


def system_summary() -> str:
    import torch

    from sleap_tpu_torch.version import __version__

    lines = [
        f"sleap-tpu-torch version: {__version__}",
        f"python: {sys.version.split()[0]} ({platform.platform()})",
        f"torch: {torch.__version__}",
        f"CUDA: {torch.version.cuda or 'none'} (available: {torch.cuda.is_available()})",
        f"cuDNN: {torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else 'none'}",
    ]
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        lines.append(f"GPUs: {len(names)}")
        lines.extend(f"  [{i}] {name}" for i, name in enumerate(names))
    else:
        lines.append("GPUs: 0")
    lines.extend(f"{name}: {_version(name)}" for name in ("numpy", "scipy", "triton"))
    return "\n".join(lines)


def main(args=None) -> None:
    print(system_summary())


if __name__ == "__main__":
    main()
