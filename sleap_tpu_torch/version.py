"""Version of the PyTorch port, recorded in the provenance of the ``.slp``
files its CLI writes, and :func:`versions` of it and what it runs on."""

__version__ = "0.1.0"


def versions() -> str:
    """Print and return the versions of the port, PyTorch (with its CUDA),
    numpy, Python and the OS."""
    import platform

    import numpy as np
    import torch

    vers = {
        "sleap-tpu-torch": __version__,
        "PyTorch": torch.__version__,
        "CUDA": torch.version.cuda or "none",
        "Numpy": np.__version__,
        "Python": platform.python_version(),
        "OS": platform.platform(),
    }
    out = "\n".join(f"{k}: {v}" for k, v in vers.items())
    print(out)
    return out
