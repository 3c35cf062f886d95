"""Devices: :mod:`sleap_tpu.system` for the port, through ``torch.cuda``.

List the CUDA devices, pick one as the current device, and print a summary
of them with the CUDA and cuDNN versions. The port's entry points take
``device=`` (``"cuda"`` by default), so there is no global CPU-only switch
and no memory preallocation to turn off: PyTorch allocates on demand.
"""

from __future__ import annotations

from typing import List

import torch


def get_all_devices() -> List[torch.device]:
    """The CUDA devices, then the CPU."""
    return get_all_gpus() + [torch.device("cpu")]


def get_all_gpus() -> List[torch.device]:
    """The CUDA devices (none where CUDA is not available)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


get_all_tpus = get_all_gpus  # the JAX package's name for its accelerators


def is_accelerator_system() -> bool:
    return len(get_all_gpus()) > 0


def use_first_gpu() -> None:
    use_gpu(0)


def use_last_gpu() -> None:
    use_gpu(-1)


def use_gpu(device_ind: int) -> None:
    """Make the ``device_ind``-th CUDA device (negative counts from the last)
    the current one: where ``"cuda"`` places tensors."""
    gpus = get_all_gpus()
    if not gpus:
        raise RuntimeError("No CUDA device is available.")
    torch.cuda.set_device(gpus[device_ind])


def best_logical_device_name() -> str:
    """``"cuda:<current>"`` where CUDA is available, else ``"cpu"``."""
    if is_accelerator_system():
        return f"cuda:{torch.cuda.current_device()}"
    return "cpu"


def summary() -> None:
    """Print each CUDA device's name, memory and compute capability, and the
    CUDA and cuDNN versions PyTorch was built with."""
    gpus = get_all_gpus()
    print(f"GPUs: {len(gpus)}")
    for d in gpus:
        props = torch.cuda.get_device_properties(d)
        print(f"  [{d.index}] {props.name}: {props.total_memory / 2**30:.1f} GiB, "
              f"compute capability {props.major}.{props.minor}")
    cudnn = torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None
    print(f"CUDA: {torch.version.cuda or 'none'} (available: {torch.cuda.is_available()})")
    print(f"cuDNN: {cudnn or 'none'}")
    print(f"Current device: {best_logical_device_name()}")
