"""Float32 means float32: TF32 off for the port's float32 card paths.

PyTorch runs cuDNN's float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), a 10-bit mantissa that the
JAX reference (``jax_default_matmul_precision="highest"``) does not use.
The library's float32 entry points (the predictors' ``predict``, the
trainer's steps and ``train``, ``evals.evaluate_model``) run inside
:func:`ieee_fp32`, which turns TF32 off for cuDNN and cuBLAS and gives the
caller back its own flags on exit; the CLIs call :func:`disable_tf32` for
their whole process. bf16 work is unaffected: the flags touch float32 only.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def disable_tf32() -> None:
    """TF32 off for cuDNN convolutions and cuBLAS matmuls, process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def ieee_fp32() -> Iterator[None]:
    """TF32 off inside the scope; the caller's flags are restored on exit,
    also on an exception. Usable as a decorator."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    disable_tf32()
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
